"""The port stands alone: importing it loads neither JAX nor the
reference package, and no source of it imports them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]


def test_port_sources_import_neither_jax_nor_reference():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders
    assert len(list(_modules())) >= 19
    # the planner's modules, the analysis endpoints, the pipeline, the
    # FFT serving engine and the meshes are among those imported above
    assert {"repro_torch.core.fft.rfft", "repro_torch.core.fft.wire",
            "repro_torch.core.fft.wisdom", "repro_torch.core.fft.spectrum",
            "repro_torch.core.insitu.endpoints.stats",
            "repro_torch.core.insitu.endpoints.spectral_monitor",
            "repro_torch.core.insitu.pipeline",
            "repro_torch.serve.fft_engine",
            "repro_torch.launch.mesh",
            # the cluster bring-up and the M→N transit path
            "repro_torch.runtime.cluster",
            "repro_torch.core.insitu.transit",
            # the spectral solvers, checkpoints and their entry point
            "repro_torch.tree_util", "repro_torch.ckpt",
            "repro_torch.ckpt.checkpoint", "repro_torch.core.solver",
            "repro_torch.core.solver.spectral",
            "repro_torch.core.solver.stepper",
            "repro_torch.core.solver.base", "repro_torch.core.solver.ns2d",
            "repro_torch.core.solver.bq3d",
            "repro_torch.launch.solver",
            # fault tolerance and the elastic consumer mesh
            "repro_torch.runtime.fault",
            "repro_torch.runtime.elastic",
            # the model families past the dense decoders
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.encdec",
            "repro_torch.configs.grok1_314b",
            "repro_torch.configs.zamba2_2_7b",
            "repro_torch.configs.whisper_medium"} <= set(_modules())


# the entry points outside the package: each imported as a module (its
# ``main`` not run) loads neither JAX nor the reference package
ENTRY_POINTS = ["examples/quickstart_torch.py",
                "examples/insitu_rfft_batched_torch.py",
                "examples/serve_bandpass_monitor_torch.py",
                "examples/distributed_fft_3d_torch.py",
                "tools/wisdom_warmup_torch.py",
                "tools/launch_multihost_torch.py"]


@pytest.mark.parametrize("rel", ENTRY_POINTS)
def test_entry_points_load_no_jax_and_no_reference(rel):
    path = str(ROOT / rel)
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "assert callable(mod.main)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
