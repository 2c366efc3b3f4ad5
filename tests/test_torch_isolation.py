"""The port stands alone: importing it loads neither JAX nor the
reference package, and no source of it imports them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

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
    # FFT serving engine and the host mesh are among those imported above
    assert {"repro_torch.core.fft.rfft", "repro_torch.core.fft.wire",
            "repro_torch.core.fft.wisdom", "repro_torch.core.fft.spectrum",
            "repro_torch.core.insitu.endpoints.stats",
            "repro_torch.core.insitu.endpoints.spectral_monitor",
            "repro_torch.core.insitu.pipeline",
            "repro_torch.serve.fft_engine",
            "repro_torch.launch.mesh"} <= set(_modules())
