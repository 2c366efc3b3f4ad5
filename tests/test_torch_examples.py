"""The port's examples against the reference's on the CPU, on the same
numpy inputs: ``examples/quickstart_torch.py`` (the Fig. 2 chain's dump
and energies against the reference example's), the batched real chain
of ``insitu_rfft_batched_torch.py`` (each denoised field within 1e-4 abs
of the reference chain's), ``serve_bandpass_monitor_torch.py`` on the
reduced h2o-danube-1.8b (the reference's parameters carried across by
``models/convert.py``: the tokens equal, each probe's statistics within
1e-4 rel, the rolling cache wrapped) and ``distributed_fft_3d_torch.py``
at 64³ (one rank in process against the reference on four host devices
at (2, 2), within 1e-4 rel; four gloo CPU ranks through the launcher's
passthrough). Each entry point refuses to fall back to the CPU without
``--device cpu``."""
import importlib.util
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
LAUNCHER = str(ROOT / "tools" / "launch_multihost_torch.py")
TOL = 1e-4


def _load(rel: str):
    """An example file of the repo as a module (``main`` not run)."""
    name = Path(rel).stem
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def _energies(stdout: str):
    m = re.search(r"kept energy\s*:\s*(\S+) / (\S+)", stdout)
    return float(m.group(1)), float(m.group(2))


def test_quickstart_matches_the_reference_example(tmp_path, capsys,
                                                  monkeypatch):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart.py")],
        env=_env(QUICKSTART_OUT=str(ref_dir)), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    monkeypatch.setenv("QUICKSTART_OUT", str(port_dir))
    out = _load("examples/quickstart_torch.py").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "x better" in printed
    assert out["mse1"] < 0.5 * out["mse0"] and out["n_images"] >= 4
    got = np.load(port_dir / "field_000000.npy")
    want = np.load(ref_dir / "field_000000.npy")
    assert got.shape == want.shape == (200, 200)
    assert float(np.max(np.abs(got - want))) < TOL
    for g, w in zip(_energies(printed), _energies(res.stdout)):
        assert abs(g - w) <= 1e-5 * abs(w), (g, w)
    pgm = {p.name for p in port_dir.glob("*.pgm")}
    assert pgm == {p.name for p in ref_dir.glob("*.pgm")}
    assert pgm == {f"{s}_000000.pgm" for s in (
        "a_noisy", "b_spectrum", "c_filtered", "d_denoised")}


def test_quickstart_without_a_card_names_the_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = _load("examples/quickstart_torch.py")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main([])


# ---------------------------------------------------------------------------
# insitu_rfft_batched
# ---------------------------------------------------------------------------

def test_batched_real_chain_matches_the_reference_chain():
    from repro.compat import make_mesh as jmake_mesh
    from repro.core.insitu.bridge import BridgeData as JBridgeData
    from repro.core.insitu.bridge import GridMeta as JGridMeta
    from repro.core.insitu.config import build_chain as jbuild_chain
    from repro_torch.compat import make_mesh

    mod = _load("examples/insitu_rfft_batched_torch.py")
    clean, fields = mod.make_fields(4, 128)
    # the reference example's own fields (seed 0)
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    want_clean = np.stack([np.sin(2 * np.pi * k * (xx + 2 * yy) / 128) / k
                           for k in (2, 3, 4, 5)]).astype(np.float32)
    np.testing.assert_array_equal(clean, want_clean)
    np.testing.assert_array_equal(fields, want_clean + 0.5 * rng.standard_normal(
        (4, 128, 128)).astype(np.float32))

    grid = JGridMeta((128, 128))
    chain = jbuild_chain(mod.chain_config(), mesh=jmake_mesh((1,), ("data",)),
                         grid=grid)
    want = np.asarray(chain.execute(JBridgeData(
        arrays={"field": jnp.asarray(fields)}, grid=grid)).arrays["field"])
    got, _ = mod.denoise(fields, make_mesh((1,), ("data",), device="cpu"))
    got = got.numpy()
    assert got.shape == want.shape == (4, 128, 128)
    for b in range(4):
        assert float(np.max(np.abs(got[b] - want[b]))) < TOL, b
        assert np.mean((got[b] - clean[b]) ** 2) < \
            np.mean((fields[b] - clean[b]) ** 2)


def test_batched_real_chain_example_runs_on_the_cpu(capsys):
    out = _load("examples/insitu_rfft_batched_torch.py").main(
        ["--device", "cpu", "--batch", "2", "--n", "64"])
    assert out["mesh"] == {"data": 1}
    assert all(a < b for a, b in zip(out["mse1"], out["mse0"]))
    printed = capsys.readouterr().out
    assert "plan cache:" in printed and printed.rstrip().endswith("OK")


# ---------------------------------------------------------------------------
# serve_bandpass_monitor
# ---------------------------------------------------------------------------

def _reference_monitor(jcfg, jparams, prompt, T):
    """examples/serve_bandpass_monitor.py's loop on the given prompt:
    the tokens, each probe's stats and high-frequency fraction."""
    from repro.core.insitu.bridge import BridgeData as JBridgeData
    from repro.core.insitu.bridge import GridMeta as JGridMeta
    from repro.core.insitu.config import build_chain as jbuild_chain
    from repro.models import lm as jlm
    B = prompt.shape[0]
    logits, state = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)},
                                cache_len=jcfg.window)
    chain = jbuild_chain({
        "mode": "intransit",
        "chain": [
            {"endpoint": "stats", "array": "field"},
            {"endpoint": "fft", "array": "field", "direction": "forward",
             "local": True},
            {"endpoint": "bandpass", "array": "field", "keep_frac": 0.25},
        ],
    }, mesh=None, grid=JGridMeta((B, jcfg.vocab_size)))
    decode = jax.jit(lambda p, t, s: jlm.decode_step(jcfg, p, t, s))
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    tokens, stats, hf = [], [], []
    for t in range(T):
        logits, state = decode(jparams, tok, state)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok))
        if t % 8 == 0:
            out = chain.execute(JBridgeData(arrays={"field": logits[:, 0, :]},
                                            step=t))
            kept = float(out.arrays["insitu_kept_energy"])
            tot = float(out.arrays["insitu_total_energy"])
            stats.append(np.asarray(out.arrays["insitu_stats"]))
            hf.append(1 - kept / tot)
    window = jax.tree.leaves(state["caches"])[0].shape[2]
    return np.concatenate(tokens, 1), stats, hf, window


def test_serve_monitor_matches_the_reference_on_the_rolling_cache():
    from repro.configs import registry as jregistry
    from repro.models import lm as jlm
    from repro_torch.configs import registry
    from repro_torch.models.convert import params_from_jax

    mod = _load("examples/serve_bandpass_monitor_torch.py")
    jcfg = jregistry.get_reduced(mod.ARCH)
    cfg = registry.get_reduced(mod.ARCH)
    B, S, T = 4, 24, 40
    assert S + T > cfg.window          # the rolling cache wraps
    key = jax.random.PRNGKey(0)
    jparams = jlm.init_params(jcfg, key, jnp.float32)
    prompt = np.asarray(jax.random.randint(key, (B, S), 0, jcfg.vocab_size))
    want = _reference_monitor(jcfg, jparams, prompt, T)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    got = mod.monitor(cfg, params, prompt.copy(), T, "cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), want[0])
    assert len(got["stats"]) == len(want[1]) == 5
    for g, w in zip(got["stats"], want[1]):
        for i in (2, 3):                # mean, std
            assert abs(g[i] - float(w[i])) <= TOL * abs(float(w[i])), (g, w)
    for g, w in zip(got["hf_frac"], want[2]):
        assert abs(g - w) <= TOL * abs(w), (g, w)
    assert got["cache_window"] == want[3] == cfg.window


def test_serve_monitor_example_runs_and_refuses_without_the_flag(capsys):
    mod = _load("examples/serve_bandpass_monitor_torch.py")
    out = mod.main(["--device", "cpu", "--tokens", "9"])
    assert len(out["hf_frac"]) == 2 and out["tokens"].shape == (4, 9)
    assert all(0.0 <= f <= 1.0 for f in out["hf_frac"])
    assert capsys.readouterr().out.rstrip().endswith("OK")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            mod.main([])


# ---------------------------------------------------------------------------
# distributed_fft_3d
# ---------------------------------------------------------------------------

REF_3D = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax.numpy as jnp
    from repro.compat import make_mesh
    from repro.core.fft import rfft
    from repro.core.fft.distributed import fourstep_freq_of_position
    from repro.core.fft.filters import apply_filter, radial_lowpass_mask
    from repro.core.fft.plan import BACKWARD, FORWARD, plan_dft, plan_rfft
    from repro.core.fft.spectrum import radial_spectrum
    from repro.core.fft.distributed import cyclic_order
    field = np.load(sys.argv[1])
    N = field.shape
    mesh = make_mesh((2, 2), ("data", "model"))
    fwd = plan_dft(N, FORWARD, mesh, decomp="pencil")
    inv = plan_dft(N, BACKWARD, mesh, decomp="pencil")
    fr, fi = fwd.execute(*fwd.place(field))
    k, e = radial_spectrum(np.asarray(fr), np.asarray(fi), nbins=24)
    fr2, fi2 = apply_filter(fr, fi, jnp.asarray(radial_lowpass_mask(N, 0.15)))
    smooth = np.asarray(inv.execute(fr2, fi2)[0])
    rfwd = plan_rfft(N, FORWARD, mesh, decomp="pencil")
    hr, hi = rfwd.execute(*rfwd.place(field))
    h = rfft.half_bins(N[2])
    half = np.asarray(hr)[..., :h] + 1j * np.asarray(hi)[..., :h]
    P0 = mesh.shape["data"]
    tf = plan_dft(N, FORWARD, mesh, decomp="pencil_tf")
    tr, ti = tf.execute(*tf.place(field[cyclic_order(N[0], P0)]))
    np.savez(sys.argv[2], k=np.asarray(k), e_k=np.asarray(e), smooth=smooth,
             half=half, pencil_tf=np.asarray(tr) + 1j * np.asarray(ti),
             perm=np.asarray(fourstep_freq_of_position(N[0], P0)))
""")


def _natural(out, perm):
    """A pencil_tf output in natural frequency order along axis 0."""
    nat = np.empty_like(out)
    nat[np.asarray(perm)] = out
    return nat


def test_distributed_fft_3d_on_one_rank_matches_the_reference(tmp_path):
    from repro_torch.compat import make_mesh
    mod = _load("examples/distributed_fft_3d_torch.py")
    field = mod.make_field(64)
    np.save(tmp_path / "field.npy", field)
    res = subprocess.run(
        [sys.executable, "-c", REF_3D, str(tmp_path / "field.npy"),
         str(tmp_path / "ref.npz")], env=_env(), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = mod.run(make_mesh((1, 1), ("data", "model"), device="cpu"), 64,
                  field, verbose=False)
    with np.load(tmp_path / "ref.npz") as ref:
        ref = dict(ref)
    assert ref["perm"].tolist() != list(range(64))     # P0 = 2 permutes
    np.testing.assert_allclose(got["k"], ref["k"], rtol=1e-6)
    np.testing.assert_allclose(got["e_k"], ref["e_k"], rtol=TOL)
    assert _rel(got["smooth"], ref["smooth"]) < TOL
    assert _rel(got["half"], ref["half"]) < TOL
    assert _rel(_natural(got["pencil_tf"], got["perm"]),
                _natural(ref["pencil_tf"], ref["perm"])) < TOL
    for key in ("roundtrip_err", "r2c_err", "r2c_roundtrip_err",
                "pencil_tf_err", "pencil_tf_roundtrip_err"):
        assert got[key] < 1e-3, (key, got[key])


def test_distributed_fft_3d_on_four_ranks_through_the_launcher():
    res = subprocess.run(
        [sys.executable, LAUNCHER, "--nprocs", "4", "--device", "cpu",
         "--timeout", "240", "--", sys.executable,
         str(ROOT / "examples" / "distributed_fft_3d_torch.py"),
         "--n", "64", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    out = res.stdout
    assert "[p0] mesh {'data': 2, 'model': 2}, grid (64, 64, 64)" in out
    assert "[p0] OK" in out and "4 process(es)" in out
    assert "[p0] transpose-free pencil vs permuted fftn" in out
    stats = [line for line in out.splitlines()
             if line.startswith("[p0] plan cache:")]
    assert len(stats) == 1 and "'hits': 1" in stats[0]

