#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card, through its kernels.

Two main paths:
  * the paper's Fig. 2 workflow: a noisy radiating source → forward FFT →
    bandpass → backward FFT → writer, built with ``build_chain`` on a
    one-device mesh with planned ``backend: "pallas"`` FFT endpoints, so
    every FFT pass runs the hand-written four-step or Stockham kernel and
    the bandpass stage runs the fused bandpass kernel;
  * LM serving: ``repro_torch.launch.serve.main`` on qwen3-4b at full
    width and depth (36 layers, float32, random weights from a seed),
    batch 4, a 2048-token prompt and 32 greedy tokens. Every prefill
    attention layer runs the hand-written flash-attention kernel; decode
    attends to the KV cache with plain PyTorch, as the reference does.

Phases, each printing one JSON line:
  1. device  — card name, power limit, TF32 switched off;
  2. build   — nvcc builds ``src/repro_torch/kernels/csrc`` (seconds),
     with ptxas's count of kernels and those that spill registers, and
     the tensor-core instructions (HGMMA, HMMA) in each flash kernel's
     SASS (cuobjdump), which must have some;
  3. kernels — each kernel against its plain PyTorch version on the
     card, with its time, the plain version's, one PyTorch call's that
     computes the same function (``torch.fft``, scaled_dot_product_
     attention: a yardstick only, the port never calls it) and the
     least time the card could take for the function (its bytes, or its
     FLOP, over the published H100 SXM peaks). The FFT kernels are held
     on both routes: rows (last axis) and columns (axis -2, no
     transposed copy), each also against ``torch.fft``; their device-only
     time from torch.profiler (``device_ms``) stands beside the CUDA-event
     time, so launch and host time show apart. The four-step kernel is
     held at every route (radix rows and columns, mixed radix in one CTA
     and in passes through a scratch buffer, Bluestein) against the
     float64 oracle too, and against its plain version only where that
     version's float32 angles hold. The flash kernel is held
     at the qwen3-4b prefill shape in float32 (three TF32 products on the
     tensor cores: bounded by them at the TF32 peak, with the CUDA cores'
     fp32 bound beside it) and bf16 (wgmma), each beside SDPA, and on a
     float32 case with large logits that one TF32 product would fail;
  4. FFT main path — the chain at 8192 x 8192 (every pass on the
     four-step kernel's radix route), 128 x 128 (every pass on the
     Stockham kernel), 200 x 200 (the quickstart's grid) and 10000 x
     10000 (mixed-radix rows and columns), in ``insitu`` and
     ``intransit`` modes, and 2048 x 32768 (32768-point rows as two
     mixed-radix passes) in ``insitu``, each held against a float64 numpy
     oracle of the same chain, with the launch counts of each run (the
     column route's apart); then device time by kernel over one step at
     8192², 10000² (which must show no copy kernel, and the mixed-radix
     kernel) and 200², with the share of copy and elementwise kernels;
  5. serve main path — ``launch/serve.main`` as above, with every kernel's
     launch count of that run (36 flash launches: one per layer of the
     one prefill); a teacher-forced check that prefill then one decode
     step gives the logits of a prefill one token longer; a continuous
     batcher at the same width (4 slots, 6 requests); device time by
     kernel over one 2048-token prefill and one decode step;
then one ``{"kernels": [...]}`` line. The last line is ``{"ok": true,
"device": {...}}``. Any failed check raises, and the script exits
non-zero. Without a CUDA device it exits non-zero before printing
anything.

Run from the repository root:  python3 chip_smoke.py
"""
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published NVIDIA H100 SXM peaks (data sheet, dense, at 700 W).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain version on the same card inputs, relative to max
# |plain|: the reference's bar, 5e-5, for powers of two
# (tests/test_kernels.py:28); 1e-4 otherwise. The plain four-step rounds
# its angles in float32 as the reference does (~2e-5 at N=8192, ~4e-5 at
# N=257, where angles reach 2*pi*256*256/257), while the kernel reduces
# exponents in integers. 1e-4 sits above that and below what a TF32
# product would give (~2e-4 at N=200).
FFT_TOL_POW2 = 5e-5
FFT_TOL_OTHER = 1e-4
# Kernel vs torch.fft (cuFFT, full fp32), relative to max |plain|: the
# kernel's own fp32 error, ~1e-6 at these N.
FFT_TOL_LIB = 1e-5
# Kernel vs the float64 oracle (torch.fft in complex128), relative to max
# |X|: the reference's bar (tests/test_kernels.py:28), at every N.
FFT_TOL_F64 = 5e-5
# Bandpass sums against a float64 sum of the same planes; planes exact.
SUM_TOL = 1e-5
# Denoised field against the float64 numpy oracle, absolute, on an O(1)
# field: float32 transforms there err by ~1e-6 rms; 1e-4 is the
# port-vs-reference bar of the CPU tests (tests/test_torch_insitu.py).
FIELD_TOL = 1e-4
ENERGY_TOL = 1e-5
KEEP_FRAC = 0.05
# Flash kernel vs its plain version: the reference's bars
# (tests/test_flash_attention.py), elementwise |k - p| <= atol + rtol*|p|.
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 3e-2)}
# Teacher-forced serve check: prefill(S) + one decode step against
# prefill(S + 1), max |difference| over max |logit|. Both run float32
# products (no TF32) over 36 layers, by different routes (flash kernel
# vs plain decode attention, other summation orders). An H100 run read
# 4.93e-6 (PERF.md); 1e-4 leaves 20x room for float32 summation order and
# sits far below what a wrong cache or position gives.
TEACHER_TOL = 1e-4
# Chain steps recorded in each chain profile (reported per step).
PROFILE_REPS = 3
# Spill stores a thread ptxas may give a mixed-radix FFT kernel: what the
# power-of-two rows of fft_common.cuh spill at their register cap.
MIXED_SPILL_MAX = 152
SERVE_ARCH = "qwen3-4b"
SERVE_BATCH = 4
SERVE_PROMPT = 2048
SERVE_TOKENS = 32
# the flash kernels' symbols (csrc/flash_attention.cu), as the profiler
# and cuobjdump name them
FLASH_KERNELS = ("flash_tf32_kernel", "flash_wgmma_kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, iters: int = 10) -> float:
    """Device-only time of one call of ``fn``: the sum of its kernels'
    device time under torch.profiler over ``iters`` calls, per call."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    _, rows = device_profile(run)
    return sum(r[1] for r in rows) / iters


def ptxas_report(log: Path) -> dict:
    """Kernels ptxas compiled (from the build's ``-Xptxas=-v`` log) and
    those among them with spill stores: registers, stack, spills."""
    import re
    kernels, spills, entry, name = 0, [], None, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernels, entry = kernels + 1, m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and int(m.group(2)):
            spills.append({"function": name, "stack": int(m.group(1)),
                           "spill_stores": int(m.group(2)),
                           "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and spills and spills[-1]["function"] == entry:
            spills[-1]["registers"] = int(m.group(1))
    return {"kernels_compiled": kernels, "spilling": spills}


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def fft_flops(n: int) -> float:
    """FLOP of one length-n FFT, the usual 5*n*log2(n) count."""
    return 5.0 * n * math.log2(n)


def plain_holds(n: int) -> bool:
    """Whether the plain four-step's float32 angles hold the 1e-4 bar at
    N: its DFT matrices form outer(k, k) in float32, which loses the
    angle for large factors (primes past ~4096, 2^16 and up)."""
    from repro_torch.kernels import fft_plan
    return n <= 1024 or (n <= 32768 and fft_plan.smooth7(n))


def oracle_err(got, re, im, inverse, dim):
    """Largest error of ``got`` against the float64 oracle (torch.fft in
    complex128, an oracle only), relative to max |X|."""
    import torch
    z = torch.complex(re.double(), im.double())
    want = torch.fft.ifft(z, dim=dim) if inverse else torch.fft.fft(z,
                                                                     dim=dim)
    scale = float(want.abs().max())
    err = max(float((got[0].double() - want.real).abs().max()),
              float((got[1].double() - want.imag).abs().max()))
    return err / scale


def check_fft(name, wrapper, plain, shape, gen):
    """One FFT kernel at one shape against its plain version (where its
    angles hold), torch.fft, and the float64 oracle."""
    import torch
    B, N = shape
    tol = FFT_TOL_OTHER if N & (N - 1) else FFT_TOL_POW2
    re = torch.randn(shape, generator=gen, device="cuda")
    im = torch.randn(shape, generator=gen, device="cuda")
    res = {"kernel": name, "shape": list(shape), "tol": tol,
           "tol_vs_torch_fft": FFT_TOL_LIB, "tol_vs_f64": FFT_TOL_F64}
    if name == "fft_fourstep":
        from repro_torch.kernels import fft_plan
        r = fft_plan.route(N, False)
        res["route"], res["lines"] = r.kind, list(r.lines or [r.m or N])
    for inverse in (False, True):
        kr, ki = wrapper(re, im, inverse=inverse)
        pr, pi = plain(re, im, inverse=inverse)
        z = torch.complex(re, im)
        lib = torch.fft.ifft(z, dim=-1) if inverse else torch.fft.fft(z,
                                                                      dim=-1)
        torch.cuda.synchronize()
        scale = float(torch.maximum(lib.real.abs().max(),
                                    lib.imag.abs().max()))
        err = float(torch.maximum((kr - pr).abs().max(),
                                  (ki - pi).abs().max()))
        lib_err = float(torch.maximum((kr - lib.real).abs().max(),
                                      (ki - lib.imag).abs().max()))
        del pr, pi, lib, z
        f64 = oracle_err((kr, ki), re, im, inverse, -1)
        tag = "inverse_" if inverse else ""
        res[tag + "max_abs_err"] = err
        res[tag + "max_rel_err"] = err / scale
        res[tag + "rel_err_vs_torch_fft"] = lib_err / scale
        res[tag + "rel_err_vs_f64"] = f64
        res["plain_held"] = plain_holds(N)
        if not ((err / scale < tol or not plain_holds(N))
                and lib_err / scale < FFT_TOL_LIB and f64 < FFT_TOL_F64):
            emit(res)
            raise AssertionError(f"{name} {shape} inverse={inverse}: "
                                 f"{err / scale:.3e} vs plain (bar {tol}), "
                                 f"{lib_err / scale:.3e} vs torch.fft, "
                                 f"{f64:.3e} vs float64")
        del kr, ki
    z = torch.complex(re, im)
    res["kernel_ms"] = time_ms(lambda: wrapper(re, im))
    res["plain_ms"] = time_ms(lambda: plain(re, im))
    res["library_ms"] = time_ms(lambda: torch.fft.fft(z, dim=-1))
    res["device_ms"] = device_ms(lambda: wrapper(re, im))
    res["library_device_ms"] = device_ms(lambda: torch.fft.fft(z, dim=-1))
    res["bound_ms"], res["bound_by"] = bound(fft_flops(N) * B, 16.0 * B * N)
    emit(res)
    return res


def check_fft_columns(name, wrapper, plain, shape, gen):
    """One FFT kernel's column route, along axis -2 of ``shape`` viewed as
    (outer, N, inner), against its plain version moved to the last axis
    and back, and against ``torch.fft.fft(z, dim=-2)``."""
    import torch
    N, inner = shape[-2:]
    outer = math.prod(shape[:-2])
    tol = FFT_TOL_OTHER if N & (N - 1) else FFT_TOL_POW2
    re = torch.randn(shape, generator=gen, device="cuda")
    im = torch.randn(shape, generator=gen, device="cuda")
    keep = (re.clone(), im.clone())
    v3 = (outer, N, inner)
    res = {"kernel": name, "route": "columns", "shape": list(shape),
           "axis": -2, "tol": tol, "tol_vs_torch_fft": FFT_TOL_LIB,
           "tol_vs_f64": FFT_TOL_F64}
    if name == "fft_fourstep":
        from repro_torch.kernels import fft_plan
        r = fft_plan.route(N, inner > 1)
        res["column_route"] = r.kind
        res["lines"] = list(r.lines or [r.m or N])

    def call(inverse=False):
        kr, ki = wrapper(re.view(v3), im.view(v3), inverse=inverse)
        return kr.view(shape), ki.view(shape)

    for inverse in (False, True):
        kr, ki = call(inverse)
        pr, pi = plain(re.movedim(-2, -1), im.movedim(-2, -1),
                       inverse=inverse)
        pr, pi = pr.movedim(-1, -2), pi.movedim(-1, -2)
        z = torch.complex(re, im)
        lib = torch.fft.ifft(z, dim=-2) if inverse else torch.fft.fft(z,
                                                                      dim=-2)
        torch.cuda.synchronize()
        scale = float(torch.maximum(lib.real.abs().max(),
                                    lib.imag.abs().max()))
        err = float(torch.maximum((kr - pr).abs().max(),
                                  (ki - pi).abs().max()))
        lib_err = float(torch.maximum((kr - lib.real).abs().max(),
                                      (ki - lib.imag).abs().max()))
        del pr, pi, lib, z
        f64 = oracle_err((kr, ki), re, im, inverse, -2)
        tag = "inverse_" if inverse else ""
        res[tag + "max_abs_err"] = err
        res[tag + "max_rel_err"] = err / scale
        res[tag + "rel_err_vs_torch_fft"] = lib_err / scale
        res[tag + "rel_err_vs_f64"] = f64
        res["plain_held"] = plain_holds(N)
        ok = ((err / scale < tol or not plain_holds(N))
              and lib_err / scale < FFT_TOL_LIB and f64 < FFT_TOL_F64
              and kr.is_contiguous())
        if not ok:
            emit(res)
            raise AssertionError(f"{name} columns {shape} inverse={inverse}: "
                                 f"{err / scale:.3e} vs plain (bar {tol}), "
                                 f"{lib_err / scale:.3e} vs torch.fft, "
                                 f"{f64:.3e} vs float64")
        del kr, ki
    if not (torch.equal(re, keep[0]) and torch.equal(im, keep[1])):
        raise AssertionError(f"{name} columns {shape}: input was written")
    z = torch.complex(re, im)
    res["kernel_ms"] = time_ms(call)
    res["library_ms"] = time_ms(lambda: torch.fft.fft(z, dim=-2))
    res["device_ms"] = device_ms(call)
    res["library_device_ms"] = device_ms(lambda: torch.fft.fft(z, dim=-2))
    B = outer * inner
    res["bound_ms"], res["bound_by"] = bound(fft_flops(N) * B, 16.0 * B * N)
    emit(res)
    return res


def check_bandpass(shape, gen, soft: bool):
    import torch
    from repro_torch.kernels.bandpass import bandpass_filter
    from repro_torch.kernels.ref import bandpass_ref
    re = torch.randn(shape, generator=gen, device="cuda")
    im = torch.randn(shape, generator=gen, device="cuda")
    u = torch.rand(shape, generator=gen, device="cuda")
    mask = u if soft else (u > 0.3).float()
    kr, ki, kept, tot = bandpass_filter(re, im, mask)
    pr, pi, pkept, ptot = bandpass_ref(re, im, mask)
    p64 = re.double() ** 2 + im.double() ** 2
    kept64, tot64 = float((p64 * mask.double()).sum()), float(p64.sum())
    torch.cuda.synchronize()
    res = {"kernel": "bandpass_filter", "shape": list(shape),
           "mask": "soft" if soft else "0/1",
           "max_abs_err": float(torch.maximum((kr - pr).abs().max(),
                                              (ki - pi).abs().max())),
           "kept_rel_err": abs(float(kept) - kept64) / kept64,
           "total_rel_err": abs(float(tot) - tot64) / tot64,
           "plain_kept_rel_err": abs(float(pkept) - kept64) / kept64}
    res["max_rel_err"] = max(res["kept_rel_err"], res["total_rel_err"])
    ok = (res["max_abs_err"] == 0.0 and res["max_rel_err"] < SUM_TOL)
    if ok:
        res["kernel_ms"] = time_ms(lambda: bandpass_filter(re, im, mask))
        res["device_ms"] = device_ms(lambda: bandpass_filter(re, im, mask))
        res["plain_ms"] = time_ms(lambda: bandpass_ref(re, im, mask))
        res["library_ms"] = None
        n = re.numel()
        res["bound_ms"], res["bound_by"] = bound(8.0 * n, 20.0 * n)
    emit(res)
    if not ok:
        raise AssertionError(f"bandpass {shape} soft={soft} disagrees")
    return res


def oracle(dims):
    """The chain in float64 numpy: fft2 → the same mask → ifft2."""
    import numpy as np
    from repro_torch.core.fft.filters import lowpass_mask
    from repro_torch.core.insitu.adaptors import radiating_field
    noisy, clean = radiating_field(dims, seed=0)
    spec = np.fft.fft2(noisy.astype(np.float64))
    power = spec.real ** 2 + spec.imag ** 2
    mask = lowpass_mask(dims, KEEP_FRAC).numpy()
    kept, total = float((power * mask).sum()), float(power.sum())
    spec *= mask
    denoised = np.fft.ifft2(spec).real
    return noisy, clean, denoised, kept, total


def run_chain(dims, mode, mesh, expected, out_dir):
    import numpy as np
    import torch
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.config import build_chain
    from repro_torch.kernels import ops
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter}
    noisy, clean, want, kept64, total64 = expected
    data = RadiatingSourceAdaptor(dims, mesh=mesh).produce(0)

    def chain_for(out):
        return build_chain({"mode": mode, "chain": [
            {"endpoint": "fft", "array": "field", "direction": "forward",
             "backend": "pallas"},
            {"endpoint": "bandpass", "array": "field",
             "keep_frac": KEEP_FRAC},
            {"endpoint": "fft", "array": "field", "direction": "backward",
             "backend": "pallas"},
            {"endpoint": "writer", "array": "field", "out_dir": str(out)},
        ]}, mesh=mesh, grid=data.grid)

    # one untimed run first, so the timed one does not pay the caching
    # allocator's first growth to this size
    chain_for(out_dir / "warmup").execute(data)
    chain = chain_for(out_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    for fn in (ops.fft_fourstep, ops.fft_stockham):
        fn.column_launches = 0
    t0 = time.perf_counter()
    out = chain.execute(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["fft_fourstep_columns"] = ops.fft_fourstep.column_launches
    launches["fft_stockham_columns"] = ops.fft_stockham.column_launches
    got = out.arrays["field"].cpu().numpy()
    field_err = float(np.abs(got - want).max())
    mse0 = float(np.mean((noisy - clean) ** 2))
    mse1 = float(np.mean((got - clean) ** 2))
    kept = float(out.arrays["insitu_kept_energy"])
    total = float(out.arrays["insitu_total_energy"])
    files = chain.finalize()["writer"]["files"]
    res = {"phase": "main_path", "dims": list(dims), "mode": mode,
           "wall_s": wall, "launches": launches,
           "field_max_abs_err": field_err, "field_tol": FIELD_TOL,
           "kept_rel_err": abs(kept - kept64) / kept64,
           "total_rel_err": abs(total - total64) / total64,
           "mse0": mse0, "mse1": mse1, "mse1_over_mse0": mse1 / mse0,
           "report": chain.marshaling_report(),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "files_written": len(files)}
    emit(res)
    assert np.isfinite(got).all() and got.shape == tuple(dims)
    assert field_err < FIELD_TOL, f"{dims} {mode}: field err {field_err}"
    assert res["kept_rel_err"] < ENERGY_TOL, res["kept_rel_err"]
    assert res["total_rel_err"] < ENERGY_TOL, res["total_rel_err"]
    assert len(files) == 1
    return res


def device_profile(fn, reps: int = 1):
    """Run ``fn`` under torch.profiler, once as the profiler's warm-up step
    and ``reps`` times recorded; return the recorded runs' wall ms and
    device time by kernel as (name, ms, launches), per run, largest
    first. The trace can drop the kernels launched just after a recorded
    step starts, so that step opens with a spin kernel of about a
    millisecond (torch.cuda._sleep), waited for and left out of the rows;
    where a few still go missing, launch counts that are not whole
    multiples of ``reps`` show it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        prof.step()
    # the schedule's step marker is a range, not a kernel
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / reps,
                    e.count / reps)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")
                   and "spin_kernel" not in e.key),
                  key=lambda r: -r[1])
    return wall_ms, rows


def profile_chain(dims, mesh, out_dir):
    """Device time by kernel of one in-situ run of the chain (the mean of
    PROFILE_REPS recorded runs), from torch.profiler, and the device's
    idle share of the run's wall time."""
    import torch
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.config import build_chain
    data = RadiatingSourceAdaptor(dims, mesh=mesh).produce(0)
    chain = build_chain({"mode": "insitu", "chain": [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "backend": "pallas"},
        {"endpoint": "bandpass", "array": "field", "keep_frac": KEEP_FRAC},
        {"endpoint": "fft", "array": "field", "direction": "backward",
         "backend": "pallas"},
    ]}, mesh=mesh, grid=data.grid)
    chain.execute(data)
    torch.cuda.synchronize()
    wall_ms, rows = device_profile(lambda: chain.execute(data),
                                   reps=PROFILE_REPS)
    busy = sum(r[1] for r in rows)
    # PyTorch's copy and elementwise kernels (a transposing copy is one)
    copies = [(n, t, c) for n, t, c in rows
              if any(w in n.lower() for w in ("copy", "elementwise"))]
    copy_ms = sum(t for _, t, _ in copies)
    res = {"phase": "profile", "dims": list(dims), "mode": "insitu",
           "stages": "fft -> bandpass -> fft (no writer)",
           "steps_recorded": PROFILE_REPS,
           "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms if wall_ms else None,
           "kernel_launches": sum(c for _, _, c in rows),
           "copy_elementwise_ms": copy_ms,
           "copy_elementwise_share": copy_ms / busy if busy else None,
           "copy_elementwise_kernels": [{"name": n[:80], "ms": t, "count": c}
                                        for n, t, c in copies],
           "by_kernel_ms": [{"name": n[:80], "ms": t, "count": c}
                            for n, t, c in rows]}
    emit(res)
    return res


def check_flash(shape, dtype, causal, cap, gen, mul=1.0):
    """The flash kernel at one shape against its plain version; SDPA as
    the library yardstick where it computes the same function (no
    softcap). ``mul`` scales q (larger logits). float32 runs as three
    TF32 products on the tensor cores: its bound is those products at
    the TF32 peak, with the CUDA cores' fp32 bound beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    B, S, H, KV, hd = shape
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda")
               for n in (H, KV, KV))
    q, k, v = (q * mul).to(dtype), k.to(dtype), v.to(dtype)
    got = flash_attention(q, k, v, causal=causal, softcap=cap)
    want = flash_attention_ref(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL[str(dtype).split(".")[-1]]
    diff = (got.float() - want.float()).abs()
    res = {"kernel": "flash_attention", "shape": list(shape),
           "dtype": str(dtype).split(".")[-1], "causal": causal,
           "softcap": cap, "q_scale": mul, "atol": atol, "rtol": rtol,
           "max_abs_err": float(diff.max()),
           "max_excess": float((diff - rtol * want.float().abs()).max())}
    del want, diff
    ok = res["max_excess"] <= atol and got.dtype == dtype
    if ok:
        def call():
            return flash_attention(q, k, v, causal=causal, softcap=cap)
        res["kernel_ms"] = time_ms(call)
        res["device_ms"] = device_ms(call)
        res["plain_ms"] = time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, softcap=cap))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        res["library_ms"] = (time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
            if cap == 0.0 else None)
        pairs = S * (S + 1) / 2 if causal else S * S
        flops = 4.0 * B * H * hd * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        if dtype == torch.float32:
            res["bound_ms"], res["bound_by"] = bound(3 * flops, nbytes,
                                                     PEAK_TF32_FLOPS)
            res["bound_note"] = "3 TF32 products at the TF32 tensor peak"
            res["cuda_core_bound_ms"] = bound(flops, nbytes)[0]
        else:
            res["bound_ms"], res["bound_by"] = bound(flops, nbytes,
                                                     PEAK_BF16_FLOPS)
        res["tflops"] = flops / res["kernel_ms"] * 1e-9
    emit(res)
    if not ok:
        raise AssertionError(f"flash_attention {shape} {dtype}: "
                             f"{res['max_excess']} over rtol (bar {atol})")
    return res


def sass_report(lib: Path) -> "dict | None":
    """Tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync) in each
    flash kernel's SASS, from cuobjdump; None where there is none."""
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "flash_" in m.group(1) else None
            if fn:
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            continue
        if fn:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
    return counts


def profile_serve(cfg, params, tokens):
    """Device time by kernel over one prefill and over one decode step
    after it, from torch.profiler, and the device's idle share of each
    one's wall time."""
    import torch
    from repro_torch.models import lm
    B, S = tokens.shape
    state = None

    def prefill():
        nonlocal state
        _, state = lm.prefill(cfg, params, {"tokens": tokens},
                              cache_len=S + 2)

    def decode():
        lm.decode_step(cfg, params, tokens[:, -1:], dict(state, pos=S + 1))

    for name, fn in (("prefill", prefill), ("decode_step", decode)):
        if name == "decode_step":
            lm.decode_step(cfg, params, tokens[:, -1:], state)  # warm-up
            torch.cuda.synchronize()
        wall_ms, rows = device_profile(fn)
        busy = sum(r[1] for r in rows)

        def share(pred):
            return sum(t for n, t, _ in rows if pred(n.lower()))

        flash = share(lambda n: any(k in n for k in FLASH_KERNELS))
        gemm = share(lambda n: "gemm" in n or "cutlass" in n
                     or "xmma" in n)
        emit({"phase": f"profile_{name}", "arch": cfg.name,
              "tokens": [B, S if name == "prefill" else 1],
              "wall_ms": wall_ms, "device_busy_ms": busy,
              "device_idle_share": 1.0 - busy / wall_ms,
              "kernel_launches": sum(c for _, _, c in rows),
              "flash_attention_ms": flash, "matmul_ms": gemm,
              "other_ms": busy - flash - gemm,
              "by_kernel_ms": [{"name": n[:80], "ms": t, "count": c}
                               for n, t, c in rows[:10]]})


def serve_path(counters):
    """The serving main path at full qwen3-4b width and depth; returns
    its flash launch count."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import ContinuousBatcher, Request
    cfg = registry.get_config(SERVE_ARCH)
    flash = counters["flash_attention"]

    # the serving entry point, as a user runs it, on seeded parameters
    # made on the card; the checks below reuse them
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.float32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    report = serve.main(["--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH),
                         "--prompt-len", str(SERVE_PROMPT), "--tokens",
                         str(SERVE_TOKENS), "--seed", "0", "--bench-out",
                         ""], params=params)
    launches = {k: fn.launches for k, fn in counters.items()}
    res = {"phase": "serve", "arch": SERVE_ARCH, "dtype": "float32",
           "layers": cfg.num_layers, "batch": SERVE_BATCH,
           "prompt_len": SERVE_PROMPT, "tokens": SERVE_TOKENS,
           "prefill_ms": report["prefill_ms"],
           "decode_ms_per_token": report["decode_ms_per_token"],
           "tokens_per_s": report["tokens_per_s"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "flash_launches_per_prefill": launches["flash_attention"],
           "param_init_seconds": init_s,
           "seconds": time.perf_counter() - t0}
    emit(res)
    assert launches["flash_attention"] == cfg.num_layers, launches
    assert report["tokens_per_s"] > 0

    # teacher-forced: prefill(S) then decode token S == prefill(S + 1)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size,
                           (SERVE_BATCH, SERVE_PROMPT + 1), generator=gen,
                           device="cuda")
    flash.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, state = lm.prefill(cfg, params, {"tokens": tokens[:, :-1]},
                          cache_len=SERVE_PROMPT + 1)
    torch.cuda.synchronize()
    warm_prefill_ms = (time.perf_counter() - t1) * 1e3
    after_prefill = flash.launches
    step, _ = lm.decode_step(cfg, params, tokens[:, -1:], state)
    del state
    after_decode = flash.launches
    full, _ = lm.prefill(cfg, params, {"tokens": tokens})
    rel = float((step - full).abs().max() / full.abs().max())
    res = {"phase": "serve_teacher_forced", "arch": SERVE_ARCH,
           "prefill_then_decode_vs_longer_prefill_rel_err": rel,
           "tol": TEACHER_TOL, "logits_shape": list(full.shape),
           "warm_prefill_ms": warm_prefill_ms,
           "flash_launches_prefill_2048": after_prefill,
           "flash_launches_decode": after_decode - after_prefill,
           "flash_launches_prefill_2049": flash.launches - after_decode,
           "seconds": time.perf_counter() - t0}
    emit(res)
    assert full.shape == (SERVE_BATCH, 1, cfg.vocab_size)
    assert bool(torch.isfinite(step).all() and torch.isfinite(full).all())
    assert after_prefill == cfg.num_layers == after_decode
    assert flash.launches - after_decode == cfg.num_layers
    assert rel < TEACHER_TOL, rel
    del step, full

    # continuous batching at the same width
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    eng = ContinuousBatcher(cfg, params, slots=4, cache_len=64)
    for i in range(6):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(4, 17))).astype(np.int32),
            max_new=8))
    finished = eng.run()
    torch.cuda.synchronize()
    res = {"phase": "serve_engine", "arch": SERVE_ARCH, "slots": 4,
           "requests": 6, "finished": len(finished),
           "new_tokens": sorted(len(r.out) for r in finished.values()),
           "ticks": eng.ticks, "seconds": time.perf_counter() - t0}
    emit(res)
    assert len(finished) == 6
    assert all(len(r.out) == 8 and r.done for r in finished.values())
    del eng

    t0 = time.perf_counter()
    profile_serve(cfg, params, tokens[:, :-1])
    emit({"phase": "profile_serve_seconds",
          "seconds": time.perf_counter() - t0})
    return launches["flash_attention"]


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft import dft
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft_fourstep import (fft_fourstep,
                                                  fft_fourstep_columns)
    from repro_torch.kernels.fft_stockham import (fft_stockham,
                                                  fft_stockham_columns)
    from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    report = ptxas_report(lib.with_suffix(".log"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)), **report})
    # the mixed-radix kernels spill no more than the power-of-two rows do
    mixed = [k for k in report["spilling"] if "mixed_" in k["function"]]
    assert all(k["spill_stores"] <= MIXED_SPILL_MAX for k in mixed), mixed
    sass = sass_report(lib)
    emit({"phase": "flash_sass", "tensor_instructions": sass})
    if sass is not None:   # one kernel per dtype and head dim
        assert sorted(k for f in sass for k in FLASH_KERNELS if k in f) == \
            sorted(FLASH_KERNELS * len(HEAD_DIMS)), sass
        assert all(c["HGMMA"] + c["HMMA"] > 0 for c in sass.values()), sass

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)

    # rows: powers of two on the radix route ((64, 16384) is the longest
    # row it holds in one CTA); 200, 360, 10000 on mixed radix, one CTA a
    # row; 20000 and the long powers of two (32768 to 2^20) on mixed-radix
    # passes through a scratch buffer; 257, 4097 = 17*241 and 10007 on
    # Bluestein
    fourstep = [check_fft("fft_fourstep", fft_fourstep, dft.fourstep_fft,
                          s, gen)
                for s in ((8192, 8192), (64, 200), (64, 360), (64, 257),
                          (200, 200), (10000, 10000), (64, 16384),
                          (64, 20000), (64, 32768), (8, 65536),
                          (4, 1 << 20), (8, 10007), (16, 4097))]
    stockham = [check_fft("fft_stockham", fft_stockham, dft.stockham_fft,
                          s, gen)
                for s in ((128, 128), (8192, 128), (256, 64))]
    # columns, axis -2, no transposed copy: 8192 points in two radix
    # passes through a scratch buffer; 200 in one mixed-radix pass, 10000
    # in two (100 x 100); 257 on Bluestein
    fourstep_cols = [check_fft_columns("fft_fourstep", fft_fourstep_columns,
                                       dft.fourstep_fft, s, gen)
                     for s in ((8192, 8192), (8192, 128), (3, 257, 100),
                               (200, 200), (10000, 10000))]
    stockham_cols = [check_fft_columns("fft_stockham", fft_stockham_columns,
                                       dft.stockham_fft, (128, 128), gen)]
    bandpass = [check_bandpass((8192, 8192), gen, soft)
                for soft in (False, True)]
    t0 = time.perf_counter()
    # the qwen3-4b prefill shape first: its row goes in the kernels line;
    # then the same shape in bf16 (its row's bf16 keys)
    flash = [check_flash(shape, dtype, causal, cap, gen, mul)
             for shape, dtype, causal, cap, mul in (
                 ((SERVE_BATCH, SERVE_PROMPT, 32, 8, 128), torch.float32,
                  True, 0.0, 1.0),
                 ((SERVE_BATCH, SERVE_PROMPT, 32, 8, 128), torch.bfloat16,
                  True, 0.0, 1.0),
                 ((1, 256, 4, 2, 64), torch.float32, False, 30.0, 1.0),
                 ((1, 1024, 16, 8, 128), torch.bfloat16, True, 0.0, 1.0),
                 ((2, 300, 32, 8, 128), torch.float32, True, 0.0, 1.0),
                 # logits at std 4: one TF32 product would miss the bar
                 ((1, 512, 4, 2, 128), torch.float32, True, 0.0, 4.0))]
    emit({"phase": "flash_checks_seconds",
          "seconds": time.perf_counter() - t0})

    # 4. main path
    mesh = make_mesh((1,), ("data",))
    assert mesh.device.type == "cuda"
    out_dir = ROOT / "build" / "chip_smoke"
    # launches summed over the modes of each size's main-path runs. The
    # sizes: 8192^2 (powers of two on the four-step kernel), 128^2 (all on
    # Stockham), 200^2 (the quickstart's grid: mixed radix rows and
    # columns), 10000^2 (a 7-smooth grid, 400 MB a plane: mixed-radix rows
    # in one CTA, columns as 100 x 100 in two passes) and 2048 x 32768 (a
    # long periodic strip, 256 MiB a plane: 32768-point rows as two
    # mixed-radix passes; insitu only, for the time budget)
    four = ("fft_fourstep", "fft_fourstep_columns", "bandpass_filter")
    both = ("insitu", "intransit")
    sizes = (((8192, 8192), both, four),
             ((128, 128), both, ("fft_stockham", "fft_stockham_columns",
                                 "bandpass_filter")),
             ((200, 200), both, four),
             ((10000, 10000), both, four),
             ((2048, 32768), ("insitu",), four))
    launches = {}
    profiles = {}
    try:
        for dims, modes, must_run in sizes:
            expected = oracle(dims)
            launches[dims] = dict.fromkeys(
                ("fft_fourstep", "fft_stockham", "bandpass_filter",
                 "fft_fourstep_columns", "fft_stockham_columns"), 0)
            for mode in modes:
                res = run_chain(dims, mode, mesh, expected, out_dir)
                for k in must_run:
                    assert res["launches"][k] > 0, (dims, mode, k)
                for k, v in res["launches"].items():
                    launches[dims][k] += v
                if dims in ((8192, 8192), (10000, 10000)):
                    assert res["mse1"] < 0.5 * res["mse0"], res
            del expected
            shutil.rmtree(out_dir, ignore_errors=True)
        for dims in ((8192, 8192), (10000, 10000), (200, 200)):
            profiles[dims] = profile_chain(dims, mesh, out_dir)
        # the 10000^2 step: no copy kernel, and the mixed-radix kernel
        names = [k["name"] for k in profiles[(10000, 10000)]["by_kernel_ms"]]
        assert not [n for n in names if "copy" in n.lower()], names
        assert any("mixed_lines_kernel" in n for n in names), names
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # 5. serve main path
    flash_launches = serve_path({"fft_fourstep": ops.fft_fourstep,
                                 "fft_stockham": ops.fft_stockham,
                                 "bandpass_filter": ops.bandpass_filter,
                                 "flash_attention": flash_attention})

    def row(name, source, replaces, main, cols=None):
        dims = tuple(main["shape"])
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[dims][name],
               "launches_from": f"{dims[0]}x{dims[1]} main path, insitu + "
                                f"intransit",
               "shape": main["shape"],
               "max_abs_err": main["max_abs_err"],
               "max_rel_err": main["max_rel_err"],
               "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
               "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
               "library_ms": main["library_ms"]}
        if cols is not None:
            out.update({
                "column_launches": launches[dims][name + "_columns"],
                "column_ms": cols["kernel_ms"],
                "column_library_ms": cols["library_ms"],
                "column_max_abs_err": cols["max_abs_err"],
                "device_ms": main["device_ms"],
                "library_device_ms": main["library_device_ms"],
                "column_device_ms": cols["device_ms"],
                "column_library_device_ms": cols["library_device_ms"]})
        return out

    # the four-step kernel's routes at every shape checked above, for its
    # row of the kernels line
    fourstep_routes = [
        {"shape": r["shape"], "axis": r.get("axis", -1),
         "route": r.get("route", r.get("column_route")),
         "lines": r["lines"], "device_ms": r["device_ms"],
         "library_device_ms": r["library_device_ms"],
         "bound_ms": r["bound_ms"],
         "max_rel_err_vs_f64": max(r["rel_err_vs_f64"],
                                   r["inverse_rel_err_vs_f64"])}
        for r in fourstep + fourstep_cols]
    csrc = "src/repro_torch/kernels/csrc/"
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        dict(row("fft_fourstep", csrc + "fft_fourstep.cu",
                 "src/repro/kernels/fft_fourstep.py:89", fourstep[0],
                 fourstep_cols[0]),
             routes=fourstep_routes,
             chain_launches={f"{d[0]}x{d[1]}": launches[d]["fft_fourstep"]
                             for d in launches}),
        row("fft_stockham", csrc + "fft_stockham.cu",
            "src/repro/kernels/fft_stockham.py:64", stockham[0],
            stockham_cols[0]),
        dict(row("bandpass_filter", csrc + "bandpass.cu",
                 "src/repro/kernels/bandpass.py:53", bandpass[0]),
             device_ms=bandpass[0]["device_ms"]),
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:95",
         "launches": flash_launches,
         "launches_from": f"{SERVE_ARCH} serve main path (one "
                          f"{SERVE_PROMPT}-token prefill, {SERVE_TOKENS} "
                          f"decode steps)",
         "shape": flash[0]["shape"], "dtype": flash[0]["dtype"],
         "max_abs_err": flash[0]["max_abs_err"],
         "ms": flash[0]["kernel_ms"], "plain_ms": flash[0]["plain_ms"],
         "bound_ms": flash[0]["bound_ms"], "bound_by": flash[0]["bound_by"],
         "bound_note": flash[0]["bound_note"],
         "cuda_core_bound_ms": flash[0]["cuda_core_bound_ms"],
         "library_ms": flash[0]["library_ms"],
         "device_ms": flash[0]["device_ms"],
         "bf16_ms": flash[1]["kernel_ms"],
         "bf16_device_ms": flash[1]["device_ms"],
         "bf16_max_abs_err": flash[1]["max_abs_err"],
         "bf16_bound_ms": flash[1]["bound_ms"],
         "bf16_library_ms": flash[1]["library_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
