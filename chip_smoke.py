#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card, through its kernels.

Four main paths (and the real, r2c/c2r, variants of the first two):
  * the paper's Fig. 2 workflow: a noisy radiating source → forward FFT →
    bandpass → backward FFT → writer, built with ``build_chain`` on a
    one-device mesh with planned ``backend: "pallas"`` FFT endpoints, so
    every FFT pass runs the hand-written four-step or Stockham kernel and
    the bandpass stage runs the fused bandpass kernel;
  * the distributed stage-schedule path (``plan_dft`` over a mesh): every
    decomposition on a one-rank mesh at full size, then four ranks
    sharing the card (gloo collectives, this script started once per
    rank with ``--rank``);
  * LM serving: ``repro_torch.launch.serve.main`` on qwen3-4b at full
    width and depth (36 layers, float32, random weights from a seed),
    batch 4, a 2048-token prompt and 32 greedy tokens. Every prefill
    attention layer runs the hand-written flash-attention kernel; decode
    attends to the KV cache with plain PyTorch, as the reference does;
  * the pipelined in-situ chain (host tail on a worker behind CUDA
    events), the FFT serving engine, and serving with the pipelined
    logits monitor (phase 7).

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
     and N = 1 and 2 as rows and columns against the plain Stockham
     version;
  4. FFT main path — the chain at 8192 x 8192 (every pass on the
     four-step kernel's radix route), 128 x 128 (every pass on the
     Stockham kernel), 200 x 200 (the quickstart's grid) and 10000 x
     10000 (mixed-radix rows and columns), in ``insitu`` and
     ``intransit`` modes, and 2048 x 32768 (32768-point rows as two
     mixed-radix passes) in ``insitu``, each held against a float64 numpy
     oracle of the same chain, with the launch counts of each run (the
     column route's apart); then one step at 8192², 10000² (which must
     show no copy kernel, and the mixed-radix kernel) and 200²: device
     busy ms of steps queued behind a spin kernel (CUDA events), the
     idle share, and time per launch by kernel (profiler);
  4b. distributed path — ``distributed_one_rank``: pencil, pencil_tf
     ((1, 1) mesh) and slab3d ((1,)) at 512³, pencil2d at 8192² and
     fourstep1d at 2^25, forward and back through ``plan_dft`` with the
     default backend, each against a float64 oracle (torch.fft in
     complex128 on the card), with host ms, device busy ms (runs queued
     behind a spin kernel, CUDA events), idle share, time per launch by
     kernel (profiler), launches and peak memory; ``distributed_ranks``:
     four ranks on cuda:0 over gloo (which stages CUDA tensors through host memory, so
     its wall times are host-bound): the Fig. 2 chain at 8192² on a (4,)
     slab and a (2, 2) pencil2d mesh (field and energies against the
     float64 oracle, mse1 < 0.5·mse0, one file written by rank 0),
     pencil, pencil_tf, slab3d at 256³ on (2, 2), slab3d on (4,),
     fourstep1d at 2^26 on (4,) from a cyclic input (each gathered on
     every rank against the float64 oracle, and back), fft → bandpass →
     ifft from a cyclic field on pencil_tf and fourstep1d (field and
     energies against the float64 oracle), and the slab with
     overlap_chunks=2 bit-identical to the unchunked one; then every
     FFT shape those runs gave the kernels (recorded at ``kernels.ops``),
     on its kernel against the plain version, torch.fft and the float64
     oracle;
  5. serve main path — ``launch/serve.main`` as above, with every kernel's
     launch count of that run (36 flash launches: one per layer of the
     one prefill); a teacher-forced check that prefill then one decode
     step gives the logits of a prefill one token longer; a continuous
     batcher at the same width (4 slots, 6 requests); device time by
     kernel over one 2048-token prefill and one decode step;
  4c. real (r2c/c2r) paths — the Fig. 2 chain with ``real: true`` FFT
     endpoints at 8192² and 10000² in both modes (run in phase 4, beside
     the complex chain, against the same float64 oracle; the energies
     are the half-spectrum's stored bins', as the reference sums them),
     with a profiled step of each; ``examples/insitu_rfft_batched.py``
     at full width (4 fields of 8192², ``batch_ndim=1``, two steps, the
     second from the plan cache); ``plan_rfft`` on a one-rank mesh:
     pencil, slab3d, pencil_tf at 512³, slab and pencil2d at 8192², each
     forward and back against float64 with host ms, device busy ms and
     the idle share; ``backend="measure"`` on the 8192² slab and the 512³
     pencil (every variant's time, the winner, the skips); the endcaps'
     torch.fft times; the half-width column shapes (8192 x 4097, 10000 x
     5001, 8192 x 4100) timed on the four-step kernel; and every FFT
     shape those paths gave the kernels, against the plain versions,
     torch.fft and float64. The four ranks (4b) also run every r2c
     decomposition against float64, the real chain on the (4,) slab, the
     complex slab with a bfloat16 and an int8_block64 wire (the
     exchanged values within each wire's documented bound of the exact
     wire's), the dtypes gloo's all_to_all takes on CUDA tensors, and
     ``backend``/``decomp="measure"`` at 256³ (one winner on every rank,
     then a warm start from wisdom that times no candidate);
  6. FFT rows past three passes of <= 439 points: 2^25 and 5^10 as four
     mixed-radix passes, 2^24 + 1 on Bluestein (M = 2^26), against the
     float64 oracle and torch.fft (last, so its Bluestein tables do not
     count in the earlier phases' peak memory); then the device memory
     before and after ``plan_cache_clear()``, which must free the tables;
  7. pipelined_and_engine — the pipelined Fig. 2 chain with the writer
     (``mode: "pipelined"``, depth 2) at complex 8192² and 10000² and
     real 8192²: 8 fields after a warm-up, each bit-identical to the
     insitu chain's on the same field and within 1e-4 of the float64
     oracle (mse1/mse0 < 0.5), the files in step order, the launches a
     field equal to an insitu step's, per-field wall ms and what the
     producer pays (``execute`` ms) beside insitu's, the pipeline's
     wait, backpressure, overlap efficiency, queue depth and peak
     memory; a steady-state ``execute`` queued behind a 50 ms spin kernel
     must return while the spin still runs (the producer never waits on
     the device). The four ranks (4b) also run the chain pipelined on the
     (4,) slab at 8192², 4 fields against depth 2, each bit-identical to
     insitu, the files on rank 0 in step order. The FFT serving engine
     on a CUDA host mesh: 96 requests from 4 client threads over
     (2048, 2048), (1000, 1000) and (128, 4096), each cycling c2c fft,
     r2c fft and r2c bandpass (keep_frac 0.25), prewarmed, served one
     request an execute and then batched (max_batch 8); every answer
     against float64 (fft 5e-5 of max |X|, bandpass 1e-4); latency
     percentiles, throughput, batched-execute ratio, queue depth, peak
     memory; four-step and Stockham launches. Then ``serve.main`` with
     ``--monitor-every 4 --monitor-batch 4`` on phase 5's parameters:
     the same tokens as phase 5's run, 36 flash launches, 2 monitor
     executes and files, the written statistics within 1e-5 of float64
     statistics of the captured last-token logits;
then one ``{"kernels": [...]}`` line. The last line is ``{"ok": true,
"device": {...}}``. Any failed check raises, and the script exits
non-zero. Without a CUDA device it exits non-zero before printing
anything.

Run from the repository root:  python3 chip_smoke.py
"""
import contextlib
import json
import math
import os
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
# the FFT kernels' symbols (csrc/fft_common.cuh, fft_fourstep.cu): every
# kernel that the wrappers' launch counts count
FFT_KERNELS = ("fft_lines_kernel", "mixed_lines_kernel", "mixed_reg_kernel",
               "bluestein_")
# the spin that the runs timed by queued_device_ms wait behind, and its
# clock cycles a second (H100 SXM boost clock, 1.98 GHz)
QUEUE_SPIN_S = 0.25
SPIN_CYCLES_PER_S = 1.98e9
# the distributed entry points on a one-rank mesh, at full size:
# (decomposition, mesh, grid, kernels that must launch). 512^3 complex64
# is 1 GiB a (re, im) pair, the per-GPU brick of a 4096^3 DNS on 512
# GPUs; pencil_tf and fourstep1d run their length-1 passes on Stockham
DIST_ONE_RANK = (
    ("pencil", (1, 1), (512, 512, 512), ("fft_fourstep",)),
    ("pencil_tf", (1, 1), (512, 512, 512), ("fft_fourstep",
                                            "fft_stockham")),
    ("slab3d", (1,), (512, 512, 512), ("fft_fourstep",)),
    ("pencil2d", (1, 1), (8192, 8192), ("fft_fourstep",)),
    ("fourstep1d", (1,), (1 << 25,), ("fft_fourstep", "fft_stockham")))
# four ranks on the one card, gloo: the chain's grid and the transforms
RANK_WORLD = 4
RANK_TIMEOUT_S = 600
RANK_CHAIN_DIMS = (8192, 8192)
RANK_DECOMPS = (("pencil", "(2, 2)", (256, 256, 256)),
                ("pencil_tf", "(2, 2)", (256, 256, 256)),
                ("slab3d", "(2, 2)", (256, 256, 256)),
                ("slab3d", "(4,)", (256, 256, 256)),
                ("fourstep1d", "(4,)", (1 << 26,)))
# fft -> bandpass -> ifft from a cyclic field on the cyclic decompositions
# (the mask permuted to the digit-permuted spectrum and cut to each
# rank's block), with the default backend
RANK_CYCLIC_CHAINS = (("pencil_tf", "(2, 2)", (256, 256, 256)),
                      ("fourstep1d", "(4,)", (1 << 24,)))
RANK_CYCLIC_KEEP_FRAC = 0.2
# the four-rank phase against the float64 oracle: the CPU tests' bar
# against the reference (tests/test_torch_distributed.py)
RANK_TOL = 1e-4
# the real (r2c/c2r) paths. The Fig. 2 chain with real=True at the
# complex chain's full-width grids: 8192^2 (half-width columns of 4097)
# and 10000^2 (5001)
REAL_CHAIN_DIMS = ((8192, 8192), (10000, 10000))
# examples/insitu_rfft_batched.py at full width: 4 fields of 8192^2
# (1 GiB of input) a step, its keep fraction
BATCH_FIELDS = (4, 8192, 8192)
BATCH_KEEP_FRAC = 0.08
# the r2c/c2r plans on a one-rank mesh: 512^3 real (512 MiB), 8192^2;
# pencil_tf runs its 1-point pass on Stockham
REAL_ONE_RANK = (
    ("pencil", (1, 1), (512, 512, 512), ("fft_fourstep",)),
    ("slab3d", (1,), (512, 512, 512), ("fft_fourstep",)),
    ("pencil_tf", (1, 1), (512, 512, 512), ("fft_fourstep",
                                            "fft_stockham")),
    ("slab", (1,), (8192, 8192), ("fft_fourstep",)),
    ("pencil2d", (1, 1), (8192, 8192), ("fft_fourstep",)))
# measured planning on the card, one rank, full size
MEASURE_ONE_CARD = (("slab", (1,), (8192, 8192)),
                    ("pencil", (1, 1), (512, 512, 512)))
# the half-width column shapes the real chains give the column route,
# timed on their own: the one-rank half widths and the 8192 half padded
# to a multiple of 4 (what a four-rank slab splits)
HALF_COLUMNS = ((8192, 4097), (10000, 5001), (8192, 4100))
# a measured winner with a reduced wire is held to the planner's own
# error budget (plan_dft's wire_tol default)
WIRE_TOL = 1e-2
# four ranks: the r2c decompositions against float64
RANK_REAL = (("slab", "(4,)", (8192, 8192)),
             ("pencil2d", "(2, 2)", (8192, 8192)),
             ("pencil", "(2, 2)", (256, 256, 256)),
             ("pencil_tf", "(2, 2)", (256, 256, 256)),
             ("slab3d", "(2, 2)", (256, 256, 256)))
# the complex slab with each wire, against the exact wire
RANK_WIRES = ("bfloat16", "int8_block64")
RANK_MEASURE = (256, 256, 256)
# the pipelined chain (phase 7): the Fig. 2 chain with a writer at each
# (grid, real) below, PIPE_FIELDS fields after a warm-up against a queue
# of PIPE_DEPTH, beside the insitu chain on the same fields; the spin the
# producer's steady-state execute must not wait behind
PIPE_CHAINS = (((8192, 8192), False), ((8192, 8192), True),
               ((10000, 10000), False))
PIPE_FIELDS = 8
PIPE_DEPTH = 2
PIPE_SPIN_S = 0.05
# threads making the fields (numpy releases the GIL in its array work;
# one 10000^2 field takes ~10 s alone and ~4 GB of float64 temporaries)
PIPE_PRODUCERS = 4
# four-step and bandpass launches a field of the complex 8192^2 chain: 2
# row and 4 column passes, one bandpass
PIPE_8192_LAUNCHES = {"fft_fourstep": 6, "bandpass_filter": 1}
# the pipelined chain on four ranks: the (4,) slab at RANK_CHAIN_DIMS
RANK_PIPE_FIELDS = 4
# the FFT serving engine's trace (the reference's bench_serve_fft shape,
# benchmarks/run.py): ENGINE_REQUESTS requests from ENGINE_CLIENTS client
# threads, request k on shape k % 3 and op (k // 3) % 3
ENGINE_SHAPES = ((2048, 2048), (1000, 1000), (128, 4096))
ENGINE_OPS = ({"op": "fft"}, {"op": "fft", "real": True},
              {"op": "bandpass", "real": True, "keep_frac": 0.25})
ENGINE_REQUESTS = 96
ENGINE_CLIENTS = 4
ENGINE_TIMEOUT_S = 300
# engine answers against float64 (torch.fft in complex128): an fft answer
# relative to max |X| at the kernels' bar, a bandpass answer (a forward
# and a backward transform) relative to max |field| at the field bar
ENGINE_FFT_TOL = 5e-5
ENGINE_BANDPASS_TOL = 1e-4
# the monitored serve: a snapshot every MONITOR_EVERY decode steps,
# MONITOR_BATCH snapshots a chain execute; the written statistics against
# float64 statistics of the captured logits, relative to the largest
MONITOR_EVERY = 4
MONITOR_BATCH = 4
MONITOR_TOL = 1e-5
# decode ms/token without and with the monitor, in turns after the checked
# monitored run (decode is host-paced: compare only within one call)
MONITOR_TURNS = (False, True, True, False)


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
    return spectrum_err(got, torch.fft.ifft(z, dim=dim) if inverse
                        else torch.fft.fft(z, dim=dim))


def spectrum_err(got, want):
    """Largest error of the pair ``got`` against complex128 ``want``,
    relative to max |want|."""
    return max(float((got[0].double() - want.real).abs().max()),
               float((got[1].double() - want.imag).abs().max())) / \
        float(want.abs().max())


def check_fft(name, wrapper, plain, shape, gen, timed: bool = True):
    """One FFT kernel at one shape against its plain version (where its
    angles hold; ``plain`` None where they do not, past 2^16), torch.fft,
    and the float64 oracle; then, if ``timed``, its times."""
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
    held = plain is not None and plain_holds(N)
    for inverse in (False, True):
        kr, ki = wrapper(re, im, inverse=inverse)
        pr, pi = (kr, ki) if plain is None else plain(re, im,
                                                      inverse=inverse)
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
        res[tag + "max_abs_err"] = err if plain else None
        res[tag + "max_rel_err"] = err / scale if plain else None
        res[tag + "rel_err_vs_torch_fft"] = lib_err / scale
        res[tag + "rel_err_vs_f64"] = f64
        res["plain_held"] = held
        if not ((err / scale < tol or not held)
                and lib_err / scale < FFT_TOL_LIB and f64 < FFT_TOL_F64):
            emit(res)
            raise AssertionError(f"{name} {shape} inverse={inverse}: "
                                 f"{err / scale:.3e} vs plain (bar {tol}), "
                                 f"{lib_err / scale:.3e} vs torch.fft, "
                                 f"{f64:.3e} vs float64")
        del kr, ki
    if not timed:
        emit(res)
        return res
    z = torch.complex(re, im)
    res["kernel_ms"] = time_ms(lambda: wrapper(re, im))
    res["plain_ms"] = time_ms(lambda: plain(re, im)) if plain else None
    res["library_ms"] = time_ms(lambda: torch.fft.fft(z, dim=-1))
    res["device_ms"] = device_ms(lambda: wrapper(re, im))
    res["library_device_ms"] = device_ms(lambda: torch.fft.fft(z, dim=-1))
    res["bound_ms"], res["bound_by"] = bound(fft_flops(N) * B, 16.0 * B * N)
    emit(res)
    return res


def check_fft_columns(name, wrapper, plain, shape, gen, timed: bool = True):
    """One FFT kernel's column route, along axis -2 of ``shape`` viewed as
    (outer, N, inner), against its plain version moved to the last axis
    and back (where its angles hold), ``torch.fft.fft(z, dim=-2)`` and
    the float64 oracle; then, if ``timed``, its times."""
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
    if not timed:
        emit(res)
        return res
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
    """The chain in float64 numpy: fft2 → the same mask → ifft2. The
    energies come twice: over the whole spectrum (the complex chain's)
    and over the half-spectrum's stored bins, k1 <= N1/2, with no
    Hermitian weight (the real chain's, as the reference sums them).
    The mask is Hermitian-symmetric, so both chains give one field."""
    import numpy as np
    from repro_torch.core.fft.filters import lowpass_mask
    from repro_torch.core.insitu.adaptors import radiating_field
    noisy, clean = radiating_field(dims, seed=0)
    spec = np.fft.fft2(noisy.astype(np.float64))
    power = spec.real ** 2 + spec.imag ** 2
    mask = lowpass_mask(dims, KEEP_FRAC).numpy()
    h = dims[-1] // 2 + 1
    kept, total = float((power * mask).sum()), float(power.sum())
    kept_half = float((power[:, :h] * mask[:, :h]).sum())
    total_half = float(power[:, :h].sum())
    del power
    spec *= mask
    denoised = np.fft.ifft2(spec).real
    return {"noisy": noisy, "clean": clean, "denoised": denoised,
            "energies": (kept, total), "half_energies": (kept_half,
                                                         total_half)}


def chain_config(mode, real=False, out_dir=None):
    """The Fig. 2 chain as a user configures it: kernel FFT endpoints
    (r2c/c2r plans with ``real``), the bandpass, and a writer where
    ``out_dir`` is given."""
    chain = [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "backend": "pallas", "real": real},
        {"endpoint": "bandpass", "array": "field", "keep_frac": KEEP_FRAC},
        {"endpoint": "fft", "array": "field", "direction": "backward",
         "backend": "pallas", "real": real}]
    if out_dir is not None:
        chain.append({"endpoint": "writer", "array": "field",
                      "out_dir": str(out_dir)})
    return {"mode": mode, "chain": chain}


def run_chain(dims, mode, mesh, expected, out_dir, real=False, shapes=None):
    """One chain step on the card against the float64 oracle, with its
    launches, wall time and peak memory; ``real`` runs the r2c/c2r
    chain, whose energies are those of the half-spectrum's bins.
    ``shapes`` collects the FFT shapes the step gives the kernels."""
    import numpy as np
    import torch
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.config import build_chain
    from repro_torch.kernels import ops
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter}
    noisy, clean, want = (expected[k] for k in ("noisy", "clean",
                                                "denoised"))
    kept64, total64 = expected["half_energies" if real else "energies"]
    data = RadiatingSourceAdaptor(dims, mesh=mesh).produce(0)

    def chain_for(out):
        return build_chain(chain_config(mode, real, out), mesh=mesh,
                           grid=data.grid)

    # one untimed run first, so the timed one does not pay the caching
    # allocator's first growth to this size
    chain_for(out_dir / "warmup").execute(data)
    chain = chain_for(out_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    with recording_fft_shapes(set() if shapes is None else shapes):
        out = chain.execute(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    got = out.arrays["field"].cpu().numpy()
    field_err = float(np.abs(got - want).max())
    mse0 = float(np.mean((noisy - clean) ** 2))
    mse1 = float(np.mean((got - clean) ** 2))
    kept = float(out.arrays["insitu_kept_energy"])
    total = float(out.arrays["insitu_total_energy"])
    files = chain.finalize()["writer"]["files"]
    res = {"phase": "real_chain" if real else "main_path",
           "dims": list(dims), "mode": mode, "real": real,
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
    if real:
        assert res["mse1"] < 0.5 * res["mse0"], res
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
    where some still go missing (whole runs, late in a long process),
    launch counts that are not whole multiples of ``reps`` show it, so
    busy time is taken by ``queued_device_ms`` where it is reported."""
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


def queued_device_ms(fn, reps: int) -> float:
    """Device time of one run of ``fn`` with no host gaps: ``reps`` runs
    queued behind a spin kernel that outlasts the host's enqueueing (the
    event after the spin must still be pending when the last run is
    queued), timed by CUDA events between the spin's end and the last
    kernel's. Needs no trace, so it loses no kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * QUEUE_SPIN_S))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    queued = not start.query()
    stop.synchronize()
    if not queued:
        raise AssertionError(f"the host took longer than the {QUEUE_SPIN_S}"
                             f" s spin to queue {reps} runs (or waited "
                             f"for the device)")
    return start.elapsed_time(stop) / reps


def profile_chain(dims, mesh, out_dir, real=False):
    """One in-situ step of the chain: device busy ms from PROFILE_REPS
    steps queued behind a spin kernel (``queued_device_ms``: the
    endpoints back to back, without the chain's closing wait), the
    idle share of a step's wall time, and device time by kernel from
    torch.profiler (ms per launch it kept, with the FFT launches it kept
    beside those the wrappers counted)."""
    import torch
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.config import build_chain
    from repro_torch.kernels import ops
    data = RadiatingSourceAdaptor(dims, mesh=mesh).produce(0)
    chain = build_chain(chain_config("insitu", real), mesh=mesh,
                        grid=data.grid)

    def step():
        out = data
        for ep in chain.endpoints:
            out = ep.execute(out)
        return out

    before = ops.fft_fourstep.launches + ops.fft_stockham.launches
    chain.execute(data)
    torch.cuda.synchronize()
    launched = ops.fft_fourstep.launches + ops.fft_stockham.launches - before
    busy = queued_device_ms(step, PROFILE_REPS)
    wall_ms, rows = device_profile(lambda: chain.execute(data),
                                   reps=PROFILE_REPS)
    # PyTorch's copy and elementwise kernels (a transposing copy is one)
    copies = [(n, t, c) for n, t, c in rows
              if any(w in n.lower() for w in ("copy", "elementwise"))]
    res = {"phase": "profile", "dims": list(dims), "mode": "insitu",
           "real": real,
           "stages": "fft -> bandpass -> fft (no writer)",
           "steps_recorded": PROFILE_REPS,
           "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms,
           "fft_launches_counted": PROFILE_REPS * launched,
           "fft_launches_traced": round(PROFILE_REPS * sum(
               c for n, _, c in rows if any(k in n for k in FFT_KERNELS))),
           "kernel_launches_traced": sum(c for _, _, c in rows),
           "copy_elementwise_kernels": [
               {"name": n[:80], "ms_per_launch": t / c,
                "launches_traced": c * PROFILE_REPS} for n, t, c in copies],
           "by_kernel_ms": [{"name": n[:80], "ms_per_launch": t / c,
                             "launches_traced": c * PROFILE_REPS}
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
    its flash launch count, its report, the config and the seeded
    parameters (phase 7's monitored serve runs on them)."""
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
    return launches["flash_attention"], report, cfg, params


def layout_oracle(z, decomp, p0, inverse):
    """The float64 transform of complex128 ``z`` over all its dims in
    ``decomp``'s layouts: for pencil_tf and fourstep1d the spatial side
    is cyclic and the spectral side digit-permuted along axis 0 over
    ``p0`` shards (both the identity at p0 = 1)."""
    import torch
    from repro_torch.core.fft import distributed as D
    n0 = z.shape[0]

    def take(x, order):
        return x.index_select(0, torch.as_tensor(order, device=x.device))

    cyclic = decomp in D.CYCLIC_DECOMPS and p0 > 1
    if not inverse:
        if cyclic:
            z = take(z, D.cyclic_inverse_order(n0, p0))
        y = torch.fft.fftn(z)
        return take(y, D.fourstep_freq_of_position(n0, p0)) if cyclic else y
    if cyclic:
        z = take(z, D.fourstep_position_of_freq(n0, p0))
    y = torch.fft.ifftn(z)
    return take(y, D.cyclic_order(n0, p0)) if cyclic else y


def launch_counts(counters):
    out = {k: fn.launches for k, fn in counters.items()}
    for k in ("fft_fourstep", "fft_stockham"):
        if k in counters:
            out[k + "_columns"] = counters[k].column_launches
    return out


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "column_launches"):
            fn.column_launches = 0


@contextlib.contextmanager
def recording_fft_shapes(seen: set):
    """While active, add to ``seen`` the (outer, N, inner) view of every
    FFT that ``kernels.ops`` hands to a kernel (rows have inner 1): the
    shapes a path gives the kernels, to hold each against its plain
    version apart from the path."""
    from repro_torch.kernels import ops
    fft, fft_axis = ops.fft, ops.fft_axis

    def rec_fft(re, im, **kw):
        seen.add((re.shape[0], re.shape[1], 1))
        return fft(re, im, **kw)

    def rec_fft_axis(re, im, axis, **kw):
        axis %= re.dim()
        seen.add((math.prod(re.shape[:axis]), re.shape[axis],
                  math.prod(re.shape[axis + 1:])))
        return fft_axis(re, im, axis, **kw)

    ops.fft, ops.fft_axis = rec_fft, rec_fft_axis
    try:
        yield seen
    finally:
        ops.fft, ops.fft_axis = fft, fft_axis


def check_path_shapes(shapes, gen):
    """Each FFT shape a path gave the kernels, on the kernel that
    ``kernels.ops`` picks for it, against its plain version (where its
    float32 angles hold), torch.fft and the float64 oracle; correctness
    only, untimed."""
    from repro_torch.core.fft import dft
    from repro_torch.kernels import ops
    out = []
    for outer, n, inner in sorted(shapes):
        stockham = ops._use_stockham(n, "auto")
        name = "fft_stockham" if stockham else "fft_fourstep"
        plain = dft.stockham_fft if stockham else dft.fourstep_fft
        if inner == 1:
            wrapper = ops.fft_stockham if stockham else ops.fft_fourstep
            out.append(check_fft(name, wrapper,
                                 plain if plain_holds(n) else None,
                                 (outer, n), gen, timed=False))
        else:
            wrapper = (ops.fft_stockham_columns if stockham
                       else ops.fft_fourstep_columns)
            out.append(check_fft_columns(name, wrapper, plain,
                                         (outer, n, inner), gen,
                                         timed=False))
    return out


def distributed_one_rank(counters, gen, shapes: set):
    """The distributed entry points on a one-rank mesh at full size:
    ``plan_dft`` → ``execute`` forward and back with the default backend
    (the kernels, on the card), each against a float64 oracle (torch.fft
    in complex128 on the card), with host ms, CUDA-event ms, device busy
    ms (queued runs, CUDA events), the idle share, time per launch by
    kernel (profiler), launches and peak memory. Adds the FFT shapes the
    runs gave the kernels to ``shapes``."""
    import torch
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft.plan import BACKWARD, FORWARD, plan_dft
    out = {}
    for decomp, mshape, grid, must in DIST_ONE_RANK:
        mesh = make_mesh(mshape, ("data", "model")[:len(mshape)])
        re = torch.randn(grid, generator=gen, device="cuda")
        im = torch.randn(grid, generator=gen, device="cuda")
        fwd = plan_dft(grid, FORWARD, mesh, decomp=decomp)
        bwd = plan_dft(grid, BACKWARD, mesh, decomp=decomp)
        bwd.execute(*fwd.execute(re, im))           # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = {"phase": "distributed_one_rank", "decomp": decomp,
               "mesh": list(mshape), "grid": list(grid),
               "schedule": fwd.schedule().name, "backend": fwd.backend,
               "tol_vs_f64": FFT_TOL_F64}
        zero_counts(counters)
        t0 = time.perf_counter()
        with recording_fft_shapes(shapes):
            y = fwd.execute(re, im)
        torch.cuda.synchronize()
        res["forward_host_ms"] = (time.perf_counter() - t0) * 1e3
        res["forward_launches"] = launch_counts(counters)
        zero_counts(counters)
        t0 = time.perf_counter()
        with recording_fft_shapes(shapes):
            x = bwd.execute(*y)
        torch.cuda.synchronize()
        res["backward_host_ms"] = (time.perf_counter() - t0) * 1e3
        res["backward_launches"] = launch_counts(counters)
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        z = torch.complex(re.double(), im.double())
        res["forward_rel_err_vs_f64"] = spectrum_err(
            y, layout_oracle(z, decomp, 1, False))
        del z
        zy = torch.complex(y[0].double(), y[1].double())
        res["backward_rel_err_vs_f64"] = spectrum_err(
            x, layout_oracle(zy, decomp, 1, True))
        del zy, x
        # device busy: PROFILE_REPS runs queued behind a spin (no host
        # gaps), by CUDA events; the idle share against the host-timed
        # wall of a run. Time by kernel from torch.profiler, per launch
        # it kept: its trace can lose a run's kernels here (a whole one
        # of three at 512^3, each of four takes, on an H100), so the
        # launches it saw stand beside those the wrappers counted
        res["steps_recorded"] = PROFILE_REPS
        for tag, fn in (("forward", lambda: fwd.execute(re, im)),
                        ("backward", lambda: bwd.execute(*y))):
            busy = queued_device_ms(fn, PROFILE_REPS)
            wall_ms, rows = device_profile(fn, reps=PROFILE_REPS)
            res[tag + "_events_ms"] = time_ms(fn, iters=5)
            res[tag + "_device_busy_ms"] = busy
            res[tag + "_wall_ms"] = wall_ms
            res[tag + "_device_idle_share"] = 1.0 - busy / wall_ms
            res[tag + "_fft_launches_counted"] = PROFILE_REPS * (
                res[tag + "_launches"]["fft_fourstep"]
                + res[tag + "_launches"]["fft_stockham"])
            res[tag + "_fft_launches_traced"] = round(PROFILE_REPS * sum(
                c for n, _, c in rows if any(k in n for k in FFT_KERNELS)))
            res[tag + "_by_kernel_ms"] = [
                {"name": n[:80], "ms_per_launch": t / c,
                 "launches_traced": c * PROFILE_REPS}
                for n, t, c in rows]
        emit(res)
        launched = {k: res["forward_launches"][k]
                    + res["backward_launches"][k] for k in must}
        assert all(launched.values()), (decomp, launched)
        assert res["forward_rel_err_vs_f64"] < FFT_TOL_F64, res
        assert res["backward_rel_err_vs_f64"] < FFT_TOL_F64, res
        out[decomp] = res
        del re, im, y
        torch.cuda.empty_cache()
    return out


def distributed_ranks(out_dir):
    """The distributed path on RANK_WORLD ranks sharing the one card:
    this script started once per rank (``--rank``), gloo collectives over
    CUDA tensors on cuda:0 (gloo stages them through host memory, so
    the times are host-bound). Each rank prints one JSON line; any rank
    failing fails the phase."""
    store = out_dir / "store"
    out_dir.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         "--world", str(RANK_WORLD), "--store", str(store)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(RANK_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    results = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in so.splitlines() if ln.startswith("{")]
        if p.returncode or not lines:
            print(se[-4000:], file=sys.stderr)
            raise AssertionError(f"rank {r} exited {p.returncode}")
        results.append(json.loads(lines[-1]))
    emit({"phase": "distributed_ranks", "ranks": RANK_WORLD,
          "backend": "gloo (CUDA tensors staged through host memory)",
          "device": "cuda:0, shared by every rank", "wall_s": wall,
          "results": results})
    return results


def rank_worker(rank, world, store):
    """One rank of ``distributed_ranks``: the Fig. 2 chain at 8192² on a
    (4,) slab mesh and a (2, 2) pencil2d mesh, pencil, pencil_tf and
    slab3d at 256³ on (2, 2), slab3d on (4,), fourstep1d at 2^26 on (4,)
    from a cyclic input, fft → bandpass → ifft from a cyclic field on
    pencil_tf (256³, (2, 2)) and fourstep1d (2^24, (4,)), and the slab
    with overlap_chunks=2 against the unchunked slab. Every rank gathers
    every result and holds it against the float64 oracle (torch.fft in
    complex128 on the card). Its JSON line lists the FFT shapes its runs
    gave the kernels."""
    import torch
    import torch.distributed as dist
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft.filters import lowpass_mask
    from repro_torch.core.fft.plan import BACKWARD, FORWARD, plan_dft
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.bridge import BridgeData, GridMeta
    from repro_torch.core.insitu.config import build_chain
    from repro_torch.kernels import _build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    _build.library()                # built by the parent
    dev = "cuda:0"
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter}
    meshes = {"(4,)": make_mesh((4,), ("data",), device=dev),
              "(2, 2)": make_mesh((2, 2), ("data", "model"), device=dev)}
    checks = []
    shapes = set()
    recording = contextlib.ExitStack()
    recording.enter_context(recording_fft_shapes(shapes))

    def record(**kw):
        checks.append(kw)
        return kw

    # the Fig. 2 chain across the ranks
    dims = RANK_CHAIN_DIMS
    mask = lowpass_mask(dims, KEEP_FRAC).to(dev)
    for decomp, mkey in (("slab", "(4,)"), ("pencil2d", "(2, 2)")):
        mesh = meshes[mkey]
        spec = plan_dft(dims, FORWARD, mesh,
                        decomp=decomp).schedule().in_spec
        data = RadiatingSourceAdaptor(dims, mesh=mesh, spec=spec).produce(0)
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": decomp},
            {"endpoint": "bandpass", "keep_frac": KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": decomp},
            {"endpoint": "writer",
             "out_dir": str(Path(store).parent / decomp)},
        ]}, mesh=mesh, grid=data.grid)
        zero_counts(counters)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = chain.execute(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(counters)
        files = chain.finalize()["writer"]["files"]
        got = D.unshard(res.arrays["field"], mesh, res.spec).double()
        noisy = D.unshard(data.arrays["field"], mesh, data.spec).double()
        clean = D.unshard(data.arrays["clean_reference"], mesh,
                          data.spec).double()
        spec = torch.fft.fft2(noisy)
        power = spec.real ** 2 + spec.imag ** 2
        kept64 = float((power * mask).sum())
        total64 = float(power.sum())
        want = torch.fft.ifft2(spec * mask).real
        del spec, power
        kept = float(res.arrays["insitu_kept_energy"])
        total = float(res.arrays["insitu_total_energy"])
        mse0 = float(((noisy - clean) ** 2).mean())
        mse1 = float(((got - clean) ** 2).mean())
        r = record(check="chain", decomp=decomp, mesh=mkey, dims=list(dims),
                   wall_s=wall, launches=launches,
                   field_max_abs_err=float((got - want).abs().max()),
                   kept_rel_err=abs(kept - kept64) / kept64,
                   total_rel_err=abs(total - total64) / total64,
                   mse0=mse0, mse1=mse1, files_written=len(files),
                   finite=bool(torch.isfinite(got).all()))
        assert r["finite"] and r["field_max_abs_err"] < FIELD_TOL, r
        assert r["kept_rel_err"] < ENERGY_TOL, r
        assert r["total_rel_err"] < ENERGY_TOL, r
        assert mse1 < 0.5 * mse0, r
        assert len(files) == (1 if rank == 0 else 0), r
        assert launches["fft_fourstep"] and launches["bandpass_filter"], r
        del got, noisy, clean, want, data, res
    pipelined_ranks(rank, meshes["(4,)"], counters, record, store)

    # 3-D and 1-D decompositions: forward, then back
    gen = torch.Generator(device=dev)
    for decomp, mkey, grid in RANK_DECOMPS:
        mesh = meshes[mkey]
        p0 = mesh.shape["data"]
        gen.manual_seed(7)              # the same global field on every rank
        z = torch.complex(torch.randn(grid, generator=gen, device=dev),
                          torch.randn(grid, generator=gen, device=dev))
        if decomp in D.CYCLIC_DECOMPS:  # the spatial side is cyclic
            z = z.index_select(0, torch.as_tensor(
                D.cyclic_order(grid[0], p0), device=dev))
        fwd = plan_dft(grid, FORWARD, mesh, decomp=decomp, backend="pallas")
        bwd = plan_dft(grid, BACKWARD, mesh, decomp=decomp, backend="pallas")
        zero_counts(counters)
        dist.barrier()
        t0 = time.perf_counter()
        y = fwd.execute(*fwd.place(z))
        x = bwd.execute(*y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(counters)
        yg = fwd.unplace(*y)
        xg = bwd.unplace(*x)
        z64 = z.to(torch.complex128)
        r = record(check="transform", decomp=decomp, mesh=mkey,
                   grid=list(grid), wall_s=wall, launches=launches,
                   forward_rel_err_vs_f64=spectrum_err(
                       yg, layout_oracle(z64, decomp, p0, False)),
                   backward_rel_err_vs_input=spectrum_err(xg, z64))
        assert r["forward_rel_err_vs_f64"] < RANK_TOL, r
        assert r["backward_rel_err_vs_input"] < RANK_TOL, r
        del z, z64, y, x, yg, xg

    # the chain from a cyclic field on the cyclic decompositions
    for decomp, mkey, grid in RANK_CYCLIC_CHAINS:
        mesh = meshes[mkey]
        gen.manual_seed(9)
        natural = torch.randn(grid, generator=gen, device=dev)
        order = torch.as_tensor(D.cyclic_order(grid[0], mesh.shape["data"]),
                                device=dev)
        spec = plan_dft(grid, FORWARD, mesh,
                        decomp=decomp).schedule().in_spec
        x = D.shard(natural.index_select(0, order), mesh, spec)
        data = BridgeData(arrays={"field": (x, torch.zeros_like(x))},
                          grid=GridMeta(grid), layout="cyclic", spec=spec)
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "fft", "direction": "forward", "decomp": decomp},
            {"endpoint": "bandpass", "keep_frac": RANK_CYCLIC_KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "decomp": decomp},
        ]}, mesh=mesh, grid=data.grid)
        zero_counts(counters)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = chain.execute(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(counters)
        got = D.unshard(res.arrays["field"], mesh, res.spec).double()
        cmask = lowpass_mask(grid, RANK_CYCLIC_KEEP_FRAC).to(dev).double()
        spec64 = torch.fft.fftn(natural.double())
        want = torch.fft.ifftn(spec64 * cmask).real.index_select(0, order)
        power = spec64.real ** 2 + spec64.imag ** 2
        kept64 = float((power * cmask).sum())
        total64 = float(power.sum())
        del spec64, power, cmask
        r = record(check="cyclic_chain", decomp=decomp, mesh=mkey,
                   grid=list(grid), wall_s=wall, launches=launches,
                   layout=res.layout,
                   field_max_abs_err=float((got - want).abs().max()),
                   kept_rel_err=abs(float(res.arrays["insitu_kept_energy"])
                                    - kept64) / kept64,
                   total_rel_err=abs(float(
                       res.arrays["insitu_total_energy"]) - total64)
                   / total64)
        assert r["layout"] == "cyclic", r
        assert r["field_max_abs_err"] < FIELD_TOL, r
        assert r["kept_rel_err"] < ENERGY_TOL, r
        assert r["total_rel_err"] < ENERGY_TOL, r
        assert launches["fft_fourstep"], r
        del natural, x, data, res, got, want

    # overlap chunking: bit-identical to the unchunked slab
    mesh = meshes["(4,)"]
    gen.manual_seed(8)
    z = torch.complex(torch.randn(dims, generator=gen, device=dev),
                      torch.randn(dims, generator=gen, device=dev))
    got = []
    for chunks in (0, 2):
        plan = plan_dft(dims, FORWARD, mesh, decomp="slab", backend="pallas",
                        overlap_chunks=chunks)
        dist.barrier()
        t0 = time.perf_counter()
        got.append(plan.execute(*plan.place(z)))
        torch.cuda.synchronize()
        record(check="overlap_timing", overlap_chunks=chunks,
               wall_s=time.perf_counter() - t0)
    r = record(check="overlap", decomp="slab", mesh="(4,)",
               overlap_chunks=2, dims=list(dims),
               bit_identical=all(torch.equal(a, b)
                                 for a, b in zip(got[0], got[1])))
    assert r["bit_identical"], r
    del got, z
    rank_real_paths(rank, meshes, counters, record, gen, store)
    recording.close()
    print(json.dumps({"rank": rank, "ok": True, "checks": checks,
                      "fft_shapes": sorted(shapes)}), flush=True)
    dist.barrier()


def rank_real_paths(rank, meshes, counters, record, gen, store):
    """The real paths on the four ranks (a part of ``rank_worker``): each
    r2c/c2r decomposition against float64, the real chain on the (4,)
    slab, the complex slab with each wire against the exact wire, the
    dtypes gloo's all_to_all takes on CUDA tensors, measured planning
    (the same winner on every rank) and the warm start from wisdom."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft import plan as P
    from repro_torch.core.fft import wire
    from repro_torch.core.fft.filters import lowpass_mask
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.config import build_chain
    dev = "cuda:0"

    # every r2c decomposition: forward against float64, and back
    for decomp, mkey, grid in RANK_REAL:
        mesh = meshes[mkey]
        p0 = mesh.shape["data"]
        gen.manual_seed(11)              # the same global field everywhere
        x = torch.randn(grid, generator=gen, device=dev)
        if decomp in D.CYCLIC_DECOMPS:   # the spatial side is cyclic
            x = x.index_select(0, torch.as_tensor(
                D.cyclic_order(grid[0], p0), device=dev))
        fwd = P.plan_rfft(grid, "forward", mesh, decomp=decomp)
        bwd = P.plan_rfft(grid, "backward", mesh, decomp=decomp)
        zero_counts(counters)
        dist.barrier()
        t0 = time.perf_counter()
        y = fwd.execute(*fwd.place(x))
        back = bwd.execute(*y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(counters)
        yg = fwd.unplace(*y)
        xg = bwd.unplace(back)
        r = record(check="real_transform", decomp=decomp, mesh=mkey,
                   grid=list(grid), wall_s=wall, launches=launches,
                   half_extent=yg[0].shape[-1],
                   forward_rel_err_vs_f64=half_err(
                       yg, real_layout_oracle(x.double(), decomp, p0)),
                   backward_rel_err_vs_input=float(
                       (xg - x).abs().max() / x.abs().max()))
        assert r["forward_rel_err_vs_f64"] < RANK_TOL, r
        assert r["backward_rel_err_vs_input"] < RANK_TOL, r
        assert launches["fft_fourstep"], r
        del x, y, back, yg, xg

    # the real chain on the (4,) slab: the field against float64, the
    # half-spectrum's energies against float64 sums of its stored bins
    dims = RANK_CHAIN_DIMS
    mesh = meshes["(4,)"]
    mask = lowpass_mask(dims, KEEP_FRAC).to(dev).double()
    spec_in = P.plan_rfft(dims, "forward", mesh).schedule().in_spec
    data = RadiatingSourceAdaptor(dims, mesh=mesh, spec=spec_in).produce(0)
    chain = build_chain(chain_config("insitu", real=True), mesh=mesh,
                        grid=data.grid)
    zero_counts(counters)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = chain.execute(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    got = D.unshard(res.arrays["field"], mesh, res.spec).double()
    noisy = D.unshard(data.arrays["field"], mesh, data.spec).double()
    clean = D.unshard(data.arrays["clean_reference"], mesh,
                      data.spec).double()
    half = torch.fft.rfft2(noisy)
    h = half.shape[-1]
    power = half.real ** 2 + half.imag ** 2
    kept64 = float((power * mask[:, :h]).sum())
    total64 = float(power.sum())
    want = torch.fft.irfft2(half * mask[:, :h], s=dims)
    del half, power
    mse0 = float(((noisy - clean) ** 2).mean())
    mse1 = float(((got - clean) ** 2).mean())
    r = record(check="real_chain", decomp="slab", mesh="(4,)",
               dims=list(dims), wall_s=wall, launches=launches,
               layout=res.layout,
               field_max_abs_err=float((got - want).abs().max()),
               kept_rel_err=abs(float(res.arrays["insitu_kept_energy"])
                                - kept64) / kept64,
               total_rel_err=abs(float(res.arrays["insitu_total_energy"])
                                 - total64) / total64,
               mse0=mse0, mse1=mse1)
    assert r["field_max_abs_err"] < FIELD_TOL, r
    assert r["kept_rel_err"] < ENERGY_TOL, r
    assert r["total_rel_err"] < ENERGY_TOL, r
    assert mse1 < 0.5 * mse0, r
    assert launches["fft_fourstep"] and launches["bandpass_filter"], r
    del got, noisy, clean, want, data, res, mask

    # the complex slab with a wire on its exchange: the exchanged values
    # (the row pass's output, recovered by undoing the column pass in
    # float64) within the wire's documented bound of the exact wire's
    gen.manual_seed(13)
    z = torch.complex(torch.randn(dims, generator=gen, device=dev),
                      torch.randn(dims, generator=gen, device=dev))
    outs = {}
    for w in (None,) + RANK_WIRES:
        plan = P.plan_dft(dims, "forward", mesh, decomp="slab",
                          wire_dtype=w)
        dist.barrier()
        t0 = time.perf_counter()
        yw = plan.execute(*plan.place(z))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        yg = plan.unplace(*yw)
        # undo the column pass: what the exchange delivered, re and im
        x1 = torch.fft.ifft(torch.complex(yg[0].double(), yg[1].double()),
                            dim=0)
        outs[w] = (x1.real, x1.imag, wall)
        del yw, yg, x1
    ex_re, ex_im, ex_wall = outs[None]
    for w in RANK_WIRES:
        got_re, got_im, wall = outs[w]
        excess = 0.0
        for got_p, ex_p in ((got_re, ex_re), (got_im, ex_im)):
            if w == "bfloat16":
                bnd = wire.BF16_REL_BOUND * ex_p.abs() + wire.BF16_ABS_GUARD
            else:   # absmax over each 64-column block of a row / 254
                blocks = ex_p.abs().reshape(dims[0], -1,
                                            wire.DEFAULT_BLOCK)
                bnd = (blocks.amax(-1, keepdim=True)
                       * wire.INT8_REL_BOUND).expand_as(blocks).reshape(
                           dims)
            # float32 roundoff of the two passes around the exchange
            slack = 1e-5 * float(ex_p.abs().max())
            excess = max(excess, float((got_p - ex_p).abs().sub(
                bnd + slack).max()))
        r = record(check="wire", decomp="slab", mesh="(4,)",
                   dims=list(dims), wire_dtype=w, wall_s=wall,
                   exact_wall_s=ex_wall,
                   max_excess_over_bound=excess,
                   wire_bytes_per_rank=(
                       wire.get_codec(w).wire_bytes(
                           (dims[0] // 4, dims[1])) * 2
                       if wire.is_codec(w) else
                       2 * 2 * dims[0] * dims[1] // 4),
                   exact_bytes_per_rank=wire.exact_bytes(
                       (dims[0] // 4, dims[1])) * 2)
        assert excess <= 0.0, r
    del outs, ex_re, ex_im, z

    # which dtypes gloo's all_to_all takes on CUDA tensors (a reduced or
    # encoded wire moves as uint8 bytes either way)
    taken = {}
    for dt in (torch.bfloat16, torch.float16, torch.int16, torch.uint8):
        t = torch.ones(4, 8, dtype=dt, device=dev)
        try:
            dist.all_to_all_single(torch.empty_like(t), t)
            taken[str(dt).split(".")[-1]] = True
        except (RuntimeError, ValueError) as e:
            taken[str(dt).split(".")[-1]] = f"{type(e).__name__}: {e}"[:120]
    record(check="gloo_cuda_all_to_all_dtypes", taken=taken)

    # measured planning at 256^3 on (2, 2): backend and decomposition
    # measured, the same winner on every rank; then the warm start
    mesh = meshes["(2, 2)"]
    grid = RANK_MEASURE
    P.set_wisdom(str(Path(store).parent / "wisdom.json"))
    P.plan_cache_clear()
    dist.barrier()
    t0 = time.perf_counter()
    plan = P.plan_dft(grid, "forward", mesh, decomp="measure",
                      backend="measure")
    sweep_s = time.perf_counter() - t0
    cold = P.plan_cache_stats()
    skips = P.autotune_skips()
    mine = [plan.decomp, plan.backend, plan.overlap_chunks,
            plan.wire_dtype]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    gen.manual_seed(14)
    z = torch.complex(torch.randn(grid, generator=gen, device=dev),
                      torch.randn(grid, generator=gen, device=dev))
    yg = plan.unplace(*plan.execute(*plan.place(z)))
    err = spectrum_err(yg, torch.fft.fftn(z.to(torch.complex128)))
    del yg, z
    P.plan_cache_clear()
    dist.barrier()
    t0 = time.perf_counter()
    again = P.plan_dft(grid, "forward", mesh, decomp="measure",
                       backend="measure")
    warm_s = time.perf_counter() - t0
    warm = P.plan_cache_stats()
    P.set_wisdom(None)
    tol = RANK_TOL if plan.wire_dtype is None else WIRE_TOL
    r = record(check="measure", mesh="(2, 2)", grid=list(grid),
               winner=mine, winners_every_rank=every, sweep_s=sweep_s,
               rel_err_vs_f64=err, tol=tol,
               codec_candidates=cold["wire_codec_candidates"],
               profile_candidates=cold["wire_profile_candidates"],
               one_host_note=("one host: no exchange crosses hosts, so the "
                              "sweep makes no codec candidates and skips "
                              "the per-stage profile candidate"),
               skips=[{k: v for k, v in sk.items()
                       if k not in ("shape", "direction", "batch_ndim")}
                      for sk in skips],
               timed_cold=cold["sweep_candidates_timed"],
               timed_warm=warm["sweep_candidates_timed"],
               wisdom_hits_warm=warm["wisdom_hits"], warm_s=warm_s,
               warm_winner=[again.decomp, again.backend,
                            again.overlap_chunks, again.wire_dtype])
    assert all(w == every[0] for w in every), r
    assert err < tol, r
    assert cold["wire_codec_candidates"] == 0, r
    assert any(sk.get("sweep") == "wire-profile" for sk in skips), r
    assert warm["sweep_candidates_timed"] == 0 and warm["wisdom_hits"], r
    assert r["warm_winner"] == mine, r


def real_layout_oracle(x, decomp, p0):
    """The float64 r2c transform of real float64 ``x`` over all its dims
    in ``decomp``'s layouts (pencil_tf: cyclic spatial input and
    digit-permuted spectrum along axis 0 over ``p0`` shards), the half
    axis unpadded."""
    import torch
    from repro_torch.core.fft import distributed as D
    n0 = x.shape[0]

    def take(v, order):
        return v.index_select(0, torch.as_tensor(order, device=v.device))

    cyclic = decomp in D.CYCLIC_DECOMPS and p0 > 1
    if cyclic:
        x = take(x, D.cyclic_inverse_order(n0, p0))
    y = torch.fft.rfftn(x)
    return take(y, D.fourstep_freq_of_position(n0, p0)) if cyclic else y


def half_err(got, want):
    """Largest error of a half-spectrum pair ``got`` (last axis possibly
    padded) against complex128 ``want``, relative to max |want|."""
    h = want.shape[-1]
    return spectrum_err((got[0][..., :h], got[1][..., :h]), want)


def batched_fields(gen, shape):
    """examples/insitu_rfft_batched.py's fields at ``shape`` = (B, N0, N1):
    field b is sin(2πk(x + 2y)/N0)/k, k = b + 2, plus noise of std 0.5
    from ``gen``; made on the card."""
    import torch
    b, n0, n1 = shape
    yy = torch.arange(n0, device="cuda", dtype=torch.float32)[:, None]
    xx = torch.arange(n1, device="cuda", dtype=torch.float32)[None, :]
    k = torch.arange(2, 2 + b, device="cuda", dtype=torch.float32)
    # the phase reduced mod N0 in integers first: float32 angles of
    # 2π·k·(x + 2y) lose their digits at N0 = 8192
    idx = (xx + 2 * yy).to(torch.int64)
    phase = (k.to(torch.int64)[:, None, None] * idx) % n0
    clean = torch.sin(2 * math.pi * phase.double() / n0).float() \
        / k[:, None, None]
    noise = torch.randn(shape, generator=gen, device="cuda")
    return clean, clean + 0.5 * noise


def batched_real_chain(mesh, gen, counters, shapes):
    """The ``insitu_rfft_batched`` workload at full width: BATCH_FIELDS
    real fields a step through one batched r2c/c2r plan pair
    (``real=True``, ``batch_ndim=1``), two steps; every field's MSE must
    improve, and the second step must be served from the plan cache."""
    import torch
    from repro_torch.core.fft.plan import plan_cache_stats
    from repro_torch.core.insitu.bridge import BridgeData, GridMeta
    from repro_torch.core.insitu.config import build_chain
    clean, fields = batched_fields(gen, BATCH_FIELDS)
    grid = GridMeta(BATCH_FIELDS[1:])
    cfg = {"mode": "insitu", "chain": [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "real": True, "batch_ndim": 1},
        {"endpoint": "bandpass", "array": "field",
         "keep_frac": BATCH_KEEP_FRAC, "use_kernel": False},
        {"endpoint": "fft", "array": "field", "direction": "backward",
         "real": True, "batch_ndim": 1}]}
    steps = []
    for step in (0, 1):
        before = plan_cache_stats()
        zero_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        chain = build_chain(cfg, mesh=mesh, grid=grid)
        with recording_fft_shapes(shapes):
            out = chain.execute(BridgeData(arrays={"field": fields},
                                           grid=grid))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        after = plan_cache_stats()
        den = out.arrays["field"]
        mse0 = ((fields - clean) ** 2).mean(dim=(1, 2)).tolist()
        mse1 = ((den - clean) ** 2).mean(dim=(1, 2)).tolist()
        steps.append({"step": step, "wall_s": wall,
                      "launches": launch_counts(counters),
                      "new_plans": after["misses"] - before["misses"],
                      "plan_hits": after["hits"] - before["hits"],
                      "mse0": mse0, "mse1": mse1, "peak_memory_bytes": peak,
                      "finite": bool(torch.isfinite(den).all())})
        del out, den
    res = {"phase": "batched_real_chain", "fields": list(BATCH_FIELDS),
           "input_bytes": fields.numel() * 4, "keep_frac": BATCH_KEEP_FRAC,
           "steps": steps}
    emit(res)
    for st in steps:
        assert st["finite"], st
        assert all(a < b for a, b in zip(st["mse1"], st["mse0"])), st
        assert st["launches"]["fft_fourstep"] > 0, st
    assert steps[0]["new_plans"] == 2 and steps[1]["new_plans"] == 0, steps
    del clean, fields
    torch.cuda.empty_cache()
    return res


def real_one_rank(counters, gen, shapes):
    """The r2c/c2r plans on a one-rank mesh at full size, through
    ``plan_rfft`` with the default backend (the kernels): forward and
    back, each against float64 (torch.fft on the card), with host ms,
    device busy ms of runs queued behind a spin kernel, the idle share,
    launches and peak memory."""
    import torch
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft.plan import BACKWARD, FORWARD, plan_rfft
    out = {}
    for decomp, mshape, grid, must in REAL_ONE_RANK:
        mesh = make_mesh(mshape, ("data", "model")[:len(mshape)])
        x = torch.randn(grid, generator=gen, device="cuda")
        fwd = plan_rfft(grid, FORWARD, mesh, decomp=decomp)
        bwd = plan_rfft(grid, BACKWARD, mesh, decomp=decomp)
        bwd.execute(*fwd.execute(x))               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = {"phase": "real_one_rank", "decomp": decomp,
               "mesh": list(mshape), "grid": list(grid),
               "schedule": fwd.schedule().name, "backend": fwd.backend,
               "tol_vs_f64": FFT_TOL_F64}
        zero_counts(counters)
        t0 = time.perf_counter()
        with recording_fft_shapes(shapes):
            y = fwd.execute(x)
        torch.cuda.synchronize()
        res["forward_host_ms"] = (time.perf_counter() - t0) * 1e3
        res["forward_launches"] = launch_counts(counters)
        zero_counts(counters)
        t0 = time.perf_counter()
        with recording_fft_shapes(shapes):
            back = bwd.execute(*y)
        torch.cuda.synchronize()
        res["backward_host_ms"] = (time.perf_counter() - t0) * 1e3
        res["backward_launches"] = launch_counts(counters)
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        res["half_extent"] = y[0].shape[-1]
        res["forward_rel_err_vs_f64"] = half_err(
            y, real_layout_oracle(x.double(), decomp, 1))
        want = torch.fft.irfftn(torch.complex(
            y[0][..., :grid[-1] // 2 + 1].double(),
            y[1][..., :grid[-1] // 2 + 1].double()), s=grid)
        res["backward_rel_err_vs_f64"] = float(
            (back.double() - want).abs().max() / want.abs().max())
        res["round_trip_max_abs_err"] = float((back - x).abs().max())
        del want, back
        res["steps_recorded"] = PROFILE_REPS
        for tag, fn in (("forward", lambda: fwd.execute(x)),
                        ("backward", lambda: bwd.execute(*y))):
            t0 = time.perf_counter()
            for _ in range(PROFILE_REPS):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_REPS
            busy = queued_device_ms(fn, PROFILE_REPS)
            res[tag + "_wall_ms"] = wall_ms
            res[tag + "_device_busy_ms"] = busy
            res[tag + "_device_idle_share"] = 1.0 - busy / wall_ms
        emit(res)
        launched = {k: res["forward_launches"][k]
                    + res["backward_launches"][k] for k in must}
        assert all(launched.values()), (decomp, launched)
        assert res["forward_rel_err_vs_f64"] < FFT_TOL_F64, res
        assert res["backward_rel_err_vs_f64"] < FFT_TOL_F64, res
        out[decomp] = res
        del x, y
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recording_sweep_times(seen: list):
    """While active, append to ``seen`` each candidate the measured sweeps
    time (its knobs and seconds a call, the planner's own reading)."""
    from repro_torch.core.fft import plan as P
    time_plan = P._time_plan

    def rec(plan, args, iters=3):
        t = time_plan(plan, args, iters)
        seen.append({"decomp": plan.decomp, "backend": plan.backend,
                     "overlap_chunks": plan.overlap_chunks,
                     "wire_dtype": plan.wire_dtype, "real": plan.real,
                     "ms": t * 1e3})
        return t

    P._time_plan = rec
    try:
        yield seen
    finally:
        P._time_plan = time_plan


def measured_one_card(shapes):
    """``backend="measure"`` on a one-rank mesh at full size: every
    variant's time, the winner and the recorded skips (where the hand
    kernels lose to torch.fft is the sweep's own reading). Then the
    winner is held against float64."""
    import torch
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft import plan as P
    out = []
    for decomp, mshape, grid in MEASURE_ONE_CARD:
        mesh = make_mesh(mshape, ("data", "model")[:len(mshape)])
        P.plan_cache_clear()
        times = []
        t0 = time.perf_counter()
        with recording_sweep_times(times), recording_fft_shapes(shapes):
            plan = P.plan_dft(grid, "forward", mesh, decomp=decomp,
                              backend="measure")
        sweep_s = time.perf_counter() - t0
        z = torch.complex(torch.randn(grid, device="cuda"),
                          torch.randn(grid, device="cuda"))
        y = plan.execute(z.real.contiguous(), z.imag.contiguous())
        err = spectrum_err(y, torch.fft.fftn(z.to(torch.complex128)))
        res = {"phase": "measured_one_card", "decomp": decomp,
               "grid": list(grid), "sweep_s": sweep_s, "variants": times,
               "winner": {"backend": plan.backend,
                          "overlap_chunks": plan.overlap_chunks,
                          "wire_dtype": plan.wire_dtype},
               "winner_rel_err_vs_f64": err,
               "skips": [{k: v for k, v in sk.items()
                          if k not in ("shape", "direction", "decomp",
                                       "real", "batch_ndim")}
                         for sk in P.autotune_skips()],
               "stats": P.plan_cache_stats()}
        emit(res)
        tol = FFT_TOL_F64 if plan.wire_dtype is None else WIRE_TOL
        assert err < tol, res
        assert {v["backend"] for v in times} == {"pallas", "jnp"}, times
        out.append(res)
        del z, y
    P.plan_cache_clear()
    torch.cuda.empty_cache()
    return out


def endcap_times():
    """The r2c/c2r endcaps' torch.fft calls (the one library FFT on the
    real path, where the reference calls jnp.fft) at the real chains'
    grids: CUDA-event ms, device busy ms of 10 calls queued behind a spin
    kernel (the profiler's trace lost launches of these), and their byte
    bound."""
    import torch
    out = []
    for n0, n1 in REAL_CHAIN_DIMS:
        x = torch.randn((n0, n1), device="cuda")
        z = torch.fft.rfft(x, dim=-1)
        h = n1 // 2 + 1
        for name, fn, nbytes in (
                ("rfft", lambda: torch.fft.rfft(x, dim=-1),
                 4 * n0 * n1 + 8 * n0 * h),
                ("irfft", lambda: torch.fft.irfft(z, n=n1, dim=-1),
                 8 * n0 * h + 4 * n0 * n1)):
            ms = time_ms(fn)
            bound_ms, by = bound(fft_flops(n1) / 2 * n0, nbytes)
            out.append({"endcap": name, "shape": [n0, n1], "events_ms": ms,
                        "device_busy_ms": queued_device_ms(fn, 10),
                        "bound_ms": bound_ms, "bound_by": by})
        del x, z
    emit({"phase": "real_endcaps", "rows": out})
    return out


def pipelined_ranks(rank, mesh, counters, record, store):
    """The pipelined chain on the four ranks (a part of ``rank_worker``):
    the Fig. 2 chain with a writer on the (4,) slab at RANK_CHAIN_DIMS,
    RANK_PIPE_FIELDS fields against a queue of PIPE_DEPTH, each field
    bit-identical to the insitu chain's on the same ranks, the files on
    rank 0 only, in step order. The writer gathers on the chain's own
    process group from the pipeline worker while the producer runs the
    next field's exchanges."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.fft.plan import FORWARD, plan_dft
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.config import build_chain
    dims = RANK_CHAIN_DIMS
    spec = plan_dft(dims, FORWARD, mesh, decomp="slab").schedule().in_spec
    src = RadiatingSourceAdaptor(dims, mesh=mesh, spec=spec)
    fields = [src.produce(s) for s in range(1, RANK_PIPE_FIELDS + 1)]

    def chain_for(mode):
        return build_chain({"mode": mode, "pipeline_depth": PIPE_DEPTH,
                            "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": "slab"},
            {"endpoint": "bandpass", "keep_frac": KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": "slab"},
            {"endpoint": "writer",
             "out_dir": str(Path(store).parent / f"pipe_{mode}")},
        ]}, mesh=mesh, grid=src.grid)

    insitu = chain_for("insitu")
    dist.barrier()
    t0 = time.perf_counter()
    want = [insitu.execute(f).arrays["field"] for f in fields]
    insitu_wall = time.perf_counter() - t0
    insitu.finalize()
    piped = chain_for("pipelined")
    zero_counts(counters)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [piped.execute(f) for f in fields]
    piped.drain(timeout=RANK_TIMEOUT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    pipe = piped.marshaling_report()["pipeline"]
    files = [Path(f).name for f in piped.finalize()["writer"]["files"]]
    same = all(torch.equal(o.arrays["field"], w)
               for o, w in zip(outs, want))
    r = record(check="pipelined_chain", decomp="slab", mesh="(4,)",
               dims=list(dims), fields=RANK_PIPE_FIELDS, depth=PIPE_DEPTH,
               wall_s=wall, insitu_wall_s=insitu_wall, launches=launches,
               bit_identical_to_insitu=same, files=files,
               queue_depth_max=pipe["queue_depth_max"],
               wait_s=pipe["wait_s"], backpressure_s=pipe["backpressure_s"],
               host_busy_s=pipe["host_busy_s"], dropped=pipe["dropped"],
               error=pipe["error"])
    assert same and pipe["error"] is None, r
    expect = [f"field_{s:06d}.npy" for s in range(1, RANK_PIPE_FIELDS + 1)]
    assert files == (expect if rank == 0 else []), r
    assert launches["fft_fourstep"] and launches["bandpass_filter"], r
    del outs, want, fields


def pipelined_chain(mesh, counters, dims, real, fields, out_dir):
    """One (grid, real) of the pipelined chain on the card: the insitu
    chain over ``fields[1:]`` (after ``fields[0]`` as its warm-up), then
    the pipelined chain over the same fields (after a warm-up of three
    executes of ``fields[0]``: the first field, the device-probe wait,
    and a steady-state execute queued behind a spin kernel, which must
    return while the spin still runs). Each pipelined field is held
    bit-identical to the insitu field and against the float64 oracle
    (torch.fft in complex128 on the card); the files must come in step
    order; each field launches what an insitu step launches."""
    import torch
    from repro_torch.core.fft.filters import lowpass_mask
    from repro_torch.core.insitu.config import build_chain
    warm, fields = fields[0], fields[1:]

    def chain_for(mode):
        cfg = chain_config(mode, real, out_dir / mode)
        cfg["pipeline_depth"] = PIPE_DEPTH
        return build_chain(cfg, mesh=mesh, grid=warm.grid)

    def drop_warmup(chain):
        writer = chain.endpoints[-1]
        for f in writer.written:
            Path(f).unlink(missing_ok=True)
        writer.written.clear()

    def run(chain):
        """The timed fields: per-field host ms of ``execute`` (what the
        producer pays), the wall to the last host effect, launches and
        the run's own peak memory."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        outs, ms = [], []
        t0 = time.perf_counter()
        for f in fields:
            t1 = time.perf_counter()
            outs.append(chain.execute(f))
            ms.append((time.perf_counter() - t1) * 1e3)
        chain.drain(timeout=ENGINE_TIMEOUT_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"outs": outs, "execute_ms": ms,
                "wall_ms_per_field": wall * 1e3 / len(fields),
                "launches": launch_counts(counters),
                "peak_bytes": torch.cuda.max_memory_allocated() - base}

    insitu = chain_for("insitu")
    insitu.execute(warm)
    drop_warmup(insitu)
    ins = run(insitu)
    insitu_files = insitu.finalize()["writer"]["files"]

    piped = chain_for("pipelined")
    piped.execute(warm)           # first field: masks, plans, allocations
    piped.execute(warm)           # the device-probe wait
    piped.drain(timeout=ENGINE_TIMEOUT_S)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * PIPE_SPIN_S))
    spin = torch.cuda.Event()
    spin.record()
    t1 = time.perf_counter()
    piped.execute(warm)
    spin_execute_ms = (time.perf_counter() - t1) * 1e3
    returned_before_spin = not spin.query()
    piped.drain(timeout=ENGINE_TIMEOUT_S)
    drop_warmup(piped)
    piped.reset_stats()
    pip = run(piped)
    pipe = piped.marshaling_report()["pipeline"]
    files = [Path(f).name for f in piped.finalize()["writer"]["files"]]

    same = all(torch.equal(a.arrays["field"], b.arrays["field"])
               for a, b in zip(pip["outs"], ins["outs"]))
    mask = lowpass_mask(dims, KEEP_FRAC).to("cuda", torch.float64)
    errs, ratios = [], []
    for f, out in zip(fields, pip["outs"]):
        noisy = f.arrays["field"].double()
        clean = f.arrays["clean_reference"].double()
        want = torch.fft.ifft2(torch.fft.fft2(noisy) * mask).real
        got = out.arrays["field"].double()
        errs.append(float((got - want).abs().max()))
        ratios.append(float(((got - clean) ** 2).mean()
                            / ((noisy - clean) ** 2).mean()))
        del noisy, clean, want, got
    steps = [f.step for f in fields]
    res = {"phase": "pipelined_chain", "dims": list(dims), "real": real,
           "fields": len(fields), "depth": PIPE_DEPTH,
           "bit_identical_to_insitu": same,
           "field_max_abs_err_vs_f64": max(errs), "field_tol": FIELD_TOL,
           "mse1_over_mse0_max": max(ratios),
           "files": files,
           "insitu_wall_ms_per_field": ins["wall_ms_per_field"],
           "pipelined_wall_ms_per_field": pip["wall_ms_per_field"],
           "insitu_execute_ms": ins["execute_ms"],
           "pipelined_dispatch_ms": pip["execute_ms"],
           "pipelined_dispatch_ms_median": statistics.median(
               pip["execute_ms"]),
           "insitu_execute_ms_median": statistics.median(ins["execute_ms"]),
           "wait_s": pipe["wait_s"],
           "backpressure_s": pipe["backpressure_s"],
           "host_busy_s": pipe["host_busy_s"],
           "device_probe_s": pipe["device_probe_s"],
           "overlap_efficiency": pipe["overlap_efficiency"],
           "queue_depth_max": pipe["queue_depth_max"],
           "insitu_peak_bytes": ins["peak_bytes"],
           "pipelined_peak_bytes": pip["peak_bytes"],
           "insitu_launches": ins["launches"],
           "pipelined_launches": pip["launches"],
           "spin_ms": PIPE_SPIN_S * 1e3,
           "execute_ms_behind_spin": spin_execute_ms,
           "returned_while_spin_pending": returned_before_spin}
    emit(res)
    assert same, res
    assert max(errs) < FIELD_TOL and max(ratios) < 0.5, res
    assert files == [f"field_{s:06d}.npy" for s in steps], res
    assert [Path(f).name for f in insitu_files] == files, res
    assert pip["launches"] == ins["launches"], res
    if (dims, real) == ((8192, 8192), False):
        for k, n in PIPE_8192_LAUNCHES.items():
            assert pip["launches"][k] == n * len(fields), res
    assert returned_before_spin, res
    assert pipe["error"] is None and pipe["completed"] == len(fields), res
    del pip, ins
    return res


def pipelined_chains(mesh, counters, out_dir):
    """Phase 7a: every PIPE_CHAINS configuration, fields made once per
    grid (the warm-up at step 0, then steps 1..PIPE_FIELDS, on
    PIPE_PRODUCERS threads) and shared by the complex and the real
    chain."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    out, made = [], {}
    try:
        for dims, real in PIPE_CHAINS:
            if dims not in made:
                made.clear()
                t0 = time.perf_counter()
                src = RadiatingSourceAdaptor(dims, mesh=mesh)
                with ThreadPoolExecutor(PIPE_PRODUCERS) as pool:
                    made[dims] = list(pool.map(src.produce,
                                               range(PIPE_FIELDS + 1)))
                emit({"phase": "pipelined_fields", "dims": list(dims),
                      "seconds": time.perf_counter() - t0})
            out.append(pipelined_chain(mesh, counters, dims, real,
                                       made[dims], out_dir))
            shutil.rmtree(out_dir, ignore_errors=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return out


def engine_trace(counters):
    """Phase 7b: the FFT serving engine on a one-rank CUDA mesh, the
    reference's serving harness at full size: the trace served
    prewarmed, one request an execute (max_batch=1), then continuously
    batched (max_batch=8) from ENGINE_CLIENTS client threads; every
    answer against float64."""
    import threading

    import numpy as np
    import torch
    from repro_torch.core.fft.filters import lowpass_mask
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.fft_engine import FFTServeEngine
    mesh = make_host_mesh()
    rng = np.random.default_rng(0)
    traffic = []
    for k in range(ENGINE_REQUESTS):
        shape = ENGINE_SHAPES[k % len(ENGINE_SHAPES)]
        kw = ENGINE_OPS[(k // len(ENGINE_SHAPES)) % len(ENGINE_OPS)]
        x = rng.standard_normal(shape).astype(np.float32)
        traffic.append((x if kw.get("real") else x.astype(np.complex64),
                        kw))
    signatures = {}
    for payload, kw in traffic:
        signatures.setdefault((payload.shape, payload.dtype.str,
                               tuple(sorted(kw.items()))),
                              {"shape": payload.shape, **kw})

    def replay(max_batch, threaded):
        eng = FFTServeEngine(mesh, max_batch=max_batch,
                             max_pending=ENGINE_REQUESTS, linger_s=0.002)
        prewarm = eng.prewarm(list(signatures.values()))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        futs = [None] * len(traffic)
        t0 = time.perf_counter()
        if threaded:
            per = -(-len(traffic) // ENGINE_CLIENTS)

            def client(lo):
                for i in range(lo, min(lo + per, len(traffic))):
                    payload, kw = traffic[i]
                    futs[i] = eng.submit(payload, **kw)

            ts = [threading.Thread(target=client, args=(i * per,),
                                   daemon=True)
                  for i in range(ENGINE_CLIENTS)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=ENGINE_TIMEOUT_S)
                assert not t.is_alive(), "a client thread hung"
            eng.start()
            eng.drain(timeout=ENGINE_TIMEOUT_S)
        else:
            for i, (payload, kw) in enumerate(traffic):
                futs[i] = eng.submit(payload, **kw)
                eng.step(force=True)
            eng.drain(timeout=ENGINE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        rep = eng.report()
        launches = launch_counts(counters)
        peak = torch.cuda.max_memory_allocated() - base
        eng.stop()
        answers = [f.result(timeout=ENGINE_TIMEOUT_S) for f in futs]
        return {"max_batch": max_batch, "threaded": threaded,
                "wall_s": wall, "throughput_rps": len(traffic) / wall,
                "latency_ms": rep["latency_ms"],
                "executes": rep["batching"]["executes"],
                "batched_execute_ratio":
                    rep["batching"]["batched_execute_ratio"],
                "padded_rows": rep["batching"]["padded_rows"],
                "queue_depth_max": rep["queue"]["depth_max"],
                "completion_wait_s": rep["queue"]["completion"]["wait_s"],
                "peak_bytes": peak, "launches": launches,
                "prewarm": {k: prewarm[k] for k in ("requests", "wall_s",
                                                    "errors")},
                "failed": rep["requests"]["failed"]}, answers

    def errors(answers):
        """Largest error of each op's answers against float64."""
        worst = {}
        for (payload, kw), got in zip(traffic, answers):
            x = torch.from_numpy(payload).to("cuda", torch.complex128)
            if kw["op"] == "fft":
                want = (torch.fft.rfftn(x.real) if kw.get("real")
                        else torch.fft.fftn(x))
                name = "r2c_fft" if kw.get("real") else "c2c_fft"
            else:
                m = lowpass_mask(payload.shape, kw["keep_frac"]).to(
                    "cuda", torch.float64)
                want = torch.fft.ifftn(torch.fft.fftn(x) * m).real
                name = "r2c_bandpass"
            g = torch.from_numpy(np.asarray(got)).to("cuda")
            assert tuple(g.shape) == tuple(want.shape), (name, g.shape)
            err = float((g.to(want.dtype) - want).abs().max()
                        / want.abs().max())
            worst[name] = max(worst.get(name, 0.0), err)
        return worst

    sequential, seq_answers = replay(1, False)
    sequential["max_rel_err"] = errors(seq_answers)
    del seq_answers
    batched, answers = replay(8, True)
    batched["max_rel_err"] = errors(answers)
    del answers
    res = {"phase": "fft_engine", "requests": ENGINE_REQUESTS,
           "clients": ENGINE_CLIENTS,
           "shapes": [list(s) for s in ENGINE_SHAPES],
           "ops": list(ENGINE_OPS), "sequential": sequential,
           "batched": batched,
           "batched_beats_sequential": batched["wall_s"]
           < sequential["wall_s"],
           "tol": {"fft": ENGINE_FFT_TOL, "bandpass": ENGINE_BANDPASS_TOL}}
    emit(res)
    for run in (sequential, batched):
        assert run["failed"] == 0 and not run["prewarm"]["errors"], run
        for name, err in run["max_rel_err"].items():
            tol = ENGINE_BANDPASS_TOL if "bandpass" in name \
                else ENGINE_FFT_TOL
            assert err < tol, (name, err, run)
    assert batched["executes"] < ENGINE_REQUESTS, batched
    assert batched["launches"]["fft_fourstep"] > 0, batched
    assert batched["launches"]["fft_stockham"] > 0, batched
    return res


def monitored_serve(cfg, params, unmonitored, counters, out_dir):
    """Phase 7c: ``serve.main`` with the pipelined logits monitor on
    qwen3-4b at full width and depth, on ``serve_path``'s parameters:
    the same tokens as the unmonitored run, one flash launch a layer,
    the monitor's executes and files, and the written statistics against
    float64 statistics of the last-token logits the decode loop handed
    the engine (captured at ``FFTServeEngine.submit``)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.serve import fft_engine
    captured = []
    submit = fft_engine.FFTServeEngine.submit

    def capture(self, payload, **kw):
        if kw.get("bucket") == "monitor":
            captured.append(payload)
        return submit(self, payload, **kw)

    shutil.rmtree(out_dir, ignore_errors=True)
    zero_counts(counters)
    fft_engine.FFTServeEngine.submit = capture
    try:
        report = serve.main([
            "--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--tokens",
            str(SERVE_TOKENS), "--seed", "0", "--bench-out", "",
            "--monitor-every", str(MONITOR_EVERY), "--monitor-batch",
            str(MONITOR_BATCH), "--monitor-dir", str(out_dir)],
            params=params)
    finally:
        fft_engine.FFTServeEngine.submit = submit
    launches = {k: fn.launches for k, fn in counters.items()}
    files = sorted(out_dir.glob("logit_stats_*.npy"))
    turns = []
    errs = []
    for k, path in enumerate(files):
        x = torch.stack(captured[k * MONITOR_BATCH:(k + 1) * MONITOR_BATCH]
                        ).double()
        want = torch.stack([x.min(), x.max(), x.mean(),
                            x.std(correction=0),
                            torch.sqrt((x * x).mean())]).cpu().numpy()
        got = np.load(path).astype(np.float64)
        errs.append(float(np.abs(got - want).max() / np.abs(want).max()))
    shutil.rmtree(out_dir, ignore_errors=True)
    for monitor in MONITOR_TURNS:
        flags = (["--monitor-every", str(MONITOR_EVERY), "--monitor-batch",
                  str(MONITOR_BATCH), "--monitor-dir", str(out_dir)]
                 if monitor else [])
        r = serve.main([
            "--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--tokens",
            str(SERVE_TOKENS), "--seed", "0", "--bench-out", "", *flags],
            params=params)
        turns.append({"monitor": monitor, "sample": r["sample"],
                      "decode_ms_per_token": r["decode_ms_per_token"]})
        shutil.rmtree(out_dir, ignore_errors=True)
    mon = report["monitor"]
    res = {"phase": "monitored_serve", "arch": SERVE_ARCH,
           "monitor_every": MONITOR_EVERY, "monitor_batch": MONITOR_BATCH,
           "sample": report["sample"],
           "unmonitored_sample": unmonitored["sample"],
           "decode_ms_per_token": report["decode_ms_per_token"],
           "unmonitored_decode_ms_per_token":
               unmonitored["decode_ms_per_token"],
           "prefill_ms": report["prefill_ms"],
           "turns": turns,
           "turns_median_decode_ms_per_token": {
               k: statistics.median(t["decode_ms_per_token"] for t in turns
                                    if t["monitor"] == m)
               for k, m in (("unmonitored", False), ("monitored", True))},
           "launches": launches, "snapshots_captured": len(captured),
           "files": len(files), "stats_rel_err": errs,
           "stats_tol": MONITOR_TOL, "monitor": mon}
    emit(res)
    assert report["sample"] == unmonitored["sample"], res
    assert all(t["sample"] == unmonitored["sample"] for t in turns), res
    assert launches["flash_attention"] == cfg.num_layers, res
    snapshots = -(-SERVE_TOKENS // MONITOR_EVERY)
    assert mon["snapshots"] == snapshots == len(captured), res
    assert mon["submits"] == len(files) == \
        -(-snapshots // MONITOR_BATCH) == mon["files"], res
    assert errs and max(errs) < MONITOR_TOL, res
    return res


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
    # N = 1 and 2, as rows and as columns (the length-1 and length-2
    # passes of pencil_tf and fourstep1d), on the Stockham kernel that
    # ops.fft picks for them, against its plain version
    tiny = ([check_fft("fft_stockham", fft_stockham, dft.stockham_fft, s,
                       gen) for s in ((4096, 1), (4096, 2))]
            + [check_fft_columns("fft_stockham", fft_stockham_columns,
                                 dft.stockham_fft, s, gen)
               for s in ((1, 1 << 20), (2, 1 << 20))])
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
    # the real chain (r2c/c2r endpoints) at the same grids, against the
    # same oracle: its launches apart, and every FFT shape it gives the
    # kernels (half-width columns) for the shape checks below
    real_launches = {}
    chains, real_chains = {}, {}
    real_shapes = set()
    try:
        for dims, modes, must_run in sizes:
            expected = oracle(dims)
            launches[dims] = dict.fromkeys(
                ("fft_fourstep", "fft_stockham", "bandpass_filter",
                 "fft_fourstep_columns", "fft_stockham_columns"), 0)
            for mode in modes:
                res = run_chain(dims, mode, mesh, expected, out_dir)
                chains[(dims, mode)] = res
                for k in must_run:
                    assert res["launches"][k] > 0, (dims, mode, k)
                for k, v in res["launches"].items():
                    launches[dims][k] += v
                if dims in ((8192, 8192), (10000, 10000)):
                    assert res["mse1"] < 0.5 * res["mse0"], res
            if dims in REAL_CHAIN_DIMS:
                real_launches[dims] = dict.fromkeys(launches[dims], 0)
                for mode in both:
                    res = run_chain(dims, mode, mesh, expected, out_dir,
                                    real=True, shapes=real_shapes)
                    real_chains[(dims, mode)] = res
                    for k in four:
                        assert res["launches"][k] > 0, (dims, mode, k)
                    for k, v in res["launches"].items():
                        real_launches[dims][k] += v
            del expected
            shutil.rmtree(out_dir, ignore_errors=True)
        for dims in ((8192, 8192), (10000, 10000), (200, 200)):
            profiles[dims] = profile_chain(dims, mesh, out_dir)
        # the 10000^2 step: no copy kernel, and the mixed-radix kernel
        names = [k["name"] for k in profiles[(10000, 10000)]["by_kernel_ms"]]
        assert not [n for n in names if "copy" in n.lower()], names
        assert any("mixed_lines_kernel" in n for n in names), names
        real_profiles = {dims: profile_chain(dims, mesh, out_dir, real=True)
                         for dims in REAL_CHAIN_DIMS}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "real_vs_complex_chain", "rows": [
        {"dims": list(dims), "mode": mode,
         "complex_wall_s": chains[(dims, mode)]["wall_s"],
         "real_wall_s": r["wall_s"],
         "complex_peak_memory_bytes":
         chains[(dims, mode)]["peak_memory_bytes"],
         "real_peak_memory_bytes": r["peak_memory_bytes"],
         "real_device_busy_ms": real_profiles[dims]["device_busy_ms"]
         if mode == "insitu" else None,
         "complex_device_busy_ms": profiles[dims]["device_busy_ms"]
         if mode == "insitu" else None}
        for (dims, mode), r in real_chains.items()]})

    # 4b. the distributed path: one rank at full size, then four ranks
    # sharing the card
    fft_counters = {"fft_fourstep": ops.fft_fourstep,
                    "fft_stockham": ops.fft_stockham,
                    "bandpass_filter": ops.bandpass_filter}
    t0 = time.perf_counter()
    dist_shapes = set()
    one_rank = distributed_one_rank(fft_counters, gen, dist_shapes)
    emit({"phase": "distributed_one_rank_seconds",
          "seconds": time.perf_counter() - t0})
    ranks = distributed_ranks(ROOT / "build" / "chip_smoke_ranks")
    shutil.rmtree(ROOT / "build" / "chip_smoke_ranks", ignore_errors=True)
    # every FFT shape the distributed runs gave the kernels (one rank, and
    # each rank's blocks of the four-rank runs), against the plain versions
    for r in ranks:
        dist_shapes.update(tuple(v) for v in r.pop("fft_shapes"))
    t0 = time.perf_counter()
    dist_checks = check_path_shapes(dist_shapes, gen)
    emit({"phase": "distributed_shape_checks", "shapes": len(dist_checks),
          "seconds": time.perf_counter() - t0})

    # 4c. the real paths beyond the chain: the batched real chain, the
    # r2c/c2r plans on one rank, measured planning, the endcaps' cuFFT
    # times; then every FFT shape they gave the kernels, and the
    # half-width column shapes timed on their own
    t0 = time.perf_counter()
    batched = batched_real_chain(mesh, gen, fft_counters, real_shapes)
    real_plans = real_one_rank(fft_counters, gen, real_shapes)
    measured = measured_one_card(real_shapes)
    endcaps = endcap_times()
    half_cols = [check_fft_columns("fft_fourstep", fft_fourstep_columns,
                                   dft.fourstep_fft, shape, gen)
                 for shape in HALF_COLUMNS]
    # device busy ms of the kernel and of torch.fft at these shapes, from
    # 10 calls queued behind a spin kernel: the profiler's trace lost
    # torch.fft's launches here (its device ms fell below the byte bound)
    for r in half_cols:
        re = torch.randn(r["shape"], generator=gen, device="cuda")
        im = torch.randn(r["shape"], generator=gen, device="cuda")
        v3 = (1,) + tuple(r["shape"])
        z = torch.complex(re, im)
        r["busy_ms"] = queued_device_ms(
            lambda: fft_fourstep_columns(re.view(v3), im.view(v3)), 10)
        r["library_busy_ms"] = queued_device_ms(
            lambda: torch.fft.fft(z, dim=-2), 10)
        emit({"phase": "half_width_columns", "shape": r["shape"],
              "busy_ms": r["busy_ms"],
              "library_busy_ms": r["library_busy_ms"],
              "bound_ms": r["bound_ms"]})
        del re, im, z
    real_checks = check_path_shapes(real_shapes, gen)
    emit({"phase": "real_paths_seconds", "shapes": len(real_checks),
          "seconds": time.perf_counter() - t0})

    # 5. serve main path
    all_counters = {"fft_fourstep": ops.fft_fourstep,
                    "fft_stockham": ops.fft_stockham,
                    "bandpass_filter": ops.bandpass_filter,
                    "flash_attention": flash_attention}
    flash_launches, serve_report, serve_cfg, params = serve_path(
        all_counters)

    # 6. FFT rows past three passes of <= 439 points: 2^25 and 5^10 as
    # four mixed-radix passes, 2^24 + 1 on Bluestein (M = 2^26, four
    # passes); held against the float64 oracle and torch.fft only (the
    # plain four-step's float32 angles fail past 2^16). Last, because the
    # Bluestein tables stay cached (671 MB a direction for this N, one
    # direction at a time under the cap) and would count in the peaks
    # above
    long_rows = [check_fft("fft_fourstep", fft_fourstep, None, s, gen)
                 for s in ((1, 1 << 25), (1, 5 ** 10), (1, (1 << 24) + 1))]
    # the Bluestein tables are capped and go with plan_cache_clear()
    from repro_torch.core.fft.plan import plan_cache_clear
    from repro_torch.kernels import fft_fourstep as fourstep_mod
    torch.cuda.synchronize()
    tables = fourstep_mod.table_bytes()
    before = torch.cuda.memory_allocated()
    plan_cache_clear()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    emit({"phase": "bluestein_tables", "table_bytes": tables,
          "cap_bytes": fourstep_mod.CHIRP_CACHE_BYTES,
          "memory_allocated_before_clear": before,
          "memory_allocated_after_clear": after,
          "table_bytes_after_clear": fourstep_mod.table_bytes()})
    assert 0 < tables <= fourstep_mod.CHIRP_CACHE_BYTES, tables
    assert before - after >= tables, (before, after, tables)

    # 7. pipelined_and_engine: the pipelined chain on one card (its four
    # ranks ran in 4b, beside the other four-rank checks), the FFT
    # serving engine's trace, and the monitored serve on phase 5's
    # parameters
    t0 = time.perf_counter()
    pipelined = pipelined_chains(mesh, fft_counters,
                                 ROOT / "build" / "chip_smoke_pipe")
    engine = engine_trace(fft_counters)
    monitored = monitored_serve(serve_cfg, params, serve_report,
                                all_counters,
                                ROOT / "build" / "chip_smoke_monitor")
    del params
    rank_pipe = [c for c in ranks[0]["checks"]
                 if c["check"] == "pipelined_chain"]
    emit({"phase": "pipelined_and_engine",
          "seconds": time.perf_counter() - t0,
          "chains": [{k: r[k] for k in (
              "dims", "real", "insitu_wall_ms_per_field",
              "pipelined_wall_ms_per_field", "insitu_execute_ms_median",
              "pipelined_dispatch_ms_median", "wait_s", "backpressure_s",
              "overlap_efficiency", "queue_depth_max", "insitu_peak_bytes",
              "pipelined_peak_bytes", "execute_ms_behind_spin")}
              for r in pipelined],
          "four_ranks_rank0": rank_pipe,
          "engine": {k: {m: engine[k][m] for m in (
              "latency_ms", "throughput_rps", "batched_execute_ratio",
              "queue_depth_max", "peak_bytes", "executes")}
              for k in ("sequential", "batched")},
          "batched_beats_sequential": engine["batched_beats_sequential"],
          "monitored_decode_ms_per_token":
              monitored["decode_ms_per_token"],
          "unmonitored_decode_ms_per_token":
              monitored["unmonitored_decode_ms_per_token"],
          "decode_ms_per_token_in_turns":
              monitored["turns_median_decode_ms_per_token"],
          "monitor": monitored["monitor"]})

    def row(name, source, replaces, main, cols=None):
        dims = tuple(main["shape"])
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[dims][name],
               "launches_from": f"{dims[0]}x{dims[1]} main path, insitu + "
                                f"intransit; pipelined_launches: the "
                                f"pipelined chain ({PIPE_FIELDS} fields a "
                                f"grid); engine_launches: the FFT serving "
                                f"engine's trace",
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
        for r in fourstep + fourstep_cols + long_rows]

    def dist_launches(name):
        """A kernel's launches on the distributed path: each one-rank
        decomposition forward + backward, and rank 0's four-rank runs."""
        one = {d: r["forward_launches"][name] + r["backward_launches"][name]
               for d, r in one_rank.items()}
        four = {f"{c['check']} {c['decomp']} {c['mesh']}":
                c["launches"][name] for c in ranks[0]["checks"]
                if "launches" in c}
        return {"one_rank": one, "four_ranks_rank0": four}

    def shape_checks(name):
        """The distributed path's shapes checked on kernel ``name``."""
        return [{"shape": r["shape"], "axis": r.get("axis", -1),
                 "max_rel_err": max(r["max_rel_err"] or 0.0,
                                    r["inverse_max_rel_err"] or 0.0)
                 if r["plain_held"] else None,
                 "max_rel_err_vs_f64": max(r["rel_err_vs_f64"],
                                           r["inverse_rel_err_vs_f64"])}
                for r in dist_checks if r["kernel"] == name]

    def real_path_launches(name):
        """A kernel's launches on the real paths: each real chain size
        (insitu + intransit), each batched step, each one-rank r2c/c2r
        plan forward + backward, each measured sweep (every variant
        timed), and rank 0's four-rank real runs."""
        return {
            "real_chain": {f"{d[0]}x{d[1]}": real_launches[d][name]
                           for d in real_launches},
            "batched_real_chain": [st["launches"][name]
                                   for st in batched["steps"]],
            "real_one_rank": {d: r["forward_launches"][name]
                              + r["backward_launches"][name]
                              for d, r in real_plans.items()},
            "four_ranks_rank0": {
                f"{c['check']} {c['decomp']} {c['mesh']}":
                c["launches"][name] for c in ranks[0]["checks"]
                if c["check"] in ("real_transform", "real_chain")}}

    def real_shape_checks(name):
        """The real paths' shapes (one device) checked on kernel
        ``name``."""
        return [{"shape": r["shape"], "axis": r.get("axis", -1),
                 "max_rel_err": max(r["max_rel_err"] or 0.0,
                                    r["inverse_max_rel_err"] or 0.0)
                 if r["plain_held"] else None,
                 "max_rel_err_vs_f64": max(r["rel_err_vs_f64"],
                                           r["inverse_rel_err_vs_f64"])}
                for r in real_checks if r["kernel"] == name]

    def phase7_launches(name):
        """A kernel's launches on phase 7: each pipelined chain's fields
        (and the insitu run of the same fields), rank 0's four-rank
        pipelined chain, and the engine's two passes."""
        return {
            "pipelined_launches": {
                f"{r['dims'][0]}x{r['dims'][1]}"
                f"{' real' if r['real'] else ''}":
                {"pipelined": r["pipelined_launches"][name],
                 "insitu": r["insitu_launches"][name]}
                for r in pipelined},
            "four_ranks_pipelined_rank0": [c["launches"][name]
                                           for c in rank_pipe],
            "engine_launches": {k: engine[k]["launches"][name]
                                for k in ("sequential", "batched")}}

    csrc = "src/repro_torch/kernels/csrc/"
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        dict(row("fft_fourstep", csrc + "fft_fourstep.cu",
                 "src/repro/kernels/fft_fourstep.py:89", fourstep[0],
                 fourstep_cols[0]),
             routes=fourstep_routes,
             chain_launches={f"{d[0]}x{d[1]}": launches[d]["fft_fourstep"]
                             for d in launches},
             distributed_launches=dist_launches("fft_fourstep"),
             distributed_shapes=shape_checks("fft_fourstep"),
             real_launches=real_path_launches("fft_fourstep"),
             real_shapes=real_shape_checks("fft_fourstep"),
             **phase7_launches("fft_fourstep"),
             half_width_columns=[
                 {"shape": r["shape"], "axis": -2,
                  "route": r["column_route"], "lines": r["lines"],
                  "ms": r["kernel_ms"], "device_ms": r["device_ms"],
                  "busy_ms": r["busy_ms"], "library_ms": r["library_ms"],
                  "library_busy_ms": r["library_busy_ms"],
                  "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                  "max_abs_err": r["max_abs_err"],
                  "max_rel_err_vs_f64": max(r["rel_err_vs_f64"],
                                            r["inverse_rel_err_vs_f64"])}
                 for r in half_cols]),
        dict(row("fft_stockham", csrc + "fft_stockham.cu",
                 "src/repro/kernels/fft_stockham.py:64", stockham[0],
                 stockham_cols[0]),
             tiny_n=[{"shape": r["shape"], "axis": r.get("axis", -1),
                      "max_abs_err": r["max_abs_err"],
                      "device_ms": r["device_ms"]} for r in tiny],
             distributed_launches=dist_launches("fft_stockham"),
             distributed_shapes=shape_checks("fft_stockham"),
             real_launches=real_path_launches("fft_stockham"),
             real_shapes=real_shape_checks("fft_stockham"),
             **phase7_launches("fft_stockham")),
        dict(row("bandpass_filter", csrc + "bandpass.cu",
                 "src/repro/kernels/bandpass.py:53", bandpass[0]),
             device_ms=bandpass[0]["device_ms"],
             distributed_launches=dist_launches("bandpass_filter"),
             real_launches=real_path_launches("bandpass_filter"),
             **phase7_launches("bandpass_filter")),
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:95",
         "launches": flash_launches,
         "launches_from": f"{SERVE_ARCH} serve main path (one "
                          f"{SERVE_PROMPT}-token prefill, {SERVE_TOKENS} "
                          f"decode steps); monitored_serve_launches: the "
                          f"same serve with the pipelined logits monitor",
         "monitored_serve_launches": monitored["launches"][
             "flash_attention"],
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
    if "--rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        try:
            rank_worker(int(args["--rank"]), int(args["--world"]),
                        args["--store"])
        except BaseException:
            import traceback
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
        # every rank is past the last collective: leave without running
        # the process groups' destructors, whose gloo threads can abort
        # the process at interpreter exit after the work is done
        sys.stdout.flush()
        os._exit(0)
    sys.exit(main())
