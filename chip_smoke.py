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
    logits monitor (phase 7);
  * the M->N in-transit path (phase 8): producer and consumer meshes of
    ranks sharing the card, brought up by ``runtime.cluster`` from the
    REPRO_* env contract, the fields moved by ``TransitBridge``, and
    ``serve --transit-consumers 1``;
  * the pseudo-spectral solvers (phase 9): NS2D at 8192^2 and Boussinesq
    at 512^3 stepped on the card through the r2c/c2r plans, checkpoint
    and restart, four ranks on the card, and ``launch/solver.py`` in
    transit on three;
  * the elastic consumer mesh (phase 10): an ``ElasticController`` over
    four ranks on the card shrinks its consumer mesh on a dropped
    heartbeat and grows it back, and ``launch/solver.py --elastic`` runs
    on three;
  * serving the other six model configs (phase 11): the MoE decoders
    (grok-1, dbrx), the SSM and hybrid stacks (mamba2, zamba2), whisper's
    encoder-decoder and internvl2's VLM, at published widths, with the
    int8 KV cache; zamba2's shared block runs the flash kernel at
    head_dim 80 and whisper's cross-attention with 1500 keys against 64
    queries;
  * the training path (phase 12): qwen3-4b at full width through
    ``train/step.make_train_step`` under a one-rank sharding policy (no
    hand-written kernel runs there, as no Pallas kernel runs in the
    reference's), the 100m example, and ``launch/train.py``'s restart
    and transit runs;
  * the LM substrate across ranks (phase 13): qwen3-4b served and
    trained on a (2, 2) mesh of four ranks sharing the card, dbrx's MoE
    layer with two dispatch groups.

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
     float32 case with large logits that one TF32 product would fail,
     and at phase 11's two shapes past the reference's Pallas kernel
     (float32): zamba2's (4, 2048, 32, 32, 80) causal, and whisper's
     cross-attention, q (4, 64, 16, 64) against k/v (4, 1500, 16, 64),
     non-causal; and N = 1 and 2 as rows and columns against the plain Stockham
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
     real 8192²: 3 fields after a warm-up, each bit-identical to the
     insitu chain's on the same field and within 1e-4 of the float64
     oracle (mse1/mse0 < 0.5), the files in step order, the launches a
     field equal to an insitu step's, per-field wall ms and what the
     producer pays (``execute`` ms) beside insitu's, the pipeline's
     wait, backpressure, overlap efficiency, queue depth and peak
     memory; a steady-state ``execute`` queued behind a 50 ms spin kernel
     must return while the spin still runs (the producer never waits on
     the device). The four ranks (4b) also run the chain pipelined on the
     (4,) slab at 8192², 3 fields against depth 2, each bit-identical to
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
  8. transit — this script started four times (``--job transit``) with
     the REPRO_* env contract (``init_cluster``: gloo, the ranks share
     cuda:0), ``make_transit_meshes(2, 2)``: the producers make seeded
     radiating-source fields at 8192^2 on their (2,) mesh, 2 go by
     ``TransitBridge.send`` and 3 by ``send_async`` (depth 2), and the
     consumers run the Fig. 2 chain (keep_frac 0.05, insitu) on their
     (2,) slab with the writer on the consumer mesh's first rank. Every
     delivered block bit-identical (sha256) to the producer's block at
     its position; the first field's denoised field within 1e-4 of
     float64 and its energies within 1e-5; four-step and bandpass
     launches on the consumers and none on the producers; the transit
     report (fields, bytes, wall, the async block), each producer
     ``send_async``'s ms against the hop's, peak memory by rank. Then
     twice (``--job transit_serve``): ``serve.main --monitor-every 4
     --monitor-batch 4 --transit-consumers 1`` on qwen3-4b at full width
     and depth (rank 0 decodes on phase 5's seeded parameters, rank 1
     runs the monitor): phase 5's tokens, the monitor's files on rank 1
     only, prefill and decode ms beside phase 7's in-place monitored
     serve, the transit block;
  9. solver — ``core/solver`` on one card at full size: NS2D 8192^2
     (r2c slab, if_rk4) Taylor-Green (nu 0.1, dt 0.01, 20 steps) within
     1e-5 of E0 e^{-4 nu t}; a random field (seed 3), inviscid rk4, dt
     2e-3, 20 steps conserving energy and enstrophy within 1e-5 with sum
     E(k) = E within 1e-5, its first 5 steps through torch.fft
     (``backend="jnp"``, no kernel launched) within 1e-4 of max |w| of
     the kernels' steps; restart (4 steps, ``save``, ``restore`` into a
     fresh solver, 4 more) bit-identical to 8 straight steps; Boussinesq
     512^3 (r2c slab3d, if_rk4) Beltrami (nu 0.05, dt 0.01, 15 steps)
     within 1e-5 of E0 e^{-2 nu t}, and buoyancy from rest (gravity 1,
     5 steps) making kinetic energy. Per solver: ms a step (host clock to
     ``synchronize()``), device busy ms a step (steps queued behind a
     spin kernel, CUDA events), the idle share, launches a step by
     wrapper and by kernel symbol (profiler), device ms by kernel, peak
     ``max_memory_allocated``. Four ranks on the card over gloo
     (``--job solver_ranks``): NS2D 2048^2 on (4,) slab and (2, 2)
     pencil2d, Boussinesq 128^3 on (2, 2) pencil and pencil_tf, r2c and
     c2c, 3 steps each, each within 1e-4 of max |one-rank| of the same
     case run here. ``launch/solver.py`` on three ranks by the REPRO_*
     env contract (``--job solver_launch``, then ``solver_restore``):
     NS2D 2048^2, 10 steps, a report every 5, ``--transit-consumers 1
     --transit-async``, spectra on the consumer only, the final energy
     within 1e-5 of a one-rank run here, checkpoints every 5 steps on
     each producer; then ``--restore`` continues from step 10 to 20
     (Taylor-Green's closed form within 1e-5). Every FFT shape the
     solvers gave the kernels (recorded at ``kernels.ops``; the batched
     (4, 8192, 4097) columns and (9, 512, 512, 257) along axes 0 and 1
     among them) against the plain versions, torch.fft and float64;
  10. elastic — this script started four times (``--job elastic``) by
     the REPRO_* env contract, ``make_elastic_setup(2)`` (2 producers, a
     pool of 2 consumers) and the reference's chaos scenario
     (tests/test_elastic.py:497-600) at 8192^2 complex on a fresh wisdom
     file: a measured slab plan on the (2,) consumer mesh (cold: its
     seconds, candidates timed), 3 pending 2048^2 c2c engine requests,
     pool rank 0's heartbeats dropped from step 2, detected at step 3, a
     shrink to (1,) failing the 3 with MeshRescaled, a resubmit and the
     (1,) mesh's measured plan, a grow back to (2,) planned from wisdom
     (no candidate timed) with output bit-identical to generation 0's;
     every transform's block within 1e-4 of max |X| of float64 and its
     ms a call (host clock to ``synchronize()``); then one radiating-source
     field sent through the controller to the Fig. 2 chain on the grown
     mesh (against float64) and two engine requests batched across its
     two ranks; each rescale's ``wall_s``, launches and peak memory by
     rank. Then ``launch/solver.py --elastic --transit-consumers 2`` on
     three ranks (``--job elastic_solver``; phase 9's NS2D 2048^2, slab)
     against one rank here: the same final report and bit-identical
     spectra, on the first consumer only. Every FFT shape of the
     scenario against the plain versions, torch.fft and float64;
  11. lm_families — each config at its published width, float32, seeded
     weights made on the card, one line each: grok-1 and dbrx cut to 2
     layers (``dataclasses.replace(cfg, num_layers=2)``, listed as
     ``reduced``; 45.8 and 31.0 GB of weights), batch 2, a 2048-token
     prompt, 8 greedy tokens through ``lm.prefill``/``decode_step``;
     mamba2-1.3b (48 layers) and zamba2-2.7b (54) through ``serve.main``,
     batch 4, 2048 + 16; whisper-medium (24 + 24) on seeded frames (4,
     1500, 1024) and a 64-token decoder prompt, 16 tokens through
     ``encdec.prefill``/``decode_step``; internvl2-2b (24) on 256 seeded
     patch embeddings and 1792 text tokens, 16 tokens. Each line: prefill
     ms and decode ms/token (host clock to ``synchronize()``), peak
     ``max_memory_allocated``, launches by kernel (flash a prefill: 2, 2,
     0, 9 at head_dim 80, 72 = 24 encoder + 24 self + 24 cross, 24); the
     teacher-forced error, prefill(S) + one decode step against
     prefill(S + 1) (held at 1e-4 for whisper and internvl2; for the SSM
     stacks held at 2e-4 on their first 5 SSM layers and reported at full
     depth, with one SSM layer's sensitivity to a 1e-6 input change;
     reported for MoE, whose capacity depends on the token count); each
     flash call of a prefill against the plain version on its inputs
     (1e-4), and the prefill's logits on the kernel against the same
     prefill on the plain version (1e-4 of max |logit|; MoE on the
     kernel run's routing, replayed; reported for the SSM stacks). grok-1
     also runs one MoE layer at full width on 512 tokens, nothing
     dropped, against a loop over its experts (1e-4), twice,
     bit-identical; zamba2 the continuous batcher (4 slots, 6 requests),
     each request's tokens equal to its run alone in the same engine;
     internvl2 decodes 64 tokens from an empty int8 cache and a dense one
     (max |dlogit| under 0.05 / 0.544 of max |logit|, the reference's
     bar at its width; total variation < 0.01; the argmax and both
     caches' bytes reported);
  12. train — qwen3-4b at full width, depth cut to 8 of 36 layers
     (``dataclasses.replace(cfg, num_layers=8)``), batch 8 x 512, bf16
     compute, 10 steps of ``make_train_step`` with the gradient monitor
     every 5: losses, grad norms, ms a step, device busy ms (the
     kernels' device time in one profiled step) and share, the profiled
     kernels, peak memory, the monitor's spectra, and every kernel's launches
     (none). ``train_cpu_check``: one float32 step at 2 layers, full
     width, batch 1 x 64, the loss over 4 sequence chunks of 16, its
     loss and every gradient leaf against the CPU run of the same step
     (1e-4). ``train_100m_steps``: the 100m model alone, 10 steps timed
     to each loss and a profiled step's device time, as the main path.
     ``train_100m``: the example's 100m preset, 200 steps (loss
     down by more than 0.5, spectra written), run while ``train_procs``'s
     processes run (its threads, CPU seconds and load average beside the
     step time). ``train_procs``: six
     processes at once (``--job train_procs``):
     ``launch/train.py`` at 100m for 30 steps straight and with
     ``--fail-at 12 24 --ckpt-every 10``, with deterministic algorithms
     (bit-identical final checkpoints, held) and without (reported), and
     ``--transit-consumers 1 --transit-async`` on two ranks (spectra on
     the consumer only; both ranks' timelines: where each hop's time
     goes, and the producer's own overlap);
  13. lm_ranks — the LM substrate across ranks: four ranks on the card
     (``--job lm_ranks``, gloo over CUDA tensors) on the (2, 2)
     ``("data", "model")`` mesh under ``make_policy`` (TP over model,
     FSDP and DP over data). qwen3-4b at full width, 4 of 36 layers:
     served in float32 (batch 4 x 512, 8 greedy tokens; the gathered
     prefill logits and the teacher-forced decode logits within 1e-4 of
     max |logit| of the same seeded model on one rank, the tokens
     equal), trained 3 steps at bf16 (batch 8 x 512, ``ShardedLoader``);
     the float32 check at 2 layers (batch 2 x 64, 4 loss chunks: the
     loss within 1e-5, every gathered gradient leaf within 1e-4, against
     one rank) with its parameters saved from (2, 2) and restored on one
     rank (equal sha256s); dbrx's MoE layer at full width, experts over
     the model axis, G = 2 dispatch groups, within 1e-4 of the one-rank
     layer with groups=2 at a capacity where G = 1 lands far from it.
     Times (prefill ms, decode ms a token, train ms a step, each the
     median), the bytes each kind of collective moved, and each rank's
     peak memory, beside the card's name and power limit; no kernel
     launches on this path (under a policy, no flash);
then one ``{"kernels": [...]}`` line (the flash kernel's row at the
qwen3-4b shape, and a row at each of phase 11's two shapes; every row
carries its phase-12 launches, ``train_launches``, and its phase-13
ones, ``lm_ranks_launches``). The last line is ``{"ok": true,
"device": {...}}``. Any failed check raises, and the script exits
non-zero. Without a CUDA device it exits non-zero before printing
anything.

Run from the repository root:  python3 chip_smoke.py
"""
import contextlib
import functools
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
PIPE_FIELDS = 3                   # still past the queue's depth
PIPE_DEPTH = 2
PIPE_SPIN_S = 0.05
# threads making the fields (numpy releases the GIL in its array work;
# one 10000^2 field takes ~10 s alone and ~4 GB of float64 temporaries)
PIPE_PRODUCERS = 4
# four-step and bandpass launches a field of the complex 8192^2 chain: 2
# row and 4 column passes, one bandpass
PIPE_8192_LAUNCHES = {"fft_fourstep": 6, "bandpass_filter": 1}
# the pipelined chain on four ranks: the (4,) slab at RANK_CHAIN_DIMS
RANK_PIPE_FIELDS = 3              # still past the queue's depth
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
# phase 8, the M->N in-transit path: TRANSIT_WORLD ranks on the card,
# started by the REPRO_* env contract; make_transit_meshes(*TRANSIT_SPLIT);
# seeded radiating-source fields at TRANSIT_DIMS, the first
# TRANSIT_SYNC_FIELDS by send, the next TRANSIT_ASYNC_FIELDS by send_async
# at depth TRANSIT_DEPTH, the Fig. 2 chain on the consumers' (2,) slab
TRANSIT_WORLD = 4
TRANSIT_SPLIT = (2, 2)
TRANSIT_DIMS = (8192, 8192)
TRANSIT_SYNC_FIELDS = 2
TRANSIT_ASYNC_FIELDS = 3          # one past the queue's depth
TRANSIT_DEPTH = 2
# the transit serve: phase 5's serve on two ranks, rank 1 the consumer
TRANSIT_SERVE_WORLD = 2
# phase 9, the spectral solvers on the card. One card, full size: NS2D at
# 8192^2 (r2c slab, 268 MB a spectral field) and Boussinesq at 512^3 (r2c
# slab3d, 1 GB of spectral state), each on the if_rk4 main path. The
# closed forms: Taylor-Green E0 e^{-4 nu t}, Beltrami E0 e^{-2 nu t}
# (tests/test_solver.py:142-196), at the reference's 1e-5 (:202)
SOLVER_NS2D = (8192, 8192)
SOLVER_BQ3D = (512, 512, 512)
SOLVER_TG = {"nu": 0.1, "dt": 0.01, "steps": 20}
SOLVER_INVISCID = {"dt": 2e-3, "steps": 20, "seed": 3, "bins": 32}
SOLVER_BELTRAMI = {"nu": 0.05, "dt": 0.01, "steps": 15}
SOLVER_BUOYANCY_STEPS = 5
SOLVER_ORACLE_TOL = 1e-5
# the kernels against torch.fft (backend "jnp", the reference's jnp.fft
# backend) over the same steps from the same state, relative to max |w|
SOLVER_JNP_STEPS = 5
SOLVER_JNP_TOL = 1e-4
SOLVER_RESTART_STEPS = 4
# steps a metric is taken over (host ms, queued device busy ms), and the
# spin the queued steps wait behind (it must outlast their enqueueing).
# Steps queue behind the spin only as far as the launches pending on the
# device fit the CUDA launch queue (~1024 entries; past it a launch waits
# for the device): SOLVER_LAUNCH_QUEUE launches at most
SOLVER_METRIC_REPS = {"ns2d": 3, "bq3d": 2}
SOLVER_QUEUE_SPIN_S = {"ns2d": QUEUE_SPIN_S, "bq3d": 1.0}
SOLVER_LAUNCH_QUEUE = 900
# four ranks on the card over gloo: (solver, decomposition, mesh, grid,
# real), 3 steps each from init_random, each held to a one-rank run of
# the same case on the card within RANK_TOL of max |one-rank|
SOLVER_RANK_CASES = (("ns2d", "slab", "(4,)", (2048, 2048), True),
                     ("ns2d", "pencil2d", "(2, 2)", (2048, 2048), True),
                     ("bq3d", "pencil", "(2, 2)", (128, 128, 128), True),
                     ("bq3d", "pencil", "(2, 2)", (128, 128, 128), False),
                     ("bq3d", "pencil_tf", "(2, 2)", (128, 128, 128), True),
                     ("bq3d", "pencil_tf", "(2, 2)", (128, 128, 128), False))
SOLVER_RANK_STEPS = 3
SOLVER_RANK_KW = {"ns2d": {"nu": 5e-3, "dt": 5e-3},
                  "bq3d": {"nu": 0.02, "kappa": 0.02, "gravity": 1.0,
                           "dt": 5e-3}}
SOLVER_RANK_SEED = {"ns2d": 3, "bq3d": 5}
# launch/solver.py on three ranks by the REPRO_* env contract (2 producers,
# 1 consumer), then --restore on the same ranks
SOLVER_LAUNCH_WORLD = 3
SOLVER_LAUNCH_ARGS = ("--solver", "ns2d", "--grid", "2048", "2048",
                      "--steps", "10", "--monitor-every", "5")
# phase 10, the elastic consumer mesh: ELASTIC_WORLD ranks on the card by
# the REPRO_* env contract (2 producers, a pool of 2 consumers), the
# reference's chaos scenario (tests/test_elastic.py:497-600) at
# ELASTIC_DIMS complex on a fresh wisdom file: a measured slab plan, a
# heartbeat drop of pool rank 0 from step 2 (detected at step 3, the lease
# 1 step, 2 misses), the engine's ELASTIC_PENDING pending requests at
# ELASTIC_ENGINE_SHAPE c2c failed by the shrink, a resubmit, the grow
# planned from wisdom; each transform within ELASTIC_TOL of max |X| of
# the float64 oracle. Then launch/solver.py --elastic on three ranks
# (phase 9's size, one solver rank, two consumers) against one rank here
ELASTIC_WORLD = 4
ELASTIC_DIMS = (8192, 8192)
ELASTIC_PENDING = 3
ELASTIC_ENGINE_SHAPE = (2048, 2048)
ELASTIC_TOL = 1e-4
ELASTIC_CHAOS_STEPS = 8
ELASTIC_FFT_CALLS = 3
ELASTIC_SOLVER_WORLD = 3


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


def queued_device_ms(fn, reps: int, spin_s: float = QUEUE_SPIN_S) -> float:
    """Device time of one run of ``fn`` with no host gaps: ``reps`` runs
    queued behind a spin kernel of ``spin_s`` that outlasts the host's
    enqueueing (the event after the spin must still be pending when the
    last run is queued), timed by CUDA events between the spin's end and
    the last kernel's. Needs no trace, so it loses no kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * spin_s))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    queued = not start.query()
    stop.synchronize()
    if not queued:
        raise AssertionError(f"the host took longer than the {spin_s}"
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


def check_flash(shape, dtype, causal, cap, gen, mul=1.0, sk=None):
    """The flash kernel at one shape against its plain version; SDPA as
    the library yardstick where it computes the same function (no
    softcap). ``mul`` scales q (larger logits); ``sk`` gives K/V a length
    of their own (non-causal calls). float32 runs as three TF32 products
    on the tensor cores: its bound is those products at the TF32 peak,
    with the CUDA cores' fp32 bound beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    B, S, H, KV, hd = shape
    Sk = S if sk is None else sk
    q, k, v = (torch.randn((B, n_s, n, hd), generator=gen, device="cuda")
               for n_s, n in ((S, H), (Sk, KV), (Sk, KV)))
    q, k, v = (q * mul).to(dtype), k.to(dtype), v.to(dtype)
    got = flash_attention(q, k, v, causal=causal, softcap=cap)
    want = flash_attention_ref(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL[str(dtype).split(".")[-1]]
    diff = (got.float() - want.float()).abs()
    res = {"kernel": "flash_attention", "shape": list(shape), "sk": Sk,
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
        pairs = S * (S + 1) / 2 if causal else S * Sk
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


def spawn_ranks(job, world, out_dir, env=None, timeout=RANK_TIMEOUT_S):
    """This script started once per rank (``--job JOB --rank R --world W
    --store FILE``), every rank on cuda:0; ``env`` (rank -> extra
    environment) gives each its own. Returns each rank's last JSON line
    and the wall seconds; a rank that fails, or outlasts ``timeout``,
    fails the phase (its stderr is printed)."""
    store = out_dir / "store"
    out_dir.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--job", job,
         "--rank", str(r), "--world", str(world), "--store", str(store)],
        env=dict(os.environ, **(env(r) if env else {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    results, failed = [], []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in so.splitlines() if ln.startswith("{")]
        if p.returncode or not lines:      # every failed rank's tail
            print(f"--- {job} rank {r} exited {p.returncode}\n"
                  + so[-4000:] + se[-4000:], file=sys.stderr)
            failed.append(r)
        else:
            results.append(json.loads(lines[-1]))
    if failed:
        raise AssertionError(f"{job} ranks {failed} failed")
    return results, wall


def distributed_ranks(out_dir):
    """The distributed path on RANK_WORLD ranks sharing the one card:
    gloo collectives over CUDA tensors on cuda:0 (gloo stages them
    through host memory, so the times are host-bound). Each rank prints
    one JSON line; any rank failing fails the phase."""
    results, wall = spawn_ranks("ranks", RANK_WORLD, out_dir)
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


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def cluster_env(world):
    """Rank -> the REPRO_* env contract of a ``world``-rank cluster whose
    coordinator is a free local port."""
    coord = f"localhost:{free_port()}"
    return lambda r: {"REPRO_COORDINATOR": coord,
                      "REPRO_NUM_PROCESSES": str(world),
                      "REPRO_PROCESS_ID": str(r)}


def fig2_checks(got, res, mesh, dims):
    """A delivered field (``got``) and the consumers' Fig. 2 chain output
    (``res``) against float64 (collective over ``mesh``): the denoised
    field's max abs error, the kept and total energies' relative
    errors, finiteness."""
    import torch
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft.filters import lowpass_mask
    noisy = D.unshard(got.arrays["field"], mesh, got.spec).double()
    out = D.unshard(res.arrays["field"], mesh, res.spec).double()
    spec64 = torch.fft.fft2(noisy)
    power = spec64.real ** 2 + spec64.imag ** 2
    mask = lowpass_mask(dims, KEEP_FRAC).to(noisy.device)
    kept64, total64 = float((power * mask).sum()), float(power.sum())
    want = torch.fft.ifft2(spec64 * mask).real
    kept = float(res.arrays["insitu_kept_energy"])
    total = float(res.arrays["insitu_total_energy"])
    return {"field_max_abs_err": float((out - want).abs().max()),
            "kept_rel_err": abs(kept - kept64) / kept64,
            "total_rel_err": abs(total - total64) / total64,
            "finite": bool(torch.isfinite(out).all())}


def transit_worker(rank, world, store):
    """One rank of phase 8's Fig. 2 in transit: ``init_cluster`` from the
    env contract (gloo: the ranks share the card), producer and consumer
    meshes from ``make_transit_meshes``, the producers' seeded fields at
    TRANSIT_DIMS sent by ``send`` then ``send_async``, the consumers'
    Fig. 2 chain (writer on the consumer mesh's first rank). Checks: every
    delivered block bit-identical to the producer's block at the same
    position (sha256 of the bytes), the first field's denoised field and
    energies against float64, the launches (none on producers), the
    transit report's fields and bytes."""
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch.core.fft.plan import FORWARD, plan_dft
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.bridge import BridgeData, GridMeta
    from repro_torch.core.insitu.config import build_chain
    from repro_torch.core.insitu.transit import TransitBridge
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_transit_meshes
    from repro_torch.runtime.cluster import cluster_info, init_cluster
    torch.backends.cuda.matmul.allow_tf32 = False
    init_cluster()                  # the REPRO_* env contract, on the card
    info = cluster_info()
    assert info["backend"] == "gloo" and info["process_count"] == world, \
        info
    _build.library()                # built by the parent
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    dims = TRANSIT_DIMS
    pm, cm = make_transit_meshes(*TRANSIT_SPLIT)
    bridge = TransitBridge(pm, cm)
    producer, consumer = bridge.is_producer(), bridge.is_consumer()
    role = "producer" if producer else "consumer"
    spec = ("data", None)
    src = RadiatingSourceAdaptor(dims, mesh=pm, spec=spec) \
        if producer else None
    out_dir = Path(store).parent / "transit_files"
    chain = None
    if consumer:
        assert tuple(plan_dft(dims, FORWARD, cm, decomp="slab").schedule()
                     .in_spec) == spec
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": "slab"},
            {"endpoint": "bandpass", "keep_frac": KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": "slab"},
            {"endpoint": "writer", "out_dir": str(out_dir)},
        ]}, mesh=cm, grid=GridMeta(dims))

    def field(step):
        if producer:
            data = src.produce(step)
            return data.replace(arrays={"field": data.arrays["field"]})
        return BridgeData(arrays={"field": torch.empty(dims, device="meta")})

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()

    digests, checks = {}, {}

    def consume(got):
        digests[got.step] = digest(got.arrays["field"])
        res = chain.execute(got)
        if got.step:
            return
        checks.update(fig2_checks(got, res, cm, dims))

    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    dist.barrier()
    t0 = time.perf_counter()
    send_ms = []
    for step in range(TRANSIT_SYNC_FIELDS):
        data = field(step)
        if producer:
            digests[step] = digest(data.arrays["field"])
        t1 = time.perf_counter()
        got = bridge.send(data)
        send_ms.append((time.perf_counter() - t1) * 1e3)
        if consumer:
            consume(got)
    sync_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    submit_ms = []
    for step in range(TRANSIT_SYNC_FIELDS,
                      TRANSIT_SYNC_FIELDS + TRANSIT_ASYNC_FIELDS):
        data = field(step)
        if producer:
            digests[step] = digest(data.arrays["field"])
        t1 = time.perf_counter()
        bridge.send_async(data, depth=TRANSIT_DEPTH,
                          on_result=consume if consumer else None)
        submit_ms.append((time.perf_counter() - t1) * 1e3)
    bridge.drain_async()
    torch.cuda.synchronize()
    async_wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    files = [Path(f).name for f in chain.finalize()["writer"]["files"]] \
        if consumer else []
    if files:                       # the consumer mesh's first rank
        shutil.rmtree(out_dir, ignore_errors=True)
    rep = bridge.report()
    every = [None] * world
    dist.all_gather_object(every, (role, pm.coordinate or cm.coordinate,
                                   digests))
    fields = TRANSIT_SYNC_FIELDS + TRANSIT_ASYNC_FIELDS
    # consumer block i holds the rows producer block i sent
    by_pos = {(r, c["data"]): d for r, c, d in every}
    identical = all(by_pos[("consumer", i)][k] == by_pos[("producer", i)][k]
                    for i in range(TRANSIT_SPLIT[1]) for k in range(fields))
    a = rep["async"]
    hop_ms = a["hop_busy_s"] / max(a["completed"], 1) * 1e3
    res = {"phase": "transit_rank", "rank": rank, "role": role,
           "cluster": info, "dims": list(dims), "fields": fields,
           "launches": launches, "send_ms": send_ms, "submit_ms": submit_ms,
           "hop_ms_mean": hop_ms, "sync_wall_s": sync_wall,
           "async_wall_s": async_wall, "bit_identical": identical,
           "files": files, "checks": checks,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "transit": rep}
    print(json.dumps(res), flush=True)
    assert identical, res
    assert rep["fields"] == fields, res
    assert rep["bytes_moved"] == fields * dims[0] * dims[1] * 4, res
    assert a["completed"] == TRANSIT_ASYNC_FIELDS and a["error"] is None, res
    # a send_async returns before its hop ends
    assert submit_ms[0] < hop_ms, res
    if producer:
        assert not any(launches.values()), res
        assert files == [], res
    else:
        assert launches["fft_fourstep"] and launches["bandpass_filter"], res
        assert checks["finite"] and \
            checks["field_max_abs_err"] < FIELD_TOL, res
        assert checks["kept_rel_err"] < ENERGY_TOL, res
        assert checks["total_rel_err"] < ENERGY_TOL, res
        want = [f"field_{k:06d}.npy" for k in range(fields)]
        assert files == (want if rank == cm.first_rank else []), res
    dist.barrier()


def transit_serve_worker(rank, world, store):
    """One rank of phase 8's ``serve --transit-consumers 1``: phase 5's
    serve (rank 0 decodes on phase 5's seeded parameters, made on the
    card the same way), the logits monitor every MONITOR_EVERY steps on
    rank 1, which the monitor's fields reach over the bridge. Prints the
    report, the launches, the monitor's files and the peak memory."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    params = None
    if rank == 0:
        params = lm.init_params(
            registry.get_config(SERVE_ARCH),
            torch.Generator(device="cuda").manual_seed(0), torch.float32)
    out_dir = Path(store).parent / f"monitor_rank{rank}"
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    report = serve.main([
        "--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
        str(SERVE_PROMPT), "--tokens", str(SERVE_TOKENS), "--seed", "0",
        "--bench-out", "", "--monitor-every", str(MONITOR_EVERY),
        "--monitor-batch", str(MONITOR_BATCH), "--monitor-dir",
        str(out_dir), "--transit-consumers", "1"], params=params)
    files = sorted(f.name for f in out_dir.glob("logit_stats_*.npy"))
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({"phase": "transit_serve_rank", "rank": rank,
                      "report": report, "launches": launch_counts(counters),
                      "files": files,
                      "peak_bytes": torch.cuda.max_memory_allocated()}),
          flush=True)


def transit_phase(out_dir, unmonitored, monitored):
    """Phase 8: the M->N in-transit path on ranks sharing the card,
    started by the REPRO_* env contract: Fig. 2 in transit on
    TRANSIT_WORLD ranks, then ``serve --transit-consumers 1`` on
    TRANSIT_SERVE_WORLD ranks beside phase 5's serve (the same tokens)
    and phase 7's in-place monitored serve."""
    t0 = time.perf_counter()
    ranks, wall = spawn_ranks("transit", TRANSIT_WORLD, out_dir / "fig2",
                              env=cluster_env(TRANSIT_WORLD))
    emit({"phase": "transit_fig2", "ranks": TRANSIT_WORLD,
          "split": list(TRANSIT_SPLIT), "dims": list(TRANSIT_DIMS),
          "backend": ranks[0]["cluster"]["backend"], "wall_s": wall,
          "results": ranks})
    serve_ranks, serve_wall = spawn_ranks(
        "transit_serve", TRANSIT_SERVE_WORLD, out_dir / "serve",
        env=cluster_env(TRANSIT_SERVE_WORLD))
    decode, consume = serve_ranks
    rep = decode["report"]
    snapshots = -(-SERVE_TOKENS // MONITOR_EVERY)
    executes = -(-snapshots // MONITOR_BATCH)
    res = {"phase": "transit_serve", "arch": SERVE_ARCH,
           "wall_s": serve_wall, "sample": rep["sample"],
           "unmonitored_sample": unmonitored["sample"],
           "prefill_ms": rep["prefill_ms"],
           "decode_ms_per_token": rep["decode_ms_per_token"],
           "in_place_monitored_decode_ms_per_token":
               monitored["decode_ms_per_token"],
           "in_place_monitored_prefill_ms": monitored["prefill_ms"],
           "unmonitored_decode_ms_per_token":
               unmonitored["decode_ms_per_token"],
           "transit": rep["transit"],
           "consumer_transit": consume["report"]["transit"],
           "consumer_monitor": consume["report"]["monitor"],
           "files": [decode["files"], consume["files"]],
           "launches": [decode["launches"], consume["launches"]],
           "peak_bytes": [decode["peak_bytes"], consume["peak_bytes"]],
           "seconds": time.perf_counter() - t0}
    emit(res)
    assert rep["sample"] == unmonitored["sample"], res
    assert decode["files"] == [], res
    assert consume["files"] == [f"logit_stats_{k:06d}.npy"
                                for k in range(executes)], res
    assert decode["launches"]["flash_attention"] == \
        monitored["launches"]["flash_attention"], res
    # the warm-up is not counted (reset_stats); every execute is a field
    assert rep["transit"]["fields"] == executes == \
        consume["report"]["transit"]["fields"], res
    return ranks, serve_ranks


def solver_metrics(s, counters, reps, spin_s):
    """One solver's step on the card: ms a step (host clock around
    ``reps`` steps ended by ``synchronize()``), the host's ms to enqueue
    one step, device time by kernel and launches a step (profiler; by
    kernel symbol for FFT_KERNELS, and by wrapper as counted), device
    busy ms a step (as many of ``reps`` steps as fit SOLVER_LAUNCH_QUEUE
    queued behind a spin kernel of ``spin_s``, CUDA events; else the
    profiler's sum alone), the idle share, and the caching allocator's
    retries (each a cudaFree of cached blocks, which waits for the
    device)."""
    import torch
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.step(reps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    zero_counts(counters)
    t0 = time.perf_counter()
    s.step(1)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    counted = launch_counts(counters)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) \
        - retries0
    wall_ms, rows = device_profile(lambda: s.step(1))
    launches = sum(c for _, _, c in rows)
    queued = min(reps, int(SOLVER_LAUNCH_QUEUE // launches))
    busy = queued_device_ms(lambda: s.step(1), queued, spin_s) \
        if queued else None
    profiled = sum(t for _, t, _ in rows)
    return {"ms_per_step": host_ms, "enqueue_ms_per_step": enqueue_ms,
            "alloc_retries": retries,
            "reserved_bytes": torch.cuda.memory_reserved(),
            "device_busy_ms_per_step": busy, "queued_steps": queued,
            "profiled_device_ms_per_step": profiled,
            "traced_launches_total_per_step": launches,
            "device_idle_share": 1.0 - (profiled if busy is None
                                        else busy) / host_ms,
            "launches_per_step": counted,
            "traced_launches_per_step": {
                k: round(sum(c for n, _, c in rows if k in n))
                for k in FFT_KERNELS},
            "profiled_wall_ms": wall_ms,
            "device_ms_by_kind": kernel_kinds(rows),
            "by_kernel_ms": [{"name": n[:80], "ms": t, "launches": c}
                             for n, t, c in rows[:12]]}


def kernel_kinds(rows):
    """Profiler rows (name, ms, launches) summed by kind: the port's FFT
    kernels, cuFFT (the r2c/c2r endcaps), copies (stack, contiguous,
    memcpy) and the rest (elementwise arithmetic)."""
    out = dict.fromkeys(("fft_kernels", "cufft", "copies", "elementwise"),
                        0.0)
    for n, t, _ in rows:
        low = n.lower()
        kind = ("fft_kernels" if any(k in n for k in FFT_KERNELS)
                else "cufft" if "fft" in low
                else "copies" if "copy" in low or "memcpy" in low
                else "elementwise")
        out[kind] += t
    return out


def fresh_peak() -> int:
    """Free what earlier runs cached (cuFFT keeps a workspace with each
    cached plan), restart the peak count, and return the bytes still
    allocated: a solver's ``peak_bytes`` counts them too."""
    import torch
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def ns2d_one_card(mesh, counters):
    """NS2D at SOLVER_NS2D on one card (r2c slab): Taylor-Green against
    its closed form, with the step's metrics and peak memory; a random
    field, inviscid rk4, conserving energy and enstrophy with sum E(k) =
    E; its first SOLVER_JNP_STEPS steps through torch.fft (backend
    "jnp") against the kernels; restart bit-identical."""
    import numpy as np
    import torch
    from repro_torch.core.solver import NS2DSolver
    out = {"solver": "ns2d", "grid": list(SOLVER_NS2D), "decomp": "slab",
           "real": True, "stepper": "if_rk4"}
    out["allocated_before_bytes"] = fresh_peak()
    t0 = time.perf_counter()
    tg = NS2DSolver(SOLVER_NS2D, mesh, nu=SOLVER_TG["nu"],
                    dt=SOLVER_TG["dt"])
    tg.init_taylor_green()
    out["bring_up_s"] = time.perf_counter() - t0
    e0 = tg.energy()
    zero_counts(counters)
    tg.step(SOLVER_TG["steps"])
    torch.cuda.synchronize()
    out["taylor_green_launches"] = launch_counts(counters)
    want = e0 * math.exp(-4.0 * SOLVER_TG["nu"] * tg.t)
    out["taylor_green"] = {"e0": e0, "energy": tg.energy(), "want": want,
                           "rel_err": abs(tg.energy() - want) / want,
                           "steps": SOLVER_TG["steps"]}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out.update(solver_metrics(tg, counters, SOLVER_METRIC_REPS["ns2d"],
                              SOLVER_QUEUE_SPIN_S["ns2d"]))
    del tg
    # inviscid rk4 from a random field; its first steps also through
    # torch.fft from the same state
    inv = NS2DSolver(SOLVER_NS2D, mesh, nu=0.0, dt=SOLVER_INVISCID["dt"],
                     stepper="rk4")
    inv.init_random(seed=SOLVER_INVISCID["seed"])
    start = tuple(t.clone() for t in inv.state)
    e0, z0 = inv.energy(), inv.enstrophy()
    inv.step(SOLVER_JNP_STEPS)
    w_kernels = inv.vorticity()
    inv.step(SOLVER_INVISCID["steps"] - SOLVER_JNP_STEPS)
    e1, z1 = inv.energy(), inv.enstrophy()
    _, ek = inv.spectrum(SOLVER_INVISCID["bins"])
    out["inviscid"] = {"energy_rel_err": abs(e1 - e0) / e0,
                       "enstrophy_rel_err": abs(z1 - z0) / z0,
                       "spectrum_sum_rel_err":
                           abs(float(np.sum(ek, dtype=np.float64)) - e1) / e1,
                       "steps": SOLVER_INVISCID["steps"]}
    del inv
    ref = NS2DSolver(SOLVER_NS2D, mesh, nu=0.0, dt=SOLVER_INVISCID["dt"],
                     stepper="rk4", backend="jnp")
    ref.state = tuple(t.clone() for t in start)
    zero_counts(counters)
    ref.step(SOLVER_JNP_STEPS)
    w_ref = ref.vorticity()
    out["jnp_backend"] = {
        "steps": SOLVER_JNP_STEPS, "kernel_launches": launch_counts(counters),
        "rel_err": float(np.max(np.abs(w_kernels - w_ref))
                         / np.max(np.abs(w_ref)))}
    del ref, w_ref, w_kernels
    # restart: 8 steps straight against 4, save, restore into a fresh
    # solver started from another state, 4 more
    ckpt_dir = ROOT / "build" / "chip_smoke_solver_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = {"nu": 1e-3, "dt": SOLVER_INVISCID["dt"]}
    a, b, c = (NS2DSolver(SOLVER_NS2D, mesh, **kw) for _ in range(3))
    a.state = tuple(t.clone() for t in start)
    b.state = tuple(t.clone() for t in start)
    del start
    a.step(2 * SOLVER_RESTART_STEPS)
    b.step(SOLVER_RESTART_STEPS)
    t0 = time.perf_counter()
    b.save(ckpt_dir)
    save_s = time.perf_counter() - t0
    del b
    c.init_taylor_green()
    t0 = time.perf_counter()
    restored = c.restore(ckpt_dir)
    restore_s = time.perf_counter() - t0
    c.step(SOLVER_RESTART_STEPS)
    same = all(torch.equal(x, y) for x, y in zip(a.state, c.state))
    out["restart"] = {"restored_step": restored, "bit_identical": same,
                      "step_count": [a.step_count, c.step_count],
                      "t_equal": a.t == c.t, "save_s": save_s,
                      "restore_s": restore_s}
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del a, c
    torch.cuda.empty_cache()
    return out


def bq3d_one_card(mesh, counters):
    """Boussinesq at SOLVER_BQ3D on one card (r2c slab3d): Beltrami
    against its closed form, with the step's metrics and peak memory;
    buoyancy from rest (gravity 1, a buoyancy field sin y + cos z, zero
    velocity) must make kinetic energy."""
    import numpy as np
    import torch
    from repro_torch.core.solver import Boussinesq3DSolver
    out = {"solver": "bq3d", "grid": list(SOLVER_BQ3D), "decomp": "slab3d",
           "real": True, "stepper": "if_rk4"}
    out["allocated_before_bytes"] = fresh_peak()
    t0 = time.perf_counter()
    bel = Boussinesq3DSolver(SOLVER_BQ3D, mesh, nu=SOLVER_BELTRAMI["nu"],
                             dt=SOLVER_BELTRAMI["dt"], decomp="slab3d")
    bel.init_beltrami()
    out["bring_up_s"] = time.perf_counter() - t0
    e0 = bel.energy()
    zero_counts(counters)
    bel.step(SOLVER_BELTRAMI["steps"])
    torch.cuda.synchronize()
    out["beltrami_launches"] = launch_counts(counters)
    want = e0 * math.exp(-2.0 * SOLVER_BELTRAMI["nu"] * bel.t)
    out["beltrami"] = {"e0": e0, "energy": bel.energy(), "want": want,
                       "rel_err": abs(bel.energy() - want) / want,
                       "steps": SOLVER_BELTRAMI["steps"]}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out.update(solver_metrics(bel, counters, SOLVER_METRIC_REPS["bq3d"],
                              SOLVER_QUEUE_SPIN_S["bq3d"]))
    del bel
    torch.cuda.empty_cache()
    g = Boussinesq3DSolver(SOLVER_BQ3D, mesh, gravity=1.0, dt=0.01,
                           decomp="slab3d")
    n0, n1, n2 = SOLVER_BQ3D
    y = (2.0 * np.pi * np.arange(n1) / n1)[None, :, None]
    z = (2.0 * np.pi * np.arange(n2) / n2)[None, None, :]
    zero = np.zeros(SOLVER_BQ3D, np.float32)
    g.init_fields((zero, zero, zero),
                  np.broadcast_to(np.sin(y) + np.cos(z), SOLVER_BQ3D))
    ke0 = g.energy()
    g.step(SOLVER_BUOYANCY_STEPS)
    out["buoyancy"] = {"ke0": ke0, "ke": g.energy(),
                       "scalar_variance": g.scalar_variance(),
                       "steps": SOLVER_BUOYANCY_STEPS}
    del g
    torch.cuda.empty_cache()
    return out


def solver_rank_case(solver, decomp, grid, real, mesh):
    """One four-rank case's solver, from init_random (not stepped)."""
    from repro_torch.core.solver import Boussinesq3DSolver, NS2DSolver
    cls = NS2DSolver if solver == "ns2d" else Boussinesq3DSolver
    s = cls(grid, mesh, decomp=decomp, real=real, **SOLVER_RANK_KW[solver])
    s.init_random(seed=SOLVER_RANK_SEED[solver])
    return s


def solver_case_id(solver, decomp, mkey, real):
    return (f"{solver}_{decomp}_"
            f"{mkey.strip('()').strip(',').replace(', ', 'x')}"
            f"_{'r2c' if real else 'c2c'}")


def solver_rank_worker(rank, world, store):
    """One rank of phase 9's four-rank runs: every SOLVER_RANK_CASES case
    on its mesh over gloo (the ranks share cuda:0), SOLVER_RANK_STEPS
    steps; rank 0 saves each gathered field for the parent to hold
    against its one-rank run. Its JSON line lists the launches, the wall
    time and the FFT shapes its runs gave the kernels."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.compat import make_mesh
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    _build.library()                # built by the parent
    dev = "cuda:0"
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    meshes = {"(4,)": make_mesh((4,), ("data",), device=dev),
              "(2, 2)": make_mesh((2, 2), ("data", "model"), device=dev)}
    out_dir = Path(store).parent
    cases, shapes = [], set()
    with recording_fft_shapes(shapes):
        for solver, decomp, mkey, grid, real in SOLVER_RANK_CASES:
            cid = solver_case_id(solver, decomp, mkey, real)
            s = solver_rank_case(solver, decomp, grid, real, meshes[mkey])
            zero_counts(counters)
            dist.barrier()
            t0 = time.perf_counter()
            s.step(SOLVER_RANK_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts(counters)
            field = s.vorticity() if solver == "ns2d" else s.field("u0")
            energy = s.energy()
            if rank == 0:
                np.save(out_dir / f"{cid}.npy", field)
            cases.append({"case": cid, "wall_s_per_step":
                          wall / SOLVER_RANK_STEPS, "launches": launches,
                          "energy": energy,
                          "finite": bool(np.isfinite(field).all())})
            del s
    print(json.dumps({"rank": rank, "ok": True, "cases": cases,
                      "fft_shapes": sorted(shapes)}), flush=True)
    dist.barrier()


def solver_launch_worker(rank, world, store, restore=False):
    """One rank of phase 9's ``launch/solver.py`` in transit (the REPRO_*
    env contract; gloo, the ranks share the card): SOLVER_LAUNCH_ARGS
    with ``--transit-consumers 1 --transit-async``, spectra to a
    directory of this rank's own, checkpoints every 5 steps; with
    ``restore``, ``--restore`` from those checkpoints."""
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import solver
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()                # built by the parent
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    base = Path(store).parent
    spectra = base / f"spectra{'_restored' if restore else ''}_rank{rank}"
    argv = list(SOLVER_LAUNCH_ARGS) + [
        "--spectra-dir", str(spectra), "--transit-consumers", "1",
        "--transit-async", "--ckpt-dir", str(base / "ckpt"),
        "--ckpt-every", "5"] + (["--restore"] if restore else [])
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(sys.stderr):
        summary = solver.main(argv)
    print(json.dumps({"rank": rank, "summary": summary,
                      "launches": launch_counts(counters),
                      "files": sorted(f.name for f in spectra.glob("*.npy")),
                      "peak_bytes": torch.cuda.max_memory_allocated()},
                     default=str), flush=True)


def elastic_worker(rank, world, store):
    """One rank of phase 10: the chaos scenario on the card (module
    docstring; ELASTIC_* constants). Prints each rescale event, the cold
    and warm plan seconds, the consumers' transform ms a call on the (2,)
    and (1,) meshes, every error against float64, the launches, the FFT
    shapes given to the kernels and the peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft import plan as P
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.bridge import BridgeData, GridMeta
    from repro_torch.core.insitu.config import build_chain
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_elastic_setup
    from repro_torch.runtime.cluster import cluster_info, init_cluster
    from repro_torch.runtime.fault import (HEARTBEAT_DROP, SLOW_RANK,
                                           FaultSchedule, InjectedFault,
                                           StragglerMonitor)
    from repro_torch.serve.fft_engine import FFTServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    init_cluster()                  # the REPRO_* env contract, on the card
    info = cluster_info()
    assert info["backend"] == "gloo" and info["process_count"] == world, \
        info
    _build.library()                # built by the parent
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    base = Path(store).parent
    P.set_wisdom(base / "wisdom.json", "readwrite")   # fresh: see the phase
    dims = ELASTIC_DIMS
    shapes, res, events = set(), {"phase": "elastic_rank", "rank": rank}, []
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    recording = contextlib.ExitStack()
    recording.enter_context(recording_fft_shapes(shapes))
    step_box = [0]
    pm, ctl = make_elastic_setup(
        2, lease=1.0, max_misses=2, clock=lambda: float(step_box[0]),
        plan_kwargs={"decomp": "slab", "backend": "measure",
                     "allow_reduced_wire": False})
    res["pool"] = {str(r): v["rank"] for r, v in ctl.consumer_ranks().items()}
    field = oracle = None
    if ctl.is_consumer():   # the same seeded field on every consumer
        g = torch.Generator(device="cuda").manual_seed(11)
        field = torch.randn(dims, generator=g, device="cuda",
                            dtype=torch.complex64)
        oracle = torch.fft.fft2(field.to(torch.complex128))
        xmax = float(oracle.abs().max())

    def transform(tag):
        """Plan on the current consumer mesh (timed: cold or warm), run
        ELASTIC_FFT_CALLS calls (host clock to synchronize), and hold
        this rank's output block against the oracle's."""
        mesh = ctl.consumer_mesh
        t0 = time.perf_counter()
        plan = ctl.plan(dims)
        plan_s = time.perf_counter() - t0
        stats = ctl.plan_stats()
        args = plan.place(field)
        ms = []
        for _ in range(ELASTIC_FFT_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plan.execute(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        want = D.shard(oracle, mesh, plan.schedule().out_spec)
        got = torch.complex(out[0].double(), out[1].double())
        res[tag] = {"mesh": list(mesh.members), "plan_s": plan_s,
                    "backend": plan.backend,
                    "overlap_chunks": plan.overlap_chunks,
                    "sweep_candidates_timed":
                        stats["sweep_candidates_timed"],
                    "wisdom_hits": stats["wisdom_hits"],
                    "ms_per_call": statistics.median(ms), "ms": ms,
                    "rel_err": float((got - want).abs().max()) / xmax}
        return out

    def engine_err(fut, payload):
        want = np.fft.fft2(payload.astype(np.complex128))
        got = np.asarray(fut.result(timeout=ENGINE_TIMEOUT_S))
        return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))

    rng = np.random.default_rng(5)
    payloads = [(rng.standard_normal(ELASTIC_ENGINE_SHAPE)
                 + 1j * rng.standard_normal(ELASTIC_ENGINE_SHAPE))
                .astype(np.complex64) for _ in range(ELASTIC_PENDING)]
    dist.barrier()
    t_start = time.perf_counter()
    # generation 0: cold measured bring-up, the winner recorded to wisdom
    out0 = transform("gen0") if ctl.is_consumer() else None
    eng = FFTServeEngine(ctl.consumer_mesh, max_batch=4, linger_s=10.0,
                         plan_kwargs={"decomp": "slab"})
    ctl.attach_engine(eng)
    pend = [eng.submit(x) for x in payloads] if ctl.is_consumer() else []
    sched = FaultSchedule([
        InjectedFault(mode=HEARTBEAT_DROP, step=2, rank=0),
        InjectedFault(mode=SLOW_RANK, step=1, rank=1, duration=2,
                      slow_factor=1.5)])
    mon = StragglerMonitor()
    ev = None
    for step in range(1, ELASTIC_CHAOS_STEPS):
        step_box[0] = step
        for r in ctl.active_ranks():
            mon.observe(step, 0.1 * sched.slow_factor(step, r), rank=r)
        ctl.heartbeat_all(drop=[r for r in ctl.active_ranks()
                                if sched.drops_heartbeat(step, r)])
        ev = ctl.tick(straggler_report=mon.rank_report())
        if ev is not None:
            break
    res["detected_at_step"] = step_box[0]
    assert ev is not None, res
    events.append(ev)
    res["pending_errors"] = sorted({type(f.exception(60)).__name__
                                    for f in pend})
    # the resubmit and the shrunk (1,) mesh's plan, on the survivor
    if ctl.is_consumer():
        fut = eng.submit(payloads[0])
    eng.step(force=True)
    eng.drain(timeout=ENGINE_TIMEOUT_S)
    if ctl.is_consumer():
        res["resubmit_rel_err"] = engine_err(fut, payloads[0])
        transform("gen1")
    # grow back onto generation 0's topology: planning from wisdom alone
    events.append(ctl.rescale(n=2, rejoin_ranks=[0], drain=True,
                              reason="capacity rejoined"))
    if ctl.is_consumer():
        out2 = transform("gen2")
        res["bit_identical"] = bool(torch.equal(out0[0], out2[0])
                                    and torch.equal(out0[1], out2[1]))
        del out0, out2
    # the Fig. 2 chain on the grown mesh, fed through the controller
    src = RadiatingSourceAdaptor(dims, mesh=pm, spec=("data", None)) \
        if ctl.is_producer() else None
    if src is not None:
        data = src.produce(0)
        data = data.replace(arrays={"field": data.arrays["field"]})
    else:
        data = BridgeData(arrays={"field": torch.empty(dims,
                                                       device="meta")})
    t0 = time.perf_counter()
    got = ctl.send(data)
    res["hop_s"] = time.perf_counter() - t0
    if ctl.is_consumer():
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": "slab"},
            {"endpoint": "bandpass", "keep_frac": KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": "slab"}]}, mesh=ctl.consumer_mesh, grid=GridMeta(dims))
        res["chain"] = fig2_checks(got, chain.execute(got),
                                   ctl.consumer_mesh, dims)
        chain.finalize()
        # the engine across the grown mesh: one agreed batch of two
        futs = [eng.submit(x) for x in payloads[1:]]
        eng.step(force=True)
        eng.drain(timeout=ENGINE_TIMEOUT_S)
        res["engine_across_rel_err"] = max(
            engine_err(f, x) for f, x in zip(futs, payloads[1:]))
    eng.stop()
    torch.cuda.synchronize()
    recording.close()
    res.update(
        seconds=time.perf_counter() - t_start, cluster=info,
        role=("producer" if ctl.is_producer() else "consumer"),
        events=[{k: e[k] for k in (
            "generation", "reason", "drain", "from_devices", "to_devices",
            "excluded_ids", "consumer_span", "plans_evicted", "engine",
            "wall_s")} for e in events],
        state=ctl.state, generation=ctl.generation,
        launches=launch_counts(counters),
        peak_bytes=torch.cuda.max_memory_allocated(),
        fft_shapes=sorted(shapes))
    print(json.dumps(res), flush=True)
    dist.barrier()


def elastic_solver_worker(rank, world, store):
    """One rank of phase 10's ``launch/solver.py --elastic``
    (SOLVER_LAUNCH_ARGS with ``--decomp slab --transit-consumers 2
    --elastic``; the REPRO_* env contract, gloo, the ranks share the
    card)."""
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import solver
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()                # built by the parent
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    spectra = Path(store).parent / f"spectra_rank{rank}"
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(sys.stderr):
        summary = solver.main(list(SOLVER_LAUNCH_ARGS) + [
            "--decomp", "slab", "--spectra-dir", str(spectra),
            "--transit-consumers", "2", "--elastic"])
    print(json.dumps({"rank": rank, "summary": summary,
                      "launches": launch_counts(counters),
                      "files": sorted(f.name for f in spectra.glob("*.npy")),
                      "peak_bytes": torch.cuda.max_memory_allocated()},
                     default=str), flush=True)


def elastic_phase(gen):
    """Phase 10: the elastic consumer mesh on ranks sharing the card (the
    chaos scenario at ELASTIC_DIMS), then ``launch/solver.py --elastic``
    on three ranks against one rank here, then every FFT shape the
    phase gave the kernels against the plain versions."""
    import numpy as np
    from repro_torch.launch import solver as solver_launch
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke_elastic"
    shutil.rmtree(out_dir, ignore_errors=True)     # a fresh wisdom file
    ranks, wall = spawn_ranks("elastic", ELASTIC_WORLD, out_dir / "chaos",
                              env=cluster_env(ELASTIC_WORLD))
    shapes = set()
    for r in ranks:
        shapes.update(tuple(v) for v in r.pop("fft_shapes"))
    pool = ranks[2:]
    res = {"phase": "elastic", "ranks": ELASTIC_WORLD,
           "dims": list(ELASTIC_DIMS), "wall_s": wall,
           "backend": ranks[0]["cluster"]["backend"],
           "rescale_wall_s": {"shrink": [r["events"][0]["wall_s"]
                                         for r in ranks],
                              "grow": [r["events"][1]["wall_s"]
                                       for r in ranks]},
           "plan_s": {g: [r[g]["plan_s"] for r in pool if g in r]
                      for g in ("gen0", "gen1", "gen2")},
           "fft_ms_per_call": {g: [r[g]["ms_per_call"] for r in pool
                                   if g in r]
                               for g in ("gen0", "gen1", "gen2")},
           "launches_by_rank": [r["launches"] for r in ranks],
           "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
           "results": ranks}
    emit(res)
    for r in ranks:
        assert r["detected_at_step"] == 3, r
        shrink, grow = r["events"]
        assert (shrink["generation"], shrink["to_devices"],
                shrink["drain"]) == (1, 1, False), r
        assert shrink["excluded_ids"] == [2] and \
            shrink["consumer_span"] == [3], r
        assert (grow["generation"], grow["to_devices"],
                grow["consumer_span"]) == (2, 2, [2, 3]), r
        assert r["state"] == "serving" and r["generation"] == 2, r
    for r in pool:
        assert r["events"][0]["engine"]["failed_pending"] == \
            ELASTIC_PENDING, r
        assert r["events"][0]["plans_evicted"] > 0, r
        assert r["pending_errors"] == ["MeshRescaled"], r
        assert r["gen0"]["sweep_candidates_timed"] > 0, r
        assert r["gen2"]["sweep_candidates_timed"] == 0, r
        assert r["gen2"]["wisdom_hits"] > 0, r
        assert r["bit_identical"], r
        for g in ("gen0", "gen2"):
            assert r[g]["rel_err"] < ELASTIC_TOL, r
        assert r["chain"]["finite"] and \
            r["chain"]["field_max_abs_err"] < FIELD_TOL, r
        assert r["chain"]["kept_rel_err"] < ENERGY_TOL, r
        assert r["chain"]["total_rel_err"] < ENERGY_TOL, r
        assert r["engine_across_rel_err"] < ELASTIC_TOL, r
        assert r["launches"]["fft_fourstep"] > 0, r
        assert r["launches"]["bandpass_filter"] > 0, r
    survivor = ranks[3]
    assert survivor["gen1"]["rel_err"] < ELASTIC_TOL, survivor
    assert survivor["resubmit_rel_err"] < ELASTIC_TOL, survivor
    for r in ranks[:2]:             # producers run no transform
        assert not any(r["launches"].values()), r

    # launch/solver.py --elastic on three ranks, against one rank here
    t0 = time.perf_counter()
    flags = list(SOLVER_LAUNCH_ARGS) + ["--decomp", "slab"]
    one_dir = out_dir / "one_rank_spectra"
    with contextlib.redirect_stdout(sys.stderr):
        one_rank = solver_launch.main(flags + ["--spectra-dir",
                                               str(one_dir)])
    launch, _ = spawn_ranks("elastic_solver", ELASTIC_SOLVER_WORLD,
                            out_dir / "solver",
                            env=cluster_env(ELASTIC_SOLVER_WORLD))
    names = ["ns2d_spectrum_000005.npy", "ns2d_spectrum_000010.npy"]
    first = out_dir / "solver" / "spectra_rank1"
    same = [bool(np.array_equal(np.load(first / n), np.load(one_dir / n)))
            for n in names] if (first / names[0]).exists() else []
    p0 = launch[0]["summary"]
    sres = {"phase": "elastic_solver", "world": ELASTIC_SOLVER_WORLD,
            "argv": flags + ["--transit-consumers", "2", "--elastic"],
            "one_rank_final": one_rank["final"], "final": p0["final"],
            "spectra_bit_identical": same,
            "files_by_rank": [r["files"] for r in launch],
            "launches_by_rank": [r["launches"] for r in launch],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in launch],
            "wall_s_by_rank": [r["summary"].get("wall_s") for r in launch],
            "elastic": p0["elastic"], "seconds": time.perf_counter() - t0}
    emit(sres)
    assert sres["final"] == sres["one_rank_final"], sres
    assert same == [True, True], sres
    assert sres["files_by_rank"] == [[], names, []], sres
    assert p0["elastic"]["generation"] == 0, sres
    assert launch[0]["launches"]["fft_fourstep"] > 0, sres
    shutil.rmtree(out_dir, ignore_errors=True)

    # every FFT shape the chaos scenario gave the kernels
    t0 = time.perf_counter()
    checks = check_path_shapes(shapes, gen)
    emit({"phase": "elastic_shape_checks", "shapes": len(checks),
          "seconds": time.perf_counter() - t0})
    emit({"phase": "elastic_seconds",
          "seconds": time.perf_counter() - t_phase})
    return {"ranks": ranks, "solver": sres, "shape_checks": checks}


def solver_phase(counters, gen):
    """Phase 9: the spectral solvers. One card at full size (NS2D 8192^2,
    Boussinesq 512^3), launches counted over the whole one-card path;
    four ranks on the card against one-rank runs; ``launch/solver.py``
    on three ranks in transit, then restored; every FFT shape the solvers
    gave the kernels against the plain versions."""
    import numpy as np
    import torch
    from repro_torch.compat import make_mesh
    from repro_torch.launch import solver as solver_launch
    t_phase = time.perf_counter()
    mesh = make_mesh((1,), ("data",))
    shapes = set()
    t0 = time.perf_counter()
    with recording_fft_shapes(shapes):
        ns2d = ns2d_one_card(mesh, counters)
        emit({"phase": "solver_ns2d", **ns2d})
        bq3d = bq3d_one_card(mesh, counters)
        emit({"phase": "solver_bq3d", **bq3d})
    one_card_s = time.perf_counter() - t0
    for res, run in ((ns2d, "taylor_green_launches"),
                     (bq3d, "beltrami_launches")):
        assert res[run]["fft_fourstep"] > 0, res
        counted = res["launches_per_step"]
        assert counted["fft_fourstep"] > 0, res
        # the profiler kept every FFT launch of the step it traced
        assert sum(res["traced_launches_per_step"].values()) == \
            counted["fft_fourstep"] + counted["fft_stockham"], res
    assert ns2d["taylor_green"]["rel_err"] < SOLVER_ORACLE_TOL, ns2d
    inv = ns2d["inviscid"]
    assert inv["energy_rel_err"] < SOLVER_ORACLE_TOL, ns2d
    assert inv["enstrophy_rel_err"] < SOLVER_ORACLE_TOL, ns2d
    assert inv["spectrum_sum_rel_err"] < SOLVER_ORACLE_TOL, ns2d
    assert ns2d["jnp_backend"]["rel_err"] < SOLVER_JNP_TOL, ns2d
    assert ns2d["jnp_backend"]["kernel_launches"]["fft_fourstep"] == 0, ns2d
    rs = ns2d["restart"]
    assert rs["bit_identical"] and rs["t_equal"], ns2d
    assert rs["restored_step"] == SOLVER_RESTART_STEPS, ns2d
    assert bq3d["beltrami"]["rel_err"] < SOLVER_ORACLE_TOL, bq3d
    assert bq3d["buoyancy"]["ke0"] == 0.0, bq3d
    assert bq3d["buoyancy"]["ke"] > 0.0, bq3d

    # four ranks on the card, each case against its one-rank run here
    out_dir = ROOT / "build" / "chip_smoke_solver"
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ranks, wall = spawn_ranks("solver_ranks", RANK_WORLD, out_dir / "ranks")
    rank_s = time.perf_counter() - t0
    rows = []
    with recording_fft_shapes(shapes):
        for (solver, decomp, mkey, grid, real), four in zip(
                SOLVER_RANK_CASES, ranks[0]["cases"]):
            cid = solver_case_id(solver, decomp, mkey, real)
            axes = 2 if mkey == "(2, 2)" else 1
            one = solver_rank_case(solver, decomp, grid, real,
                                   make_mesh((1,) * axes,
                                             ("data", "model")[:axes]))
            one.step(SOLVER_RANK_STEPS)
            want = one.vorticity() if solver == "ns2d" else one.field("u0")
            got = np.load(out_dir / "ranks" / f"{cid}.npy")
            rows.append({
                "case": cid, "grid": list(grid),
                "rel_err": float(np.max(np.abs(got - want))
                                 / np.max(np.abs(want))),
                "energy_rel_err": abs(four["energy"] - one.energy())
                / one.energy(),
                "wall_s_per_step_rank0": four["wall_s_per_step"],
                "launches_rank0": four["launches"]})
            del one
    for r in ranks:
        shapes.update(tuple(v) for v in r.pop("fft_shapes"))
    emit({"phase": "solver_ranks", "ranks": RANK_WORLD, "wall_s": wall,
          "steps": SOLVER_RANK_STEPS, "tol": RANK_TOL, "cases": rows})
    for row, case in zip(rows, SOLVER_RANK_CASES):
        assert row["rel_err"] < RANK_TOL, row
        assert row["energy_rel_err"] < RANK_TOL, row
        small = min(case[3]) < 256
        kernel = "fft_stockham" if small else "fft_fourstep"
        assert row["launches_rank0"][kernel] > 0, row

    # launch/solver.py: one rank here, then three ranks in transit, then
    # restored on the same three
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        one_rank = solver_launch.main(list(SOLVER_LAUNCH_ARGS) + [
            "--spectra-dir", str(out_dir / "one_rank_spectra")])
    env = cluster_env(SOLVER_LAUNCH_WORLD)
    first, _ = spawn_ranks("solver_launch", SOLVER_LAUNCH_WORLD,
                           out_dir / "launch", env=env)
    second, _ = spawn_ranks("solver_restore", SOLVER_LAUNCH_WORLD,
                            out_dir / "launch",
                            env=cluster_env(SOLVER_LAUNCH_WORLD))
    launch_s = time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)
    nu, dt = 1e-3, 5e-3            # the launcher's defaults
    closed = 0.25 * math.exp(-4.0 * nu * 20 * dt)   # Taylor-Green, t(20)
    p0 = first[0]["summary"]
    res = {"phase": "solver_launch", "world": SOLVER_LAUNCH_WORLD,
           "argv": list(SOLVER_LAUNCH_ARGS),
           "one_rank_final": one_rank["final"],
           "one_rank_wall_s": one_rank["wall_s"],
           "transit_final": p0["final"],
           "energy_rel_err_vs_one_rank":
               abs(p0["final"]["energy"] - one_rank["final"]["energy"])
               / one_rank["final"]["energy"],
           "files_by_rank": [r["files"] for r in first],
           "launches_by_rank": [r["launches"] for r in first],
           "peak_bytes_by_rank": [r["peak_bytes"] for r in first],
           "wall_s_by_rank": [r["summary"].get("wall_s") for r in first],
           "transit": p0["transit"],
           "restored_final": second[0]["summary"]["final"],
           "restored_files_by_rank": [r["files"] for r in second],
           "restored_energy_rel_err_vs_closed_form":
               abs(second[0]["summary"]["final"]["energy"] - closed)
               / closed,
           "seconds": launch_s}
    emit(res)
    names = ["ns2d_spectrum_000005.npy", "ns2d_spectrum_000010.npy"]
    assert res["files_by_rank"] == [[], [], names], res
    assert res["energy_rel_err_vs_one_rank"] < SOLVER_ORACLE_TOL, res
    assert res["restored_final"]["step"] == 20, res
    assert res["restored_files_by_rank"] == [[], [], [
        "ns2d_spectrum_000015.npy", "ns2d_spectrum_000020.npy"]], res
    assert res["restored_energy_rel_err_vs_closed_form"] \
        < SOLVER_ORACLE_TOL, res
    assert all(r["launches"]["fft_fourstep"] > 0 for r in first[:2]), res
    assert not any(first[2]["launches"].values()), res

    # every FFT shape the solvers gave the kernels, against the plain
    # versions
    t0 = time.perf_counter()
    checks = check_path_shapes(shapes, gen)
    emit({"phase": "solver_shape_checks", "shapes": len(checks),
          "seconds": time.perf_counter() - t0})
    emit({"phase": "solver_seconds", "one_card_s": one_card_s,
          "four_ranks_s": rank_s, "launch_s": launch_s,
          "seconds": time.perf_counter() - t_phase})
    return {"ns2d": ns2d, "bq3d": bq3d, "ranks": rows, "launch": res,
            "shape_checks": checks}


# phase 11, the model families past the dense decoders, each at its
# published width in float32 with seeded weights made on the card. grok-1
# and dbrx keep 2 of their layers (45.8 and 31.0 GB of weights; the full
# depths, 1.26 TB and 528 GB, do not fit one card): batch 2, a 2048-token
# prompt, 8 greedy tokens. mamba2 and zamba2 run serve.main at full depth
# (batch 4, 2048 + 16); whisper takes seeded frames (4, 1500, 1024) and a
# 64-token decoder prompt; internvl2 256 seeded patch embeddings and 1792
# text tokens (batch 4), both decoding 16 tokens (32 until phase 13 needed
# the time)
MOE_FAMILIES = ("grok-1-314b", "dbrx-132b")
MOE_LAYERS, MOE_BATCH, MOE_PROMPT, MOE_TOKENS = 2, 2, 2048, 8
SSM_FAMILIES = ("mamba2-1.3b", "zamba2-2.7b")
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_TOKENS = 4, 2048, 16
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 64
# teacher-forced bars, max |difference| over max |logit|: phase 5's for
# whisper and internvl2; for mamba2 and zamba2 the reference's SSM bar
# (tests/test_ssm_oracle.py: the chunked scan against the step-by-step
# recurrence, which is what prefill then decode compares), held on the
# first SSM_CUT_LAYERS layers at published width (SSM layers only: for
# zamba2 the five before its first hybrid slot, whose gated norms turn the
# shared block's rounding into 1.8e-3) and reported at full depth: the
# random float32 layers amplify float32 rounding (mamba2 read 2.9e-3 at
# full depth; on the CPU its reduced width reads 2.8e-6 at 4 layers,
# 2.5e-4 at 48, and 4.9e-7 at 48 with the stack in float64, so the gap is
# float32's, as the sensitivity above says);
# reported and not held for the MoE stacks, whose capacity depends on the
# token count, so that prefill(S) and prefill(S + 1) may drop other picks
SSM_TEACHER_TOL = 2e-4
SSM_CUT_LAYERS = 5
# each family's prefill on the flash kernel against the same prefill on
# its plain version, relative to max |logit|. The MoE stacks' plain run
# replays the kernel run's top-k picks: routing is a step function, and a
# 1e-5 change in one token's router input flips a near-tie (grok-1's
# smallest gap between the 2nd and 3rd expert was 8.6e-6 over 4096
# tokens), which the next layer's attention spreads into every later
# position (read: 7.7e-4 on grok-1 without the replay, 2.4e-5 on a draw
# with no flip). The picks the plain run would have made are counted.
# Every flash call of a prefill is also held, on its own inputs, against
# the plain version (the same bar, relative to max |plain|). On the SSM
# and hybrid stacks the logits' comparison is reported, not held: Mamba2's
# gated RMSNorm divides heads whose gated output nearly vanishes (rms
# down to 4.7e-7 against eps 1e-6 at zamba2's width) by their rms, so one
# SSM layer turns a 1e-6 change of its input into 6e-4-8e-4 of its output
# (measured on the card; SSM_SENSITIVITY_EPS below), the reference's
# formula alike; a flash call's 2.4e-6 becomes 0.25 of the logits after
# 54 layers
FLASH_PLAIN_TOL = 1e-4
SSM_SENSITIVITY_EPS = 1e-6
# one grok-1 MoE layer at full width against a loop over its experts, with
# the capacity factor at E / K so that nothing drops (every expert's
# buffer holds every token), relative to max |oracle|
MOE_ORACLE_TOKENS = 512
MOE_ORACLE_TOL = 1e-4
# the int8 cache against the dense one on internvl2-2b, decoding from an
# empty state: the reference's bar (tests/test_serve.py:135-157), max
# |dlogit| < 0.05, total variation < 0.01, the same argmax. Its absolute
# 0.05 was set at width 64, where that test's logits reach 0.544 (its
# dense run, read on the CPU); at internvl2's 2048 the head's logits are
# ~5.6x larger (embedding init 0.02 x sqrt(d)), so max |dlogit| is held
# relative to max |logit| at the reference's ratio, 0.05 / 0.544, and
# reported beside the absolute 0.05. The argmax is reported with each
# row's dense top-two gap, not held: with 92553 random logits a row's top
# two lie ~0.2 apart, and any row whose gap is under 2 x max |dlogit| may
# flip (read: one row of four flipped at max |dlogit| 0.080, 1.8% of max
# |logit|); a row whose gap exceeds it cannot, by the bound above
INT8_TOKENS = 64
INT8_MAX_DLOGIT = 0.05
INT8_MAX_REL_DLOGIT = 0.05 / 0.544
INT8_MAX_TV = 0.01
# the continuous batcher on zamba2: slots, requests, new tokens each. A
# request's run alone is the same engine (HYBRID_SLOTS slots) holding only
# that request: a GEMM's row is bitwise the same whatever the other rows
# hold, but not across batch sizes (cuBLAS picks its kernel by shape), and
# the gated norms above turn a last-bit change into other tokens
HYBRID_SLOTS, HYBRID_REQUESTS, HYBRID_NEW = 4, 6, 8


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@contextlib.contextmanager
def flash_route(fn):
    """The models' flash calls go to ``fn`` (given the kernel's wrapper)
    while the block runs."""
    from repro_torch.models import attention
    real = attention.flash_attention
    attention.flash_attention = functools.partial(fn, real)
    try:
        yield
    finally:
        attention.flash_attention = real


def plain_flash(_real, q, k, v, *, causal=True, softcap=0.0, **_):
    from repro_torch.kernels.ref import flash_attention_ref
    return flash_attention_ref(q, k, v, causal=causal, softcap=softcap)


def checking_flash(errs: list):
    """A route that launches the kernel and holds each call, on its own
    inputs, against the plain version: ``errs`` gets max |kernel - plain|
    over max |plain| a call."""
    def fn(real, q, k, v, **kw):
        out = real(q, k, v, **kw)
        errs.append(rel_err(out, plain_flash(real, q, k, v, **kw)))
        return out
    return flash_route(fn)


def ssm_sensitivity(cfg, params, tokens, gen):
    """Relative change of the first SSM layer's output for a relative
    change of SSM_SENSITIVITY_EPS (of max |x|) in its input, at the
    model's embedded tokens."""
    import torch
    from repro_torch.models import blocks, lm
    x = lm.embed_inputs(cfg, params, {"tokens": tokens})
    p = params["blocks"][0]["l0"]
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    a, _ = blocks._ssm_layer(cfg, p, x)
    b, _ = blocks._ssm_layer(cfg, p, x + SSM_SENSITIVITY_EPS
                             * x.abs().max() * noise)
    return rel_err(b, a)


def recording_flash(seen: list):
    """A route that records each flash call's (q shape, k shape, causal)
    and launches the kernel."""
    def fn(real, q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), kw.get("causal")))
        return real(q, k, v, **kw)
    return flash_route(fn)


def no_drop(cfg):
    """``cfg`` with the MoE capacity factor at E / K: C = T, so no pick
    drops (a token picks an expert at most once)."""
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def moe_layer_check(cfg, p, gen):
    """One MoE layer at full width on MOE_ORACLE_TOKENS tokens, nothing
    dropped, against a loop over the experts; run twice, bit-identical."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.common import activation
    cfg = no_drop(cfg)
    x = 0.5 * torch.randn((1, MOE_ORACLE_TOKENS, cfg.d_model),
                          generator=gen, device="cuda")
    got, aux = moe.moe_mlp(cfg, p, x)
    again, aux2 = moe.moe_mlp(cfg, p, x)
    xt = x[0]
    gates, ids = moe.top_k(torch.softmax(xt @ p["router"], -1),
                           cfg.moe.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    act = activation(cfg.act)
    want = torch.zeros_like(xt)
    for e in range(cfg.moe.num_experts):
        y = (act(xt @ p["moe_gate"][e]) * (xt @ p["moe_up"][e])) \
            @ p["moe_down"][e]
        want += (gates * (ids == e)).sum(-1, keepdim=True) * y
    res = {"tokens": MOE_ORACLE_TOKENS,
           "capacity": moe.capacity(MOE_ORACLE_TOKENS, cfg),
           "rel_err_vs_expert_loop": rel_err(got[0], want),
           "tol": MOE_ORACLE_TOL,
           "bit_identical_rerun": bool(torch.equal(got, again)
                                       and torch.equal(aux, aux2))}
    assert res["rel_err_vs_expert_loop"] < MOE_ORACLE_TOL, res
    assert res["bit_identical_rerun"], res
    return res


def drive_decoder(cfg, params, batch, new_tokens, counters):
    """lm.prefill then greedy lm.decode_step, as serve.main drives them:
    host ms to synchronize(), launches of the prefill and of the decode,
    and the last logits."""
    import torch
    from repro_torch.models import lm
    S = batch["tokens"].shape[1]
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = lm.prefill(cfg, params, batch,
                               cache_len=S + new_tokens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    at_prefill = launch_counts(counters)
    tok = logits[:, -1].argmax(-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        logits, state = lm.decode_step(cfg, params, tok, state)
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    decode = (time.perf_counter() - t0) * 1e3 / new_tokens
    total = launch_counts(counters)
    assert bool(torch.isfinite(logits).all())
    return {"prefill_ms": prefill_ms, "decode_ms_per_token": decode,
            "launches_prefill": at_prefill,
            "launches_decode": {k: total[k] - at_prefill[k]
                                for k in total},
            "flash_launches_per_prefill": at_prefill["flash_attention"]}


@contextlib.contextmanager
def routing(record=None, replay=None, flips=None):
    """MoE top-k picks recorded into ``record``, or replayed from
    ``replay`` (call by call) with the gate values taken at the replayed
    experts; ``flips`` gets, per call, the tokens whose own picks
    differed."""
    from repro_torch.models import moe
    real = moe.top_k
    calls = iter(replay or ())

    def fn(probs, k):
        vals, ids = real(probs, k)
        if record is not None:
            record.append(ids)
        if replay is not None:
            want = next(calls)
            flips.append(int((ids != want).any(-1).sum()))
            ids, vals = want, probs.gather(-1, want)
        return vals, ids
    moe.top_k = fn
    try:
        yield
    finally:
        moe.top_k = real


def teacher_forced(cfg, params, batch):
    """prefill(S) then one decode step against prefill(S + 1), relative to
    max |logit|; and the prefill on the plain flash version against the
    kernel's, relative to max |logit| (MoE: on the kernel run's picks)."""
    import torch
    from repro_torch.models import lm
    S = batch["tokens"].shape[1] - 1
    short = {k: (v[:, :S] if k == "tokens" else v) for k, v in batch.items()}
    picks, flips, calls = [], [], []
    with routing(record=picks), checking_flash(calls):
        with_kernel, state = lm.prefill(cfg, params, short,
                                        cache_len=S + 1)
    step, _ = lm.decode_step(cfg, params, batch["tokens"][:, S:], state)
    del state
    full, _ = lm.prefill(cfg, params, batch)
    with flash_route(plain_flash), routing(replay=picks, flips=flips):
        plain, _ = lm.prefill(cfg, params, short)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(step).all() and torch.isfinite(full).all())
    out = {"teacher_forced_rel_err": rel_err(step, full),
           "flash_vs_plain_rel_err": rel_err(with_kernel, plain),
           "flash_calls_max_rel_err": max(calls, default=0.0),
           "flash_plain_tol": FLASH_PLAIN_TOL}
    if cfg.moe is not None:
        out["plain_run_own_picks_differing"] = flips
    return out


def family_tokens(cfg, gen, B, S):
    import torch
    return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")


def moe_family(arch, counters, gen):
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = dataclasses.replace(registry.get_config(arch),
                              num_layers=MOE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), torch.float32)
    torch.cuda.synchronize()
    res = {"phase": "lm_family", "arch": arch, "family": cfg.family,
           "reduced": {"num_layers": [registry.get_config(arch).num_layers,
                                      MOE_LAYERS]},
           "param_bytes": sum(t.numel() * 4 for t in _tensors(params)),
           "param_init_seconds": time.perf_counter() - t0,
           "batch": MOE_BATCH, "prompt_len": MOE_PROMPT,
           "tokens": MOE_TOKENS}
    tokens = family_tokens(cfg, gen, MOE_BATCH, MOE_PROMPT + 1)
    res.update(drive_decoder(cfg, params, {"tokens": tokens[:, :-1]},
                             MOE_TOKENS, counters))
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    res.update(teacher_forced(cfg, params, {"tokens": tokens}))
    res["teacher_forced_held"] = False
    if arch == "grok-1-314b":
        res["moe_layer"] = moe_layer_check(
            cfg, params["blocks"][0]["l0"]["moe"], gen)
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    del params
    torch.cuda.empty_cache()
    assert res["flash_launches_per_prefill"] == MOE_LAYERS, res
    assert res["flash_vs_plain_rel_err"] < FLASH_PLAIN_TOL, res
    assert res["flash_calls_max_rel_err"] < FLASH_PLAIN_TOL, res
    return res


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def ssm_family(arch, counters, gen):
    """serve.main at full depth, the teacher-forced and flash-vs-plain
    checks; on zamba2 also the continuous batcher against each request
    run alone."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import ContinuousBatcher, Request
    cfg = registry.get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), torch.float32)
    torch.cuda.synchronize()
    res = {"phase": "lm_family", "arch": arch, "family": cfg.family,
           "reduced": None,
           "param_bytes": sum(t.numel() * 4 for t in _tensors(params)),
           "param_init_seconds": time.perf_counter() - t0,
           "batch": FAMILY_BATCH, "prompt_len": FAMILY_PROMPT,
           "tokens": FAMILY_TOKENS}
    zero_counts(counters)
    report = serve.main(["--arch", arch, "--batch", str(FAMILY_BATCH),
                         "--prompt-len", str(FAMILY_PROMPT), "--tokens",
                         str(FAMILY_TOKENS), "--seed", "0", "--bench-out",
                         ""], params=params)
    res.update({"prefill_ms": report["prefill_ms"],
                "decode_ms_per_token": report["decode_ms_per_token"],
                "launches": launch_counts(counters),
                "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    res["flash_launches_per_prefill"] = res["launches"]["flash_attention"]
    tokens = family_tokens(cfg, gen, FAMILY_BATCH, FAMILY_PROMPT + 1)
    res.update(teacher_forced(cfg, params, {"tokens": tokens}))
    res["teacher_forced_held"] = res["flash_vs_plain_held"] = False
    res["ssm_layer_sensitivity"] = {
        "input_change": SSM_SENSITIVITY_EPS,
        "output_change": ssm_sensitivity(cfg, params, tokens[:, :-1], gen)}
    cut = dataclasses.replace(cfg, num_layers=SSM_CUT_LAYERS,
                              layer_pattern=("ssm",))
    first = [g[f"l{i}"] for g in params["blocks"]
             for i, kind in enumerate(cfg.layer_pattern) if kind == "ssm"]
    cut_tf = teacher_forced(cut, dict(params, blocks=[
        {"l0": p} for p in first[:SSM_CUT_LAYERS]]), {"tokens": tokens})
    res["teacher_forced_cut"] = {"layers": SSM_CUT_LAYERS,
                                 "rel_err": cut_tf["teacher_forced_rel_err"],
                                 "tol": SSM_TEACHER_TOL}
    if cfg.family == "hybrid":
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(4, 17))).astype(np.int32),
            max_new=HYBRID_NEW) for i in range(HYBRID_REQUESTS)]
        t1 = time.perf_counter()
        eng = ContinuousBatcher(cfg, params, slots=HYBRID_SLOTS,
                                cache_len=64)
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t1
        alone = {}
        for r in reqs:
            one = ContinuousBatcher(cfg, params, slots=HYBRID_SLOTS,
                                    cache_len=64)
            one.submit(Request(rid=r.rid, prompt=r.prompt,
                               max_new=HYBRID_NEW))
            alone[r.rid] = one.run()[r.rid].out
        res["engine"] = {"slots": HYBRID_SLOTS, "requests": len(reqs),
                         "finished": len(done), "ticks": eng.ticks,
                         "seconds": batched_s,
                         "tokens_equal_alone": all(
                             done[r.rid].out == alone[r.rid]
                             for r in reqs)}
        del eng
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    del params
    torch.cuda.empty_cache()
    n_hybrid = cfg.num_layers // len(cfg.layer_pattern) * \
        cfg.layer_pattern.count("hybrid")
    assert res["flash_launches_per_prefill"] == n_hybrid, res
    assert res["teacher_forced_cut"]["rel_err"] < SSM_TEACHER_TOL, res
    assert res["flash_calls_max_rel_err"] < FLASH_PLAIN_TOL, res
    if "engine" in res:
        assert res["engine"]["finished"] == HYBRID_REQUESTS, res
        assert res["engine"]["tokens_equal_alone"], res
    return res


def vlm_family(counters, gen):
    """internvl2-2b with seeded patch embeddings, the teacher-forced and
    flash-vs-plain checks, and the int8 cache against the dense one."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = registry.get_config("internvl2-2b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), torch.float32)
    res = {"phase": "lm_family", "arch": cfg.name, "family": cfg.family,
           "reduced": None,
           "param_bytes": sum(t.numel() * 4 for t in _tensors(params)),
           "batch": FAMILY_BATCH, "prompt_len": FAMILY_PROMPT,
           "patches": cfg.num_patches, "tokens": FAMILY_TOKENS}
    patches = torch.randn((FAMILY_BATCH, cfg.num_patches, lm.VIT_STUB_DIM),
                          generator=gen, device="cuda")
    tokens = family_tokens(cfg, gen, FAMILY_BATCH, FAMILY_PROMPT + 1)
    res.update(drive_decoder(cfg, params, {"tokens": tokens[:, :-1],
                                           "patch_embeds": patches},
                             FAMILY_TOKENS, counters))
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    res.update(teacher_forced(cfg, params, {"tokens": tokens,
                                            "patch_embeds": patches}))
    res["teacher_forced_tol"] = TEACHER_TOL
    # the int8 cache: decode INT8_TOKENS tokens from empty states
    logits, caches = {}, {}
    for impl in ("dense", "int8"):
        state = lm.init_decode_state(cfg, FAMILY_BATCH, INT8_TOKENS,
                                     torch.float32, cache_impl=impl)
        for t in range(INT8_TOKENS):
            out, state = lm.decode_step(cfg, params, tokens[:, t:t + 1],
                                        state)
        logits[impl] = out[:, 0]
        caches[impl] = sum(t.numel() * t.element_size()
                           for c in state["caches"].values()
                           for t in vars(c).values() if torch.is_tensor(t))
        del state
    pd, pq = (torch.softmax(logits[k], -1) for k in ("dense", "int8"))
    dlogit = float((logits["dense"] - logits["int8"]).abs().max())
    top2 = logits["dense"].topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = logits["dense"].argmax(-1) == logits["int8"].argmax(-1)
    res["int8"] = {
        "tokens": INT8_TOKENS,
        "max_abs_dlogit": dlogit,
        "max_abs_logit": float(logits["dense"].abs().max()),
        "rel_dlogit": rel_err(logits["int8"], logits["dense"]),
        "rel_dlogit_tol": INT8_MAX_REL_DLOGIT,
        "abs_dlogit_bar_at_width_64": INT8_MAX_DLOGIT,
        "total_variation": float(0.5 * (pd - pq).abs().sum(-1).max()),
        "same_argmax_rows": int(same.sum()),
        "rows": int(same.numel()),
        "top2_gap": gap.tolist(),
        "argmax_held": False,
        "dense_cache_bytes": caches["dense"],
        "int8_cache_bytes": caches["int8"]}
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    del params
    torch.cuda.empty_cache()
    assert res["flash_launches_per_prefill"] == cfg.num_layers, res
    assert res["teacher_forced_rel_err"] < TEACHER_TOL, res
    assert res["flash_vs_plain_rel_err"] < FLASH_PLAIN_TOL, res
    assert res["flash_calls_max_rel_err"] < FLASH_PLAIN_TOL, res
    assert res["int8"]["rel_dlogit"] < INT8_MAX_REL_DLOGIT, res
    assert res["int8"]["total_variation"] < INT8_MAX_TV, res
    return res


def whisper_family(counters, gen):
    """whisper-medium: encode seeded frames, prefill a decoder prompt,
    decode greedily; the teacher-forced and flash-vs-plain checks. The
    flash calls are recorded by shape: the encoder's, the decoder's
    self-attention and the cross-attention (64 queries, 1500 keys)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import encdec
    cfg = registry.get_config("whisper-medium")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = encdec.init_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), torch.float32)
    B, S = FAMILY_BATCH, WHISPER_PROMPT
    frames = 0.02 * torch.randn((B, WHISPER_FRAMES, cfg.d_model),
                                generator=gen, device="cuda")
    tokens = family_tokens(cfg, gen, B, S + 1)
    res = {"phase": "lm_family", "arch": cfg.name, "family": cfg.family,
           "reduced": None,
           "param_bytes": sum(t.numel() * 4 for t in _tensors(params)),
           "batch": B, "frames": WHISPER_FRAMES, "prompt_len": S,
           "tokens": FAMILY_TOKENS}
    seen = []
    zero_counts(counters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with recording_flash(seen):
        logits, state = encdec.prefill(
            cfg, params, {"frames": frames, "tokens": tokens[:, :S]},
            cache_len=S + FAMILY_TOKENS)
    torch.cuda.synchronize()
    res["prefill_ms"] = (time.perf_counter() - t1) * 1e3
    at_prefill = launch_counts(counters)
    tok = logits[:, -1].argmax(-1)[:, None]
    t1 = time.perf_counter()
    for _ in range(FAMILY_TOKENS):
        logits, state = encdec.decode_step(cfg, params, tok, state)
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    res["decode_ms_per_token"] = (time.perf_counter() - t1) * 1e3 / \
        FAMILY_TOKENS
    total = launch_counts(counters)
    del state
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    res["launches_prefill"] = at_prefill
    res["launches_decode"] = {k: total[k] - at_prefill[k] for k in total}
    res["flash_launches_per_prefill"] = at_prefill["flash_attention"]
    res["flash_calls_by_kind"] = {
        "encoder": sum(1 for q, k, c in seen if q[1] == WHISPER_FRAMES),
        "self": sum(1 for q, k, c in seen if c and q[1] == S),
        "cross": sum(1 for q, k, c in seen
                     if not c and q[1] == S and k[1] == WHISPER_FRAMES)}
    # teacher-forced: prefill(S) + one decode step == prefill(S + 1);
    # and the prefill on the plain flash version
    short = {"frames": frames, "tokens": tokens[:, :S]}
    calls = []
    with checking_flash(calls):
        with_kernel, state = encdec.prefill(cfg, params, short,
                                            cache_len=S + 1)
    step, _ = encdec.decode_step(cfg, params, tokens[:, S:], state)
    del state
    full, _ = encdec.prefill(cfg, params, {"frames": frames,
                                           "tokens": tokens})
    with flash_route(plain_flash):
        plain, _ = encdec.prefill(cfg, params, short)
    res.update({"teacher_forced_rel_err": rel_err(step, full),
                "teacher_forced_tol": TEACHER_TOL,
                "flash_vs_plain_rel_err": rel_err(with_kernel, plain),
                "flash_calls_max_rel_err": max(calls),
                "flash_plain_tol": FLASH_PLAIN_TOL,
                "seconds": time.perf_counter() - t0})
    emit(res)
    del params
    torch.cuda.empty_cache()
    L = cfg.encoder_layers
    assert res["flash_calls_by_kind"] == {"encoder": L, "self": L,
                                          "cross": L}, res
    assert res["flash_launches_per_prefill"] == 3 * L, res
    assert bool(torch.isfinite(step).all())
    assert res["teacher_forced_rel_err"] < TEACHER_TOL, res
    assert res["flash_vs_plain_rel_err"] < FLASH_PLAIN_TOL, res
    assert res["flash_calls_max_rel_err"] < FLASH_PLAIN_TOL, res
    return res


def lm_families(counters, gen):
    """Phase 11: every family past the dense decoders at published width;
    returns their results by arch."""
    t0 = time.perf_counter()
    out = {}
    for arch in MOE_FAMILIES:
        out[arch] = moe_family(arch, counters, gen)
    for arch in SSM_FAMILIES:
        out[arch] = ssm_family(arch, counters, gen)
    out["whisper-medium"] = whisper_family(counters, gen)
    out["internvl2-2b"] = vlm_family(counters, gen)
    emit({"phase": "lm_families", "seconds": time.perf_counter() - t0,
          "table": [{k: r.get(k) for k in (
              "arch", "prefill_ms", "decode_ms_per_token",
              "peak_memory_bytes", "flash_launches_per_prefill",
              "teacher_forced_rel_err", "flash_vs_plain_rel_err")}
              for r in out.values()]})
    return out


# phase 12, the training path: qwen3-4b at full width (d_model 2560, 32/8
# heads of 128, d_ff 9728, vocab 151936, untied head), depth cut to
# TRAIN_LAYERS of 36 (at full depth the float32 masters, m, v and the
# bf16 copy and gradients take about 70 GB by themselves), through
# make_train_step at bf16 compute with the in-step gradient monitor every
# TRAIN_INSITU_EVERY steps. Its check: one step at TRAIN_CHECK_LAYERS
# layers, still full width, float32 compute (TF32 off since phase 1),
# held against the port's CPU run of the same step: the loss and every
# gradient leaf within TRAIN_CHECK_TOL of its max |CPU| (float32 products
# summed in other orders, cuBLAS against the CPU's BLAS; the CPU tests
# hold the CPU path to the reference at the same bar)
TRAIN_ARCH = "qwen3-4b"
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_STEPS = 10
TRAIN_INSITU_EVERY = 5
TRAIN_LR = 3e-4
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 1, 64
TRAIN_CHECK_TOL = 1e-4
TRAIN_CHECK_CHUNK = 16          # 4 loss chunks: the chunked, recomputed path
# the 100m preset of examples/train_insitu_torch.py, its restart run and
# the transit run, each through launch/train.main: the restart run twice
# with torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG set
# before CUDA starts) and twice without, straight and with failures
# injected; the transit run on two ranks sharing the card over gloo. The
# six processes run at once, the example in this process beside them. The
# example runs 200 of its 300 steps, for the script's time: at lr 6e-3
# its loss first rises and falls below the start only after ~90 steps
# (an H100 read 10.53 -> 8.42 in 200)
TRAIN_100M_STEPS = 200
TRAIN_RESTART_STEPS = 30
TRAIN_RESTART_FAILS = ("12", "24")
TRAIN_RESTART_CKPT_EVERY = 10
TRAIN_TRANSIT_STEPS = 10
TRAIN_TRANSIT_INSITU_EVERY = 5
TRAIN_PROCS = 6                 # 4 restart runs, then the 2 transit ranks
CUBLAS_DETERMINISTIC = ":4096:8"


def _example():
    """examples/train_insitu_torch.py as a module (its presets and the
    registration of their configs)."""
    import importlib.util
    name = "train_insitu_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / "train_insitu_torch.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def measure_train(counters, cfg, batch, seq, steps, lr, insitu_every):
    """``steps`` steps of ``cfg`` through make_train_step (bf16 compute,
    the gradient monitor every ``insitu_every``) at ``batch`` x ``seq``,
    under a one-rank policy on the card; the counts zeroed just before
    and read just after. Each step is timed on the host clock to its
    loss's ``float()`` (the step's device work done); device busy is the
    kernels' device time of one profiled report step. Returns the
    measurements."""
    import torch
    from repro_torch.core.insitu.chain import InSituChain
    from repro_torch.core.insitu.endpoints.spectral_monitor import (
        SpectralMonitorEndpoint)
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.sharding.policy import make_policy
    from repro_torch.train import step as train_step
    mesh = make_host_mesh(device="cuda")
    policy = make_policy(mesh, global_batch=batch)
    opt = AdamW(warmup_cosine(lr, 1, steps))
    hook = InSituChain([SpectralMonitorEndpoint(
        source="grads", nbins=8, max_tensors=4)], mesh=mesh).initialize() \
        .as_step_hook()
    step_fn = train_step.make_train_step(
        cfg, policy, opt, loss_chunk=seq, insitu_chain=hook,
        insitu_every=insitu_every)
    base = fresh_peak()
    state = train_step.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(0),
        max_target=seq)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - base
    batches = [{k: torch.from_numpy(v).cuda() for k, v in synthetic.batch_at(
        s, global_batch=batch, seq_len=seq, vocab=cfg.vocab_size,
        seed=0).items()} for s in range(steps)]
    zero_counts(counters)
    losses, gnorms, step_ms, reports = [], [], [], []
    for s in range(steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[s])
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        if s % insitu_every == 0:
            reports.append({"step": s, **{k: v.tolist() for k, v in
                                          m["insitu"].items()}})
        else:
            assert all(float(v.abs().max()) == 0
                       for v in m["insitu"].values()), m["insitu"]
    launches = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in losses + gnorms), (losses, gnorms)
    assert launches["flash_attention"] == 0, launches
    for r in reports:
        spectra = torch.tensor(r["insitu_grad_spectra"])
        assert spectra.shape == (4, 8), spectra.shape
        assert torch.allclose(spectra.sum(-1), torch.ones(4), atol=1e-5)
    # device busy: the kernels' device time of one profiled report step
    # (torch.profiler), over the step's ms
    wall_ms, rows = device_profile(lambda: step_fn(state, batches[0]))
    busy = sum(t for _, t, _ in rows)
    ms = statistics.median(step_ms[1:])
    gemm = sum(t for n, t, _ in rows if "gemm" in n.lower()
               or "sm90" in n.lower() or "cutlass" in n.lower())
    res = {"params": sum(p.numel() for p in _tensors(state["params"])),
           "batch": batch, "seq": seq, "steps": steps,
           "compute_dtype": "bfloat16", "loss": losses,
           "grad_norm": gnorms, "ms_per_step": ms,
           "first_step_ms": step_ms[0], "step_ms": step_ms,
           "device_busy_ms_per_step": busy,
           "device_busy_share": busy / ms,
           "profiled_wall_ms": wall_ms,
           "profiled_gemm_ms": gemm,
           "by_kernel_ms": [{"name": n[:80], "ms": t, "launches": c}
                            for n, t, c in rows[:12]],
           "state_bytes": state_bytes, "peak_memory_bytes": peak,
           "launches": launches, "insitu": reports}
    del state, batches, step_fn
    torch.cuda.empty_cache()
    return res


def train_qwen(counters):
    """Phase 12's main path: TRAIN_STEPS steps of qwen3-4b (TRAIN_LAYERS
    layers, full width) at batch TRAIN_BATCH x TRAIN_SEQ; the counts
    zeroed just before and read just after. Returns the result line."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get_config(TRAIN_ARCH),
                              num_layers=TRAIN_LAYERS)
    res = {"phase": "train", "arch": TRAIN_ARCH, "layers": TRAIN_LAYERS,
           "of_layers": registry.get_config(TRAIN_ARCH).num_layers,
           **measure_train(counters, cfg, TRAIN_BATCH, TRAIN_SEQ,
                           TRAIN_STEPS, TRAIN_LR, TRAIN_INSITU_EVERY)}
    emit(res)
    return res


def train_100m_steps(counters):
    """The 100m preset's model alone on the card, before anything runs
    beside it: TRAIN_STEPS steps at batch 8 x 512 through make_train_step
    (the example's lr), each to its loss's ``float()``, and one profiled
    step's device time, so the step's ms is held against its device
    work. The launcher's step EMA (``train_100m``) times only the host's
    part of a step: the call returns once the host has queued it."""
    cfg = _example().model_100m()
    res = {"phase": "train_100m_steps", "config": cfg.name,
           **measure_train(counters, cfg, 8, 512, TRAIN_STEPS, 6e-3,
                           TRAIN_INSITU_EVERY)}
    emit(res)
    return res


def train_cpu_check():
    """One float32 step of qwen3-4b at TRAIN_CHECK_LAYERS layers, full
    width, on the card and on the CPU from the same parameters (made on
    the card from a seed), the loss over TRAIN_CHECK_SEQ / TRAIN_CHECK_CHUNK
    sequence chunks: the loss and every gradient leaf against the CPU's
    (TRAIN_CHECK_TOL of max |CPU leaf|)."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.sharding.policy import make_policy
    from repro_torch.train import step as train_step
    from repro_torch.tree_util import tree_leaves_with_path, tree_map
    cfg = dataclasses.replace(registry.get_config(TRAIN_ARCH),
                              num_layers=TRAIN_CHECK_LAYERS)
    opt = AdamW(warmup_cosine(TRAIN_LR, 1, 10))
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(1), torch.float32)
    batch = synthetic.batch_at(0, global_batch=TRAIN_CHECK_BATCH,
                               seq_len=TRAIN_CHECK_SEQ,
                               vocab=cfg.vocab_size, seed=1)
    out, seconds = {}, {}
    for device in ("cpu", "cuda"):   # the CPU copy before the card's step
        p = params if device == "cuda" else tree_map(
            lambda t: t.cpu(), params)
        captured = {}

        def hook(payload):
            captured["grads"] = payload["grads"]
            return {}
        fn = train_step.make_train_step(
            cfg, make_policy(make_host_mesh(device=device),
                             global_batch=TRAIN_CHECK_BATCH), opt,
            loss_chunk=TRAIN_CHECK_CHUNK, compute_dtype=torch.float32,
            insitu_chain=hook)
        state = {"params": p, "opt": opt.init(p),
                 "step": torch.zeros((), dtype=torch.int32)}
        t0 = time.perf_counter()
        _, m = fn(state, {k: torch.from_numpy(v).to(device)
                          for k, v in batch.items()})
        loss = float(m["loss"])
        seconds[device] = time.perf_counter() - t0
        out[device] = (loss, {k: g.cpu() for k, g in
                              tree_leaves_with_path(captured["grads"])})
        del state, captured, p
    del params
    torch.cuda.empty_cache()
    (closs, cgrads), (gloss, ggrads) = out["cpu"], out["cuda"]
    errs = {k: float((ggrads[k] - g).abs().max())
            / max(float(g.abs().max()), 1e-30) for k, g in cgrads.items()}
    worst = max(errs, key=errs.get)
    res = {"phase": "train_cpu_check", "arch": TRAIN_ARCH,
           "layers": TRAIN_CHECK_LAYERS, "batch": TRAIN_CHECK_BATCH,
           "seq": TRAIN_CHECK_SEQ, "compute_dtype": "float32",
           "loss_chunks": TRAIN_CHECK_SEQ // TRAIN_CHECK_CHUNK,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "loss_cuda": gloss, "loss_cpu": closs,
           "loss_rel_err": abs(gloss - closs) / abs(closs),
           "grad_leaves": len(errs), "max_grad_rel_err": errs[worst],
           "worst_leaf": worst, "tol": TRAIN_CHECK_TOL,
           "cpu_step_s": seconds["cpu"], "cuda_step_s": seconds["cuda"]}
    emit(res)
    assert res["loss_rel_err"] <= TRAIN_CHECK_TOL, res
    assert res["max_grad_rel_err"] <= TRAIN_CHECK_TOL, res
    return res


def train_100m(out_dir, beside=0):
    """The example's 100m preset (examples/train_insitu_torch.py, through
    launch/train.main): TRAIN_100M_STEPS steps at batch 8 x 512; its own
    assertions hold (loss down by more than 0.5, spectra written).
    ``beside``: how many other training processes share the card and the
    host meanwhile. The host-paced step moves with what else runs on the
    host, so the line also has this process's threads, its CPU seconds
    over the run and the load average before and after."""
    import threading
    import torch
    mod = _example()
    fresh_peak()
    threads = sorted(t.name for t in threading.enumerate())
    load0 = os.getloadavg()
    t0, cpu0 = time.perf_counter(), time.process_time()
    with contextlib.redirect_stdout(sys.stderr):
        out = mod.main(["--preset", "100m", "--steps",
                        str(TRAIN_100M_STEPS), "--out", str(out_dir)])
    wall = time.perf_counter() - t0
    cpu_s = time.process_time() - cpu0
    res = {"phase": "train_100m", "config": "repro-100m",
           "params": mod.model_100m().param_count(),
           "steps": TRAIN_100M_STEPS, "batch": 8, "seq": 512,
           "first_loss": out["first_loss"], "final_loss": out["final_loss"],
           "spectra_files": out["spectra_files"],
           "spectra_backpressure_ms": out["spectra_backpressure_ms"],
           "restarts": out["restarts"], "wall_s": wall,
           "train_wall_s": out["wall_s"],
           "step_ema_ms": out["straggler"]["mean_step_s"] * 1e3,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "processes_beside": beside, "threads": threads,
           "process_cpu_s": cpu_s, "process_cpu_share": cpu_s / wall,
           "loadavg_1m": [load0[0], os.getloadavg()[0]],
           "host_cpus": os.cpu_count()}
    emit(res)
    assert out["final_loss"] < out["first_loss"] - 0.5, res
    assert out["spectra_files"] > 0, res
    return res


def _last_checkpoint(ckpt_dir):
    last = sorted(Path(ckpt_dir).glob("step_*"))[-1]
    return last.name, [leaf["sha256"] for leaf in json.loads(
        (last / "manifest.json").read_text())["leaves"]]


def train_proc_worker(rank, world, store):
    """One of phase 12's processes: ranks 0-3 run the 100m restart check
    (rank 0 and 1 deterministic, 1 and 3 with failures injected), ranks 4
    and 5 are the two ranks of the transit run (REPRO_* env contract)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()                # built by the parent
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    cfg = _example().model_100m()
    _example().register(cfg)
    base = Path(store).parent
    common = ["--arch", cfg.name, "--batch", "8", "--seq", "512", "--lr",
              "6e-3", "--device", "cuda"]
    zero_counts(counters)
    if rank < 4:
        deterministic = rank < 2
        if deterministic:
            torch.use_deterministic_algorithms(True)
        fail = rank % 2 == 1
        ckpt = base / f"restart{rank}"
        argv = common + ["--steps", str(TRAIN_RESTART_STEPS),
                         "--insitu-every", "10", "--ckpt-dir", str(ckpt)]
        if fail:
            argv += ["--fail-at", *TRAIN_RESTART_FAILS, "--ckpt-every",
                     str(TRAIN_RESTART_CKPT_EVERY)]
        with contextlib.redirect_stdout(sys.stderr):
            summary = train.main(argv)
        step, shas = _last_checkpoint(ckpt)
        shutil.rmtree(ckpt, ignore_errors=True)
        print(json.dumps({"rank": rank, "role": "restart",
                          "deterministic": deterministic, "fail": fail,
                          "cublas_workspace_config":
                              os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                          "summary": summary, "last_checkpoint": step,
                          "shas": shas,
                          "launches": launch_counts(counters)},
                         default=str), flush=True)
        return
    timeline = _transit_timeline(train)
    spectra = base / f"transit_spectra{rank - 4}"
    argv = common + ["--steps", str(TRAIN_TRANSIT_STEPS), "--insitu-every",
                     str(TRAIN_TRANSIT_INSITU_EVERY), "--ckpt-dir",
                     str(base / "transit_ckpt"), "--insitu-spectra-dir",
                     str(spectra), "--transit-consumers", "1",
                     "--transit-async"]
    with contextlib.redirect_stdout(sys.stderr):
        summary = train.main(argv)
    files = sorted(spectra.glob("*.npy"))
    sums = [np.load(f).sum(-1).tolist() for f in files]
    print(json.dumps({"rank": rank, "role": "transit", "summary": summary,
                      "files": [f.name for f in files], "row_sums": sums,
                      "timeline": timeline,
                      "launches": launch_counts(counters)},
                     default=str), flush=True)


def _transit_timeline(train):
    """Wall-clock stamps (time.time(), one clock for every process on the
    host) of a transit rank's run: worker entry, bridge set-up, the
    training loop, each async submit, each hop's header exchange (where
    a rank waits for the other side to reach the same send), its byte
    gathers and the drains, as (name, start, end). Wraps the launcher's
    and the bridge's functions in this process only."""
    from repro_torch.core.insitu import transit
    timeline = [("worker", time.time(), time.time())]

    def stamp(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                timeline.append((name, t0, time.time()))
        return wrapped
    train.make_transit_setup = stamp("setup", train.make_transit_setup)
    train.run_with_restarts = stamp("train", train.run_with_restarts)
    for name, attr in (("submit", "send_async"), ("headers",
                       "_exchange_headers"), ("gather", "_move"),
                       ("drain", "drain_async")):
        setattr(transit.TransitBridge, attr,
                stamp(name, getattr(transit.TransitBridge, attr)))
    return timeline


def transit_hops(producer, consumer):
    """Where a transit hop's time goes, from both ranks' timelines: for
    each send, when each side reached its header exchange (the first
    collective of the hop), how long the earlier one waited there for
    the later one, and the hop from the later arrival to the consumer's
    last gather. Times in s from the earlier worker's entry."""
    t0 = min(producer["timeline"][0][1], consumer["timeline"][0][1])

    def spans(rank, name):
        return [(a - t0, b - t0) for n, a, b in rank["timeline"]
                if n == name]
    out = {side: {n: spans(r, n) for n in ("worker", "setup", "train",
                                             "submit", "drain")}
           for side, r in (("producer", producer),
                           ("consumer", consumer))}
    hops = []
    gathers = spans(consumer, "gather")
    per = len(gathers) // max(len(spans(consumer, "headers")), 1)
    for i, (p, c) in enumerate(zip(spans(producer, "headers"),
                                   spans(consumer, "headers"))):
        later = max(p[0], c[0])
        hops.append({"producer_at": p[0], "consumer_at": c[0],
                     "consumer_waited_s": p[0] - c[0],
                     "exchange_s": max(p[1], c[1]) - later,
                     "hop_s": gathers[(i + 1) * per - 1][1] - later})
    out["hops"] = hops
    return out


def start_train_procs(out_dir, box):
    """Start phase 12's six processes at once on the card (the 100m
    restart check, straight and failed, with and without deterministic
    algorithms, and the transit run on two ranks), waited for on a
    thread: ``box`` gets ``"results"`` (each rank's line, the wall s) or
    ``"error"``. Returns the thread."""
    import threading
    transit_env = cluster_env(2)

    def env(r):
        if r < 4:
            return {"CUBLAS_WORKSPACE_CONFIG": CUBLAS_DETERMINISTIC} \
                if r < 2 else {}
        return transit_env(r - 4)

    def run():
        try:
            box["results"] = spawn_ranks("train_procs", TRAIN_PROCS,
                                         out_dir, env=env)
        except BaseException as err:        # raised by train_procs
            box["error"] = err
    thread = threading.Thread(target=run)
    thread.start()
    return thread


def train_procs(box):
    """The six processes' line (``start_train_procs``), then its checks:
    both restart runs end at step 40, the failed one after 2 restarts;
    the deterministic pair bit-identical; the consumer alone writes a
    file a report, its rows normalised."""
    if "error" in box:
        raise box["error"]
    results, wall = box["results"]
    restart = {(r["deterministic"], r["fail"]): r for r in results[:4]}
    identical = {det: restart[(det, False)]["shas"]
                 == restart[(det, True)]["shas"] for det in (True, False)}
    producer, consumer = results[4], results[5]
    reports = len(range(0, TRAIN_TRANSIT_STEPS, TRAIN_TRANSIT_INSITU_EVERY))
    res = {"phase": "train_procs", "processes": TRAIN_PROCS, "wall_s": wall,
           "restart": {
               "steps": TRAIN_RESTART_STEPS,
               "fail_at": list(TRAIN_RESTART_FAILS),
               "bit_identical_deterministic": identical[True],
               "bit_identical_without_deterministic": identical[False],
               "final_loss": {f"{'det' if d else 'nondet'}_"
                              f"{'failed' if f else 'straight'}":
                              r["summary"]["final_loss"]
                              for (d, f), r in restart.items()},
               "wall_s": {f"{'det' if d else 'nondet'}_"
                          f"{'failed' if f else 'straight'}":
                          r["summary"]["wall_s"]
                          for (d, f), r in restart.items()}},
           "transit": {"steps": TRAIN_TRANSIT_STEPS,
                       "producer_final_loss":
                           producer["summary"]["final_loss"],
                       "producer_files": producer["files"],
                       "consumer_files": consumer["files"],
                       "consumer_row_sums": consumer["row_sums"],
                       "transit": consumer["summary"]["transit"],
                       "producer_async":
                           producer["summary"]["transit"]["async"],
                       "timeline": transit_hops(producer, consumer)},
           "launches_by_process": [r["launches"] for r in results]}
    emit(res)
    for (det, fail), r in restart.items():
        assert r["last_checkpoint"] == \
            f"step_{TRAIN_RESTART_STEPS:08d}", r["last_checkpoint"]
        assert r["summary"]["restarts"] == (2 if fail else 0), r
    assert identical[True], restart
    assert producer["files"] == [] and consumer["summary"]["role"] == \
        "consumer", (producer, consumer)
    assert len(consumer["files"]) == reports, consumer
    assert all(abs(s - 1.0) < 1e-5 for row in consumer["row_sums"]
               for s in row), consumer["row_sums"]
    assert consumer["summary"]["transit"]["fields"] == reports
    return res


def train_phase(counters):
    """Phase 12: the training path on the card (see TRAIN_ARCH above)."""
    import torch
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        main_path = train_qwen(counters)
        check = train_cpu_check()
        steps_100m = train_100m_steps(counters)
        torch.cuda.empty_cache()
        # the 100m example here while the six processes run: each is
        # paced by its host thread, and the card has room for all seven
        box = {}
        thread = start_train_procs(out_dir / "procs", box)
        try:
            hundred = train_100m(out_dir / "example", beside=TRAIN_PROCS)
        finally:
            thread.join()
        procs = train_procs(box)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "train_phase", "seconds": time.perf_counter() - t0})
    return {"main": main_path, "check": check, "100m_steps": steps_100m,
            "100m": hundred, "procs": procs}


# phase 13, the LM substrate across ranks: LM_RANKS_WORLD ranks on the
# card (gloo over CUDA tensors, every rank on cuda:0) on the (2, 2)
# ("data", "model") mesh, under make_policy as the reference's serve and
# train build it (TP over model, FSDP and DP over data). Serve: qwen3-4b
# at full width, depth cut to LM_RANKS_LAYERS of 36 for the card's time,
# float32, batch LM_RANKS_BATCH x LM_RANKS_PROMPT + LM_RANKS_TOKENS greedy
# tokens; held against the same seeded model on one rank of the card
# under a one-rank policy (the same route: no flash under a policy),
# computed by rank 0 while the others wait. Train: LM_RANKS_TRAIN_STEPS
# steps at bf16 compute, batch 8 x 512, through make_train_step and
# ShardedLoader; the float32 check at TRAIN_CHECK_LAYERS layers (batch
# LM_RANKS_CHECK_BATCH x TRAIN_CHECK_SEQ, 4 loss chunks) against the same
# step on one rank; that check's parameters saved from (2, 2) and
# restored on one rank. MoE: dbrx's layer at full width, expert-parallel
# (ep_mode), batch 4 x 256, float32, G = 2 dispatch groups, against the
# one-rank layer with groups=2, at a capacity factor where G = 2 and
# G = 1 differ
LM_RANKS_WORLD = 4
LM_RANKS_LAYERS = 4
LM_RANKS_BATCH, LM_RANKS_PROMPT, LM_RANKS_TOKENS = 4, 512, 8
LM_RANKS_PREFILL_REPS = 3
LM_RANKS_TRAIN_BATCH, LM_RANKS_TRAIN_SEQ = 8, 512
LM_RANKS_TRAIN_STEPS = 3
LM_RANKS_CHECK_BATCH = 2
LM_RANKS_TOL = 1e-4
LM_RANKS_LOSS_TOL = 1e-5
LM_RANKS_MOE_ARCH = "dbrx-132b"
LM_RANKS_MOE_BATCH, LM_RANKS_MOE_SEQ = 4, 256
# 1024 tokens, 4 picks each over 16 experts: 128 picks an expert on
# average in each of the 2 groups, 256 in the one group of G = 1, and 128
# slots either way at this factor, so the two drop different tokens
LM_RANKS_MOE_CF = 0.5
LM_RANKS_TIMEOUT_S = 600


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) \
        / max(float(want.double().abs().max()), 1e-30)


def _rank_rows(pol, t):
    """This rank's rows of a global (B, ...) tensor."""
    return pol.named(pol.act_rows(t.dim()))(t)


def _lm_serve_ranks(rank, mesh, one, counters):
    """Phase 13's serve on the (2, 2) mesh, then (rank 0) the one-rank
    run of the same seeded model; returns the serve's numbers."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.sharding import collectives
    from repro_torch.sharding.policy import make_policy
    cfg = dataclasses.replace(registry.get_config(SERVE_ARCH),
                              num_layers=LM_RANKS_LAYERS)
    B, S, T = LM_RANKS_BATCH, LM_RANKS_PROMPT, LM_RANKS_TOKENS
    pol = make_policy(mesh, global_batch=B)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen, torch.float32, policy=pol)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda")

    def whole(logits):
        return pol.gather(logits, pol.act_logits(cfg.vocab_size))

    zero_counts(counters)
    collectives.reset_bytes()
    prefill_ms = []
    with torch.no_grad():
        for _ in range(LM_RANKS_PREFILL_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = lm.prefill(cfg, params,
                                       {"tokens": _rank_rows(pol, prompts)},
                                       pol, cache_len=S + T)
            logits = whole(logits)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        prefill_bytes = {k: v // LM_RANKS_PREFILL_REPS
                         for k, v in collectives.BYTES.items()}
        collectives.reset_bytes()
        first = logits
        tok = logits[:, -1].argmax(-1)[:, None]
        toks, steps, decode_ms = [tok], [], []
        for _ in range(T):
            t0 = time.perf_counter()
            logits, state = lm.decode_step(cfg, params, _rank_rows(pol, tok),
                                           state, pol)
            logits = whole(logits)
            tok = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits)
            toks.append(tok)
        decode_bytes = {k: v // T for k, v in collectives.BYTES.items()}
    launches = launch_counts(counters)
    del params, state
    torch.cuda.empty_cache()
    res = {"prefill_ms": statistics.median(prefill_ms),
           "prefill_ms_runs": prefill_ms,
           "decode_ms_per_token": statistics.median(decode_ms),
           "decode_ms_runs": decode_ms,
           "prefill_collective_bytes": prefill_bytes,
           "decode_collective_bytes_per_token": decode_bytes,
           "launches": launches,
           "tokens": torch.cat(toks[:T], dim=1)[0].tolist()}
    dist.barrier()
    if rank == 0:
        # the same seeded model whole, on one rank, under a one-rank
        # policy; teacher-forced on the ranks' tokens
        gen = torch.Generator(device="cuda").manual_seed(0)
        full = lm.init_params(cfg, gen, torch.float32)
        pol1 = make_policy(one, global_batch=B)
        with torch.no_grad():
            want, st = lm.prefill(cfg, full, {"tokens": prompts}, pol1,
                                  cache_len=S + T)
            errs, same = [], []
            for i in range(T):
                w, st = lm.decode_step(cfg, full, toks[i], st, pol1)
                errs.append(_rel(steps[i], w))
                same.append(bool(torch.equal(w[:, -1].argmax(-1)[:, None],
                                             toks[i + 1])))
        res.update({"prefill_rel_err": _rel(first, want),
                    "teacher_forced_rel_err": max(errs),
                    "tokens_equal": all(same),
                    "first_token_equal": bool(torch.equal(
                        want[:, -1].argmax(-1)[:, None], toks[0]))})
        del full, st
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def _lm_train_ranks(rank, mesh, counters):
    """Phase 13's training steps on the (2, 2) mesh through ShardedLoader;
    each step timed to its loss's ``float()``, the bytes each kind of
    collective moved in it."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.sharding import collectives
    from repro_torch.sharding.policy import make_policy
    from repro_torch.train import step as train_step
    cfg = dataclasses.replace(registry.get_config(TRAIN_ARCH),
                              num_layers=LM_RANKS_LAYERS)
    B, S = LM_RANKS_TRAIN_BATCH, LM_RANKS_TRAIN_SEQ
    pol = make_policy(mesh, global_batch=B)
    opt = AdamW(warmup_cosine(TRAIN_LR, 1, LM_RANKS_TRAIN_STEPS))
    step_fn = train_step.make_train_step(cfg, pol, opt, loss_chunk=S)
    state = train_step.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(0),
        max_target=S, policy=pol)
    loader = ShardedLoader(lambda s: synthetic.batch_at(
        s, global_batch=B, seq_len=S, vocab=cfg.vocab_size, seed=0), pol)
    zero_counts(counters)
    losses, gnorms, ms, nbytes = [], [], [], []
    try:
        for _ in range(LM_RANKS_TRAIN_STEPS):
            collectives.reset_bytes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, batch = next(loader)
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            gnorms.append(float(m["grad_norm"]))
            nbytes.append(dict(collectives.BYTES))
    finally:
        loader.close()
    assert all(math.isfinite(x) for x in losses + gnorms), (losses, gnorms)
    launches = launch_counts(counters)
    del state
    torch.cuda.empty_cache()
    return {"ms_per_step": statistics.median(ms), "step_ms": ms,
            "loss": losses, "grad_norm": gnorms,
            "collective_bytes_per_step": nbytes[-1], "launches": launches}


def _lm_check_ranks(rank, mesh, one, out_dir):
    """The float32 check's parameters saved from (2, 2) and restored on
    one rank (rank 0) against their checksums; then the float32 step on
    (2, 2) against the same step on one rank, every gradient leaf
    gathered."""
    import dataclasses
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.sharding.policy import make_policy, spec_leaves
    from repro_torch.train import step as train_step
    from repro_torch.tree_util import tree_leaves
    cfg = dataclasses.replace(registry.get_config(TRAIN_ARCH),
                              num_layers=TRAIN_CHECK_LAYERS)
    B = LM_RANKS_CHECK_BATCH
    opt = AdamW(warmup_cosine(TRAIN_LR, 1, 10))
    batch = synthetic.batch_at(0, global_batch=B, seq_len=TRAIN_CHECK_SEQ,
                               vocab=cfg.vocab_size, seed=1)
    shapes = train_step.train_state_shapes(cfg, opt)["params"]

    def step(pol, params):
        captured = {}

        def hook(payload):
            captured["grads"] = payload["grads"]
            return {}
        fn = train_step.make_train_step(
            cfg, pol, opt, loss_chunk=TRAIN_CHECK_CHUNK,
            compute_dtype=torch.float32, insitu_chain=hook)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        rows = {k: _rank_rows(pol, torch.from_numpy(v).cuda())
                for k, v in batch.items()}
        t0 = time.perf_counter()
        _, m = fn(state, rows)
        loss = float(m["loss"])
        return loss, captured["grads"], time.perf_counter() - t0

    pol = make_policy(mesh, global_batch=B)
    pol1 = make_policy(one, global_batch=B)
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(1), torch.float32, policy=pol)
    # saved from (2, 2): every rank gathers, rank 0 writes
    t0 = time.perf_counter()
    ckpt_dir = out_dir / "lm_ranks_ckpt"
    ckpt.save(ckpt_dir, 0, {"params": params},
              gather={"params": pol.tree_gathers(shapes)}, mesh=mesh)
    res = {"ckpt_save_s": time.perf_counter() - t0}
    full = None
    if rank == 0:
        full = lm.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(1), torch.float32)
        manifest = json.loads((ckpt_dir / "step_00000000" / "manifest.json")
                              .read_text())
        host = [t.cpu().numpy() for t in tree_leaves({"params": full})]
        shas = [hashlib.sha256(a.tobytes()).hexdigest()[:16] for a in host]
        t0 = time.perf_counter()
        back = ckpt.restore(ckpt_dir, 0, {"params": shapes}, place={
            "params": pol1.tree_shardings(shapes)})
        res.update({
            "ckpt_leaves": len(shas),
            "ckpt_bytes": int(sum(a.nbytes for a in host)),
            "ckpt_sha256_equal": [x["sha256"] for x in manifest["leaves"]]
            == shas,
            "ckpt_restored_equal": all(
                bool(torch.equal(t, w)) for t, w in
                zip(tree_leaves(back), tree_leaves({"params": full}))),
            "ckpt_restore_s": time.perf_counter() - t0})
        del back, host
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dist.barrier()
    loss, grads, ranks_s = step(pol, params)
    del params
    res.update({"loss_ranks": loss, "ranks_step_s": ranks_s})
    want = None
    if rank == 0:
        wloss, wgrads, one_s = step(pol1, full)
        want = tree_leaves(wgrads)
        del full
        res.update({"loss_one_rank": wloss, "one_rank_step_s": one_s,
                    "loss_rel_err": abs(loss - wloss) / abs(wloss)})
    dist.barrier()
    errs = []
    for i, (g, spec) in enumerate(zip(tree_leaves(grads),
                                      spec_leaves(pol.tree_specs(shapes)))):
        g = pol.gather(g, spec)
        if rank == 0:
            errs.append(_rel(g, want[i]))
    del grads, want
    if rank == 0:
        res.update({"grad_leaves": len(errs),
                    "max_grad_rel_err": max(errs)})
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def _lm_moe_ranks(rank, mesh):
    """dbrx's MoE layer at full width on (2, 2), experts over the model
    axis, G = 2; rank 0 holds it against the one-rank layer with
    groups=2, and reports how far G = 1 lands from it."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.models import moe
    from repro_torch.models.common import dense_init
    from repro_torch.sharding.policy import make_policy, period_specs
    base = registry.get_config(LM_RANKS_MOE_ARCH)
    cfg = dataclasses.replace(base, num_layers=1, moe=dataclasses.replace(
        base.moe, capacity_factor=LM_RANKS_MOE_CF))
    pol = make_policy(mesh, global_batch=LM_RANKS_MOE_BATCH, ep_mode=True)
    spec = period_specs(pol, cfg)["l0"]["moe"]
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    leaves = (("router", (d, e), d), ("moe_gate", (e, d, f), d),
              ("moe_up", (e, d, f), d), ("moe_down", (e, f, d), f))

    def draw(keep):
        """init_moe_params's draws, one leaf whole at a time, each kept
        as ``keep`` makes it; then x."""
        gen = torch.Generator(device="cuda").manual_seed(2)
        out = {name: keep(name, dense_init(gen, shape, torch.float32,
                                           fan_in=fan))
               for name, shape, fan in leaves}
        return out, torch.randn((LM_RANKS_MOE_BATCH, LM_RANKS_MOE_SEQ, d),
                                generator=gen, device="cuda")
    local, x = draw(lambda name, w: pol.named(spec[name])(w))
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe.moe_mlp(cfg, pol.use_tree(local, spec),
                             _rank_rows(pol, x), pol)
        y = pol.gather(y, pol.act_hidden())
        torch.cuda.synchronize()
    # one call, its first: the FSDP gathers of the expert weights
    # (3.2 GB a rank) set its time
    res = {"first_call_ms": (time.perf_counter() - t0) * 1e3,
           "aux_ranks": float(aux)}
    del local
    dist.barrier()
    if rank == 0:        # the same draws, whole, once the ranks are done
        full, _ = draw(lambda name, w: w)
        with torch.no_grad():
            y2, aux2 = moe.moe_mlp(cfg, full, x, groups=2)
            y1, _ = moe.moe_mlp(cfg, full, x)
        res.update({"rel_err_vs_one_rank_g2": _rel(y, y2),
                    "aux_rel_err": abs(float(aux) - float(aux2))
                    / abs(float(aux2)),
                    "g1_vs_g2_rel": _rel(y1, y2)})
        del full, y1, y2
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def lm_rank_worker(rank, world, store):
    """One rank of phase 13 (see LM_RANKS_WORLD above). Rank 0's JSON line
    carries the checks; every rank's its times, collective bytes, peak
    memory and launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.compat import make_mesh
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    _build.library()                # built by the parent
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda:0")
    one = make_mesh((1, 1), ("data", "model"), device="cuda:0")
    out_dir = Path(store).parent
    t0 = time.perf_counter()
    res = {"rank": rank, "coordinate": mesh.coordinate}
    res["serve"] = _lm_serve_ranks(rank, mesh, one, counters)
    res["train"] = _lm_train_ranks(rank, mesh, counters)
    res["check"] = _lm_check_ranks(rank, mesh, one, out_dir)
    res["moe"] = _lm_moe_ranks(rank, mesh)
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    res["wall_s"] = time.perf_counter() - t0
    dist.barrier()
    print(json.dumps(res), flush=True)


def lm_ranks_phase(smi):
    """Phase 13: the LM substrate on LM_RANKS_WORLD ranks sharing the
    card. Returns the ranks' lines (rank 0 first)."""
    import torch
    out_dir = ROOT / "build" / "chip_smoke_lm_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    # what the earlier phases left cached goes back to the card first:
    # the four ranks need ~60 GB of it
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    try:
        ranks, wall = spawn_ranks("lm_ranks", LM_RANKS_WORLD, out_dir,
                                  timeout=LM_RANKS_TIMEOUT_S)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    serve, train, check, moe = (r0[k] for k in ("serve", "train", "check",
                                                "moe"))
    line = {
        "phase": "lm_ranks", "card": smi, "arch": SERVE_ARCH,
        "mesh": {"data": 2, "model": 2}, "ranks": LM_RANKS_WORLD,
        "backend": "gloo (CUDA tensors staged through host memory)",
        "layers": LM_RANKS_LAYERS, "wall_s": wall,
        "card_free_bytes_before": free, "card_total_bytes": total,
        "parent_reserved_bytes": torch.cuda.memory_reserved(),
        "serve": {"batch": LM_RANKS_BATCH, "prompt": LM_RANKS_PROMPT,
                  "tokens": LM_RANKS_TOKENS, **serve},
        "train": {"batch": LM_RANKS_TRAIN_BATCH, "seq": LM_RANKS_TRAIN_SEQ,
                  "compute_dtype": "bfloat16",
                  "steps": LM_RANKS_TRAIN_STEPS, **train},
        "check": {"layers": TRAIN_CHECK_LAYERS,
                  "batch": LM_RANKS_CHECK_BATCH, "seq": TRAIN_CHECK_SEQ,
                  "loss_chunks": TRAIN_CHECK_SEQ // TRAIN_CHECK_CHUNK,
                  **check},
        "moe": {"arch": LM_RANKS_MOE_ARCH, "batch": LM_RANKS_MOE_BATCH,
                "seq": LM_RANKS_MOE_SEQ, "capacity_factor": LM_RANKS_MOE_CF,
                "groups": 2, "ep_mode": True, **moe},
        "by_rank": [{"rank": r["rank"], "coordinate": r["coordinate"],
                     "peak_memory_bytes": r["peak_memory_bytes"],
                     "prefill_ms": r["serve"]["prefill_ms"],
                     "decode_ms_per_token":
                         r["serve"]["decode_ms_per_token"],
                     "train_ms_per_step": r["train"]["ms_per_step"],
                     "train_collective_bytes_per_step":
                         r["train"]["collective_bytes_per_step"],
                     "wall_s": r["wall_s"]} for r in ranks],
        "seconds": time.perf_counter() - t0}
    emit(line)
    assert serve["prefill_rel_err"] <= LM_RANKS_TOL, serve
    assert serve["teacher_forced_rel_err"] <= LM_RANKS_TOL, serve
    assert serve["tokens_equal"] and serve["first_token_equal"], serve
    assert check["loss_rel_err"] <= LM_RANKS_LOSS_TOL, check
    assert check["max_grad_rel_err"] <= LM_RANKS_TOL, check
    assert check["ckpt_sha256_equal"] and check["ckpt_restored_equal"], check
    assert moe["rel_err_vs_one_rank_g2"] <= LM_RANKS_TOL, moe
    assert moe["aux_rel_err"] <= LM_RANKS_LOSS_TOL, moe
    assert moe["g1_vs_g2_rel"] > 100 * LM_RANKS_TOL, moe
    for r in ranks:   # no kernel on this path: under a policy, no flash
        for part in ("serve", "train"):
            assert all(v == 0 for v in r[part]["launches"].values()), r
        assert r["serve"]["tokens"] == serve["tokens"], r
    return ranks


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
    from repro_torch.kernels.flash_attention import (BF16_HEAD_DIMS,
                                                     HEAD_DIMS,
                                                     flash_attention)

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
            sorted([FLASH_KERNELS[0]] * len(HEAD_DIMS)
                   + [FLASH_KERNELS[1]] * len(BF16_HEAD_DIMS)), sass
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
    # the shapes phase 11's families give the kernel past the reference's
    # Pallas kernel: zamba2's shared block at head_dim 80 (causal, MHA),
    # and whisper's cross-attention, 64 decoder queries against 1500
    # encoder keys (non-causal, a key length of its own)
    flash_hd80 = check_flash((FAMILY_BATCH, FAMILY_PROMPT, 32, 32, 80),
                             torch.float32, True, 0.0, gen)
    flash_cross = check_flash((FAMILY_BATCH, WHISPER_PROMPT, 16, 16, 64),
                              torch.float32, False, 0.0, gen,
                              sk=WHISPER_FRAMES)
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
    torch.cuda.empty_cache()
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

    # 8. transit: Fig. 2 in transit on four ranks, the monitored serve
    # with its monitor on a second rank
    transit_fig2, transit_serve = transit_phase(
        ROOT / "build" / "chip_smoke_transit", serve_report, monitored)
    shutil.rmtree(ROOT / "build" / "chip_smoke_transit", ignore_errors=True)

    # 9. the spectral solvers: NS2D 8192^2 and Boussinesq 512^3 on one
    # card, four ranks on the card, launch/solver.py in transit
    solvers = solver_phase(all_counters, gen)

    # 10. the elastic consumer mesh: shrink and grow at 8192^2 on four
    # ranks, launch/solver.py --elastic on three
    elastic = elastic_phase(gen)

    # 11. the model families past the dense decoders: MoE (grok-1, dbrx),
    # SSM (mamba2), hybrid (zamba2), enc-dec (whisper), VLM (internvl2)
    families = lm_families(all_counters, gen)

    # 12. the training path: qwen3-4b at full width (8 of 36 layers)
    # through make_train_step, the card's float32 step against the CPU's,
    # the 100m example, and launch/train.py's restart and transit runs
    training = train_phase(all_counters)

    # 13. the LM substrate across ranks: qwen3-4b served and trained on
    # the (2, 2) mesh of four ranks sharing the card, dbrx's MoE layer
    # with G = 2 dispatch groups
    lm_ranks = lm_ranks_phase(smi)

    def phase8_launches(name):
        """A kernel's launches on phase 8, by rank: Fig. 2 in transit
        (producers first) and the transit serve (rank 0 decodes)."""
        return {"transit_fig2_by_rank": [
                    {"role": r["role"], "launches": r["launches"][name]}
                    for r in transit_fig2],
                "transit_serve_by_rank": [r["launches"][name]
                                          for r in transit_serve]}

    def phase9_launches(name):
        """A kernel's launches on phase 9: each one-card solver's checked
        run and one step of it, rank 0's four-rank cases a run, and each
        rank of launch/solver.py in transit; and the solvers' FFT shapes
        held on it."""
        return {"solver_launches": {
                    "ns2d_taylor_green_run":
                        solvers["ns2d"]["taylor_green_launches"][name],
                    "ns2d_per_step":
                        solvers["ns2d"]["launches_per_step"][name],
                    "bq3d_beltrami_run":
                        solvers["bq3d"]["beltrami_launches"][name],
                    "bq3d_per_step":
                        solvers["bq3d"]["launches_per_step"][name],
                    "four_ranks_rank0": {r["case"]: r["launches_rank0"][name]
                                         for r in solvers["ranks"]},
                    "launch_transit_by_rank": [
                        r[name] for r in
                        solvers["launch"]["launches_by_rank"]]},
                "solver_shapes": [
                    {"shape": r["shape"], "axis": r.get("axis", -1),
                     "max_rel_err": max(r["max_rel_err"] or 0.0,
                                        r["inverse_max_rel_err"] or 0.0)
                     if r["plain_held"] else None,
                     "max_rel_err_vs_f64": max(r["rel_err_vs_f64"],
                                               r["inverse_rel_err_vs_f64"])}
                    for r in solvers["shape_checks"] if r["kernel"] == name]}

    def phase10_launches(name):
        """A kernel's launches on phase 10, by rank: the chaos scenario
        (producers first) and launch/solver.py --elastic; and the
        phase's FFT shapes held on it."""
        return {"elastic_launches": {
                    "chaos_by_rank": [r["launches"][name]
                                      for r in elastic["ranks"]],
                    "solver_by_rank": [r[name] for r in
                                       elastic["solver"]["launches_by_rank"]]},
                "elastic_shapes": [
                    {"shape": r["shape"], "axis": r.get("axis", -1),
                     "max_rel_err_vs_f64": max(r["rel_err_vs_f64"],
                                               r["inverse_rel_err_vs_f64"])}
                    for r in elastic["shape_checks"]
                    if r["kernel"] == name]}

    def flash_row(res, launches, launches_from):
        """A kernels-line row of the flash kernel at one of phase 11's
        shapes."""
        return {"name": "flash_attention", "route": "cuda",
                "source": csrc + "flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:95",
                "launches": launches, "launches_from": launches_from,
                "shape": res["shape"], "sk": res["sk"],
                "causal": res["causal"], "dtype": res["dtype"],
                **{k: res[k] for k in (
                    "max_abs_err", "plain_ms", "bound_ms", "bound_by",
                    "bound_note", "cuda_core_bound_ms", "library_ms",
                    "device_ms")},
                "ms": res["kernel_ms"]}

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
    kernels = [
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
             **phase8_launches("fft_fourstep"),
             **phase9_launches("fft_fourstep"),
             **phase10_launches("fft_fourstep"),
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
             **phase7_launches("fft_stockham"),
             **phase8_launches("fft_stockham"),
             **phase9_launches("fft_stockham"),
             **phase10_launches("fft_stockham")),
        dict(row("bandpass_filter", csrc + "bandpass.cu",
                 "src/repro/kernels/bandpass.py:53", bandpass[0]),
             device_ms=bandpass[0]["device_ms"],
             distributed_launches=dist_launches("bandpass_filter"),
             real_launches=real_path_launches("bandpass_filter"),
             **phase7_launches("bandpass_filter"),
             **phase8_launches("bandpass_filter"),
             **phase9_launches("bandpass_filter"),
             **phase10_launches("bandpass_filter")),
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
         **phase8_launches("flash_attention"),
         **phase9_launches("flash_attention"),
         **phase10_launches("flash_attention"),
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
        flash_row(flash_hd80, families["zamba2-2.7b"][
            "flash_launches_per_prefill"],
            "zamba2-2.7b serve main path (one 2048-token prefill, 9 "
            "hybrid layers of the shared block at head_dim 80)"),
        flash_row(flash_cross, families["whisper-medium"][
            "flash_calls_by_kind"]["cross"],
            "whisper-medium prefill's cross-attention (64 decoder "
            "queries against 1500 encoder keys, one a decoder layer)"),
    ]
    # phase 12's main path launches none: the training path runs under a
    # sharding policy, where attention takes the plain paths, and the
    # gradient monitor's rfft is torch.fft's, as the reference's is jnp's
    for k in kernels:
        k["train_launches"] = training["main"]["launches"][k["name"]]
        k["train_launches_from"] = (
            f"{TRAIN_ARCH} training main path ({TRAIN_STEPS} steps, "
            f"{TRAIN_LAYERS} layers): none by design")
        # phase 13 launches none either: serve and train run under a
        # policy across ranks, where attention takes the plain paths
        k["lm_ranks_launches"] = {
            part: [r[part]["launches"][k["name"]] for r in lm_ranks]
            for part in ("serve", "train")}
        k["lm_ranks_launches_from"] = (
            f"phase 13, by rank: {SERVE_ARCH} served and trained on the "
            f"(2, 2) mesh ({LM_RANKS_LAYERS} layers): none by design")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        worker = {"ranks": rank_worker, "transit": transit_worker,
                  "transit_serve": transit_serve_worker,
                  "solver_ranks": solver_rank_worker,
                  "solver_launch": solver_launch_worker,
                  "solver_restore": functools.partial(solver_launch_worker,
                                                      restore=True),
                  "elastic": elastic_worker,
                  "elastic_solver": elastic_solver_worker,
                  "train_procs": train_proc_worker,
                  "lm_ranks": lm_rank_worker,
                  }[args["--job"]]
        try:
            worker(int(args["--rank"]), int(args["--world"]),
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
