"""Pencil-decomposed 3-D FFT on a mesh of ranks, on the PyTorch port
(counterpart of ``examples/distributed_fft_3d.py``) — the paper's §5
scaling goal, end to end: synthetic turbulence-like field → forward
pencil FFT (two all-to-all rotations) → isotropic energy spectrum (the
in-situ science product) → spectral low-pass → inverse → error check;
then the r2c/c2r pencil and the transpose-free pencil.

The mesh is the world's: ``(1, 1)`` in one process, ``(P/2, 2)`` over
the P ranks of a cluster (``tools/launch_multihost_torch.py --nprocs 4
-- python examples/distributed_fft_3d_torch.py``). Each rank holds its
block of every field: the spectrum is each block's shell sums, summed
over the ranks, and the checks read the fields gathered from every
rank. It runs on the CUDA card unless ``--device cpu`` is given; without
a card it stops with an error that names that flag.

Run:  PYTHONPATH=src python examples/distributed_fft_3d_torch.py
          [--n 64] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.fft import distributed as D
from repro_torch.core.fft import rfft
from repro_torch.core.fft.filters import apply_filter, radial_lowpass_mask
from repro_torch.core.fft.plan import (BACKWARD, FORWARD, plan_cache_stats,
                                       plan_dft, plan_rfft)
from repro_torch.core.fft.spectrum import shell_bins, shell_sums
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.cluster import init_cluster

NBINS = 24
TOL = 1e-3


def make_field(n: int, seed: int = 0) -> np.ndarray:
    """The synthetic multi-scale field: a sum of shells plus noise."""
    N = (n, n, n)
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(m) for m in N], indexing="ij")
    field = sum(np.sin(2 * np.pi * k * (x + 2 * y + 3 * z) / N[0]) / k
                for k in (2, 4, 8, 16))
    field += 0.3 * rng.standard_normal(N)
    return field.astype(np.float32)


def radial_spectrum_blocks(fr, fi, mesh, spec, shape, nbins: int = NBINS):
    """E(k), the mean power a |k| shell, from this rank's block (under
    ``spec``) of a natural-order spectrum: each block's shell sums,
    summed over the mesh's ranks."""
    cut = D._slices(mesh, spec, shape, mesh.coordinate)
    bins, kmax = shell_bins(shape, nbins, cut)
    e, cnt = shell_sums(fr, fi, bins, nbins)
    if mesh.size > 1:
        e, cnt = D.sum_over_blocks(torch.stack([e, cnt]), mesh, spec)
    centers = torch.linspace(0, float(kmax), nbins)
    return centers, (e / torch.clamp(cnt, min=1.0)).float().cpu()


def run(mesh, n: int, field=None, *, verbose: bool = True) -> dict:
    """Every stage on ``mesh`` at n³ (collective over its ranks). Returns
    the gathered products and the errors the checks read."""
    say = print if verbose else (lambda *a, **k: None)
    N = (n, n, n)
    field = make_field(n) if field is None else field
    say(f"mesh {dict(mesh.shape)}, grid {N}")

    fwd = plan_dft(N, FORWARD, mesh, decomp="pencil")
    inv = plan_dft(N, BACKWARD, mesh, decomp="pencil")
    spec = fwd.schedule().out_spec
    say(f"plan: {fwd.decomp} over axes {fwd.axis_names} "
        f"(input spec {fwd.schedule().in_spec})")

    fr, fi = fwd.execute(*fwd.place(field))

    # in-situ science product: isotropic energy spectrum E(k)
    k_centers, e_k = radial_spectrum_blocks(fr, fi, mesh, spec, N)
    say("energy spectrum (k, E):")
    for k, e in list(zip(k_centers.tolist(), e_k.tolist()))[1:9]:
        say(f"  k={k:6.1f}  E={e:.3e}")

    # low-pass in the pencil output layout (natural index): this rank's
    # block of the mask
    mask = D.shard(radial_lowpass_mask(N, 0.15), mesh, spec)
    fr2, fi2 = apply_filter(fr, fi, mask)
    br, _ = inv.execute(fr2, fi2)
    smooth = inv.unplace(br).cpu().numpy()

    # checks: roundtrip without filter is exact; filtering reduces variance
    br0, _ = inv.execute(fr, fi)
    back0 = inv.unplace(br0).cpu().numpy()
    err = float(np.max(np.abs(back0 - field)))
    say(f"roundtrip max err : {err:.2e}")
    say(f"variance raw      : {field.var():.4f}")
    say(f"variance filtered : {smooth.var():.4f}")
    assert err < TOL
    assert smooth.var() < field.var()

    # the real-input path: the r2c pencil plan does the same science on
    # the Hermitian half-spectrum, half the FFT work and wire bytes
    rfwd = plan_rfft(N, FORWARD, mesh, decomp="pencil")
    rinv = plan_rfft(N, BACKWARD, mesh, decomp="pencil")
    hr, hi = rfwd.execute(*rfwd.place(field))
    h = rfft.half_bins(N[2])
    half = rfwd.unplace(hr, hi)
    half = (half[0].cpu().numpy() + 1j * half[1].cpu().numpy())[..., :h]
    ref = np.fft.rfftn(field)
    r2c_err = float(np.max(np.abs(half - ref)) / np.max(np.abs(ref)))
    back = rinv.unplace(rinv.execute(hr, hi)).cpu().numpy()
    rt_err = float(np.max(np.abs(back - field)))
    hp = rfft.padded_half(N[2], mesh.shape["model"])
    say(f"r2c vs np.fft.rfftn rel err : {r2c_err:.2e}")
    say(f"r2c->c2r roundtrip max err  : {rt_err:.2e}")
    say(f"wire planes: c2c {N[2]} -> r2c {hp} "
        f"({N[2] / hp:.2f}x fewer bytes per all_to_all)")
    assert r2c_err < TOL and rt_err < TOL

    # transpose-free pencil: the second full rotation becomes a four-step
    # exchange; the x-sharding never moves, the output lands in a
    # documented digit-permuted layout along axis 0
    P0 = mesh.shape["data"]
    field_cyc = field[D.cyclic_order(N[0], P0)]      # required input layout
    tf_fwd = plan_dft(N, FORWARD, mesh, decomp="pencil_tf")
    tf_inv = plan_dft(N, BACKWARD, mesh, decomp="pencil_tf")
    tr, ti = tf_fwd.execute(*tf_fwd.place(field_cyc))
    perm = D.fourstep_freq_of_position(N[0], P0)
    tf_out = tf_fwd.unplace(tr, ti)
    tf_out = tf_out[0].cpu().numpy() + 1j * tf_out[1].cpu().numpy()
    ref_tf = np.fft.fftn(field)[perm]                # documented output map
    tf_err = float(np.max(np.abs(tf_out - ref_tf)) / np.max(np.abs(ref_tf)))
    tb, _ = tf_inv.execute(tr, ti)
    tf_rt = float(np.max(np.abs(tf_inv.unplace(tb).cpu().numpy()
                                - field_cyc)))
    say(f"transpose-free pencil vs permuted fftn : {tf_err:.2e}")
    say(f"transpose-free roundtrip max err       : {tf_rt:.2e}")
    say(f"output spec stays x-sharded: {tf_fwd.schedule().out_spec}")
    assert tf_err < TOL and tf_rt < TOL

    # plans are cached process-wide: re-planning is free
    again = plan_rfft(N, FORWARD, mesh, decomp="pencil")
    assert again is rfwd
    stats = plan_cache_stats()
    say("plan cache:", stats)
    return {"mesh": dict(mesh.shape), "n": n, "k": k_centers.numpy(),
            "e_k": e_k.numpy(), "smooth": smooth, "half": half,
            "pencil_tf": tf_out, "perm": np.asarray(perm), "P0": P0,
            "roundtrip_err": err, "r2c_err": r2c_err,
            "r2c_roundtrip_err": rt_err, "pencil_tf_err": tf_err,
            "pencil_tf_roundtrip_err": tf_rt, "plan_cache": stats}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64,
                    help="grid side (default 64, the reference's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run the "
                           "3-D FFT on the CPU")
    init_cluster(device=args.device)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    # (1, 1) in one process, (P/2, 2) over a world of P ranks
    mesh = make_host_mesh((max(1, world // 2), 2), device=args.device)
    lead = not torch.distributed.is_initialized() \
        or torch.distributed.get_rank() == 0
    res = run(mesh, args.n, verbose=lead)
    if lead:
        print("OK")
    return res


if __name__ == "__main__":
    main()
