"""Quickstart — the paper's Fig. 2 workflow on the PyTorch port
(counterpart of ``examples/quickstart.py``).

Producer (noisy radiating source) → forward FFT → bandpass (keep the
low-frequency corners) → inverse FFT → visualize. Every stage is a
configured endpoint; swap the config dict to rewire the chain at runtime
(the paper's XML role). Host visualization interleaves the device
stages, so the chain runs in staged ("intransit") mode. The ``local``
FFT endpoints take ``torch.fft`` (the reference's take ``jnp.fft``); the
bandpass stage runs the hand-written bandpass kernel on a CUDA tensor.

It runs on the CUDA card unless ``--device cpu`` is given; without a
card it stops with an error that names that flag.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--n 200]
          [--device cpu]
The panels and the array dump go to ``$QUICKSTART_OUT`` (default
``results/quickstart``).
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
from repro_torch.core.insitu.config import build_chain


def chain_config(out: str) -> dict:
    return {
        "mode": "intransit",          # host viz interleaves device stages
        "chain": [
            {"endpoint": "visualize", "array": "field", "out_dir": out,
             "prefix": "a_noisy"},                             # Fig. 2a
            {"endpoint": "fft", "array": "field", "direction": "forward",
             "local": True},
            {"endpoint": "visualize", "array": "field", "out_dir": out,
             "prefix": "b_spectrum", "log_scale": True},       # Fig. 2b
            {"endpoint": "bandpass", "array": "field", "keep_frac": 0.05},
            {"endpoint": "visualize", "array": "field", "out_dir": out,
             "prefix": "c_filtered", "log_scale": True},       # Fig. 2c
            {"endpoint": "fft", "array": "field", "direction": "backward",
             "local": True},
            {"endpoint": "visualize", "array": "field", "out_dir": out,
             "prefix": "d_denoised"},                          # Fig. 2d
            {"endpoint": "writer", "array": "field", "out_dir": out},
        ],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200,
                    help="grid side (default 200, the reference's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    out_dir = os.environ.get("QUICKSTART_OUT", "results/quickstart")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run the "
                           "quickstart on the CPU")

    producer = RadiatingSourceAdaptor(dims=(args.n, args.n),
                                      device=args.device)
    data = producer.produce(step=0)
    chain = build_chain(chain_config(out_dir), mesh=None, grid=data.grid)
    out = chain.execute(data)

    clean = data.arrays["clean_reference"].cpu().numpy()
    noisy = data.arrays["field"].cpu().numpy()
    denoised = out.arrays["field"].cpu().numpy()
    mse0 = float(np.mean((noisy - clean) ** 2))
    mse1 = float(np.mean((denoised - clean) ** 2))
    kept = float(out.arrays["insitu_kept_energy"])
    total = float(out.arrays["insitu_total_energy"])
    files = chain.finalize()   # every endpoint reports (dup names keyed #idx)
    n_images = sum(len(v.get("files", ())) for k, v in files.items()
                   if k.startswith("visualize"))
    report = chain.marshaling_report()
    print(f"MSE noisy     : {mse0:.4f}")
    print(f"MSE denoised  : {mse1:.4f}   ({mse0 / mse1:.1f}x better)")
    print(f"kept energy   : {kept:.3e} / {total:.3e}")
    print(f"images        : {n_images} (4 stages) + "
          f"{len(files['writer']['files'])} array dump -> {out_dir}")
    print("report:", report)
    assert mse1 < 0.5 * mse0, "bandpass failed to denoise"
    assert n_images >= 4, "a visualize stage lost its output"
    return {"n": args.n, "mse0": mse0, "mse1": mse1, "kept_energy": kept,
            "total_energy": total, "n_images": n_images,
            "files": files, "report": report, "denoised": denoised}


if __name__ == "__main__":
    main()
