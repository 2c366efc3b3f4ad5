"""Training on the card, outside the whole of chip_smoke.py.

By default: ``chip_smoke.measure_train`` for one model config (bf16
compute under a one-rank policy, each step timed to its loss, one
profiled step's device time, peak memory, the kernels' launches), at
full width and the depth asked for, printed as one JSON line. With
``--phase``: chip_smoke.py's phase 12 (``train_phase``) alone.

Run from the repository root, on a machine with a CUDA card:
    python3 tools/train_probe.py [--arch qwen3-4b] [--layers N]
        [--batch 8] [--seq 512] [--steps 4]
    python3 tools/train_probe.py --phase
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (default: the config's own)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--phase", action="store_true",
                    help="run chip_smoke.py's phase 12 instead")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs import registry
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.library()
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    if args.phase:
        chip_smoke.train_phase(counters)
        return 0
    cfg = registry.get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    res = chip_smoke.measure_train(counters, cfg, args.batch, args.seq,
                                   args.steps, args.lr,
                                   chip_smoke.TRAIN_INSITU_EVERY)
    res.pop("insitu")
    print(json.dumps({"arch": args.arch, "layers": cfg.num_layers,
                      "of_layers": registry.get_config(args.arch)
                      .num_layers, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
