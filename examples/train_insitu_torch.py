"""End-to-end training with the in-situ spectral monitor attached, on the
PyTorch port (counterpart of ``examples/train_insitu.py``).

The training job is the "simulation" of the paper's processing chain:
per-layer gradient spectra are computed on the device inside the train
step (no host round trip), alongside checkpoints, restart-on-failure
and straggler monitoring. The spectra are also persisted through a
**pipelined** host-offload chain: the .npy writes ride the background
pipeline worker and overlap the next train step.

Presets:
  cpu    (default) — ~5M-param qwen3-family model, 200 steps at batch
                     8 x 128 (a few minutes with ``--device cpu``).
  100m             — ~115M-param model, 300 steps at batch 8 x 512.

Both train on the CUDA card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/train_insitu_torch.py [--preset 100m]
          [--device cpu]
"""
import argparse
import sys

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_mod


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="repro-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=3072,
        vocab_size=32000, qk_norm=True, layer_pattern=("full",),
        act="silu")


def model_cpu() -> ModelConfig:
    return ModelConfig(
        name="repro-5m", family="dense", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=512,
        vocab_size=4096, qk_norm=True, layer_pattern=("full",),
        act="silu")


def register(cfg: ModelConfig) -> None:
    """Make ``cfg`` an arch of the registry, so the shared driver can
    look it up by name."""
    mod = sys.modules[__name__]
    mod.CONFIG = cfg
    mod.reduced = lambda: cfg
    registry.ARCH_MODULES[cfg.name] = __name__


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["cpu", "100m"], default="cpu")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--out", default="results",
                    help="directory for the checkpoints and spectra")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    cfg = model_cpu() if args.preset == "cpu" else model_100m()
    register(cfg)
    steps = args.steps or (200 if args.preset == "cpu" else 300)
    seq = 128 if args.preset == "cpu" else 512
    batch = 8
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
          f"for {steps} steps, batch {batch} x seq {seq} on {args.device}")
    out = train_mod.main([
        "--arch", cfg.name, "--steps", str(steps),
        "--batch", str(batch), "--seq", str(seq),
        "--lr", "6e-3", "--ckpt-dir", f"{args.out}/train_insitu_ckpt",
        "--ckpt-every", "50", "--insitu-every", "10",
        "--insitu-spectra-dir", f"{args.out}/train_insitu_spectra",
        "--device", args.device,
    ])
    assert out["final_loss"] < out["first_loss"] - 0.5, \
        "loss did not improve"
    assert out["spectra_files"] > 0, "pipelined spectra writer wrote nothing"
    print("training improved loss "
          f"{out['first_loss']:.3f} -> {out['final_loss']:.3f}; "
          f"restarts={out['restarts']}; "
          f"spectra files={out['spectra_files']} "
          f"(host-offload backpressure "
          f"{out['spectra_backpressure_ms']:.1f} ms)")
    return out


if __name__ == "__main__":
    main()
