"""chip_smoke.py's phase 15 (the launch tools) alone on the card: the
kernels built, then ``chip_smoke.launch_phase``: qwen3-4b's prefill,
decode and train cells from ``launch/specs.build_cell`` on a one-rank
mesh at published width against their fake traces, and
``launch/fft_dryrun``'s cells on the four-step kernels, printing each
cell's JSON line after the card's name and power limit.

Run from the repository root, on a machine with a CUDA card:
    python3 tools/launch_probe.py
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("launch_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    counters = {"fft_fourstep": ops.fft_fourstep,
                "fft_stockham": ops.fft_stockham,
                "bandpass_filter": ops.bandpass_filter,
                "flash_attention": flash_attention}
    chip_smoke.launch_phase(counters, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
