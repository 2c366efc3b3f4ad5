"""chip_smoke.py's phase 13 (the LM substrate across ranks) alone on the
card: the kernels built, then ``chip_smoke.lm_ranks_phase`` — qwen3-4b
served and trained on the (2, 2) mesh of four ranks sharing the card,
dbrx's MoE layer with two dispatch groups — printing its JSON line
after the card's name and power limit.

Run from the repository root, on a machine with a CUDA card:
    python3 tools/lm_ranks_probe.py
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_ranks_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    chip_smoke.lm_ranks_phase(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
