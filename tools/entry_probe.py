"""chip_smoke.py's phase 16 (the entry points outside the package) alone
on the card: the kernels built, phase 4's float64 oracle of the Fig. 2
chain at the quickstart's grids, then ``chip_smoke.entry_points_phase``
(the quickstart at 200² and 8192², h2o-danube-1.8b at published width
under the logits monitor, the 3-D FFT example on one rank and on four
through the launcher's passthrough, the wisdom CLI cold and warm),
printing each call's JSON line after the card's name and power limit.
``--elastic`` also runs phase 10 (the launcher's elastic demo at 8192²
and ``launch/solver.py --elastic``).

Run from the repository root, on a machine with a CUDA card:
    python3 tools/entry_probe.py [--elastic]
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("entry_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    chip_smoke.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--elastic" in sys.argv[1:]:
        chip_smoke.elastic_phase(gen)
    fig2 = {}
    for dims in chip_smoke.ENTRY_QUICKSTART:
        want = chip_smoke.oracle(dims)
        fig2[dims] = {k: want[k] for k in ("denoised", "energies")}
    chip_smoke.entry_points_phase(gen, fig2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
