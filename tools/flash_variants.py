#!/usr/bin/env python3
"""Time design variants of the port's flash-attention kernel on one card.

Each variant is the tree's ``src/repro_torch/kernels/csrc`` with a few
lines of ``flash_attention.cu`` replaced, built into its own library
under ``build/flash_variants/`` and timed at the qwen3-4b prefill shape
(4, 2048, 32, 8, 128), causal, in float32 and bf16, by CUDA events
(median of 10 after 2 warm-ups, ``chip_smoke.time_ms``). Some variants
drop work and give wrong results on purpose, to show what that work
costs: each line carries its maximum error against the plain version.
The tree runs first and last, so the spread of one build shows.

Run from the repository root on a machine with a CUDA card:

    python3 tools/flash_variants.py
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHAPE = (4, 2048, 32, 8, 128)
SOURCE = "flash_attention.cu"

# name -> (what it shows, [(text in the tree, replacement)])
VARIANTS = {
    "tree": ("the kernel as built", []),
    "one_tf32_product": (
        "float32 with hi.hi only (wrong: TF32 accuracy): what the other "
        "two products cost", [
            ("for (int c = 0; c < kChunks; ++c) mma_tf32(s[c], al, "
             "bh[c][0], bh[c][1]);", ""),
            ("for (int c = 0; c < kChunks; ++c) mma_tf32(s[c], ah, "
             "bl[c][0], bl[c][1]);", ""),
            ("          mma_tf32(acc[n0 + n], al, bh[n][0], bh[n][1]);\n"
             "#pragma unroll\n        for (int n = 0; n < kGroup; ++n)\n"
             "          mma_tf32(acc[n0 + n], ah, bl[n][0], bl[n][1]);",
             "          mma_tf32(acc[n0 + n], ah, bh[n][0], bh[n][1]);")]),
    "no_split": (
        "float32 operands not split (wrong): what the splits cost", [
            ("hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
             "  lo = __float_as_uint(x - __uint_as_float(hi));",
             "hi = __float_as_uint(x);\n  lo = hi;")]),
    "truncated_hi": (
        "float32 hi by truncation (one instruction less a split)", [
            ("hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             "hi = __float_as_uint(x) & 0xffffe000u;")]),
    "bf16_one_cta_an_sm": (
        "bf16 without the 128-register cap (no spill, one CTA an SM)", [
            ("template <int HD>\n__global__ void __launch_bounds__"
             "(kThreads, 2)",
             "template <int HD>\n__global__ void __launch_bounds__"
             "(kThreads, 1)")]),
}


def build_variant(name, edits):
    from repro_torch.kernels import _build
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    dst = ROOT / "build" / "flash_variants" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    text = (dst / SOURCE).read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{name}: text not in {SOURCE}: {old[:60]!r}")
        text = text.replace(old, new)
    (dst / SOURCE).write_text(text)
    _build.CSRC, _build._LIB = dst, None
    return _build.library()


def measure(name, gen):
    import torch
    from chip_smoke import time_ms
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    B, S, H, KV, hd = SHAPE
    out = {"variant": name, "what": VARIANTS[name][0], "shape": list(SHAPE),
           "causal": True}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda")
                   .to(dtype) for n in (H, KV, KV))
        err = float((flash_attention(q, k, v).float()
                     - flash_attention_ref(q, k, v).float()).abs().max())
        tag = str(dtype).split(".")[-1]
        out[f"{tag}_ms"] = time_ms(lambda: flash_attention(q, k, v))
        out[f"{tag}_max_abs_err"] = err
        del q, k, v
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in [*VARIANTS, "tree"]:
        build_variant(name, VARIANTS[name][1])
        print(json.dumps(measure(name, gen)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
