"""Batched serving + an in-situ chain on the serving activations, on the
PyTorch port (counterpart of ``examples/serve_bandpass_monitor.py``).

The "producer" is a greedy decode loop of h2o-danube-1.8b, the repo's
sliding-window config, served from a rolling KV cache of ``window``
slots a layer; every 8 tokens the logits (B, vocab) go through an
in-situ chain (stats → forward FFT → bandpass energies), whose
marshaling is accounted. The bandpass stage runs the hand-written
bandpass kernel on a CUDA tensor; decode runs eagerly (the reference
jits it).

By default the reduced config (window 32) runs batch 4, a 24-token
prompt and 40 tokens, so the cache wraps during decode; ``--full`` takes
the published width and depth. It runs on the CUDA card unless
``--device cpu`` is given; without a card it stops with an error that
names that flag.

Run:  PYTHONPATH=src python examples/serve_bandpass_monitor_torch.py
          [--full] [--prompt-len 24] [--tokens 40] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.core.insitu.bridge import BridgeData, GridMeta
from repro_torch.core.insitu.config import build_chain
from repro_torch.models import lm

ARCH = "h2o-danube-1.8b"
BATCH = 4                 # the reference's B
SEED = 0                  # the reference's PRNGKey(0)
EVERY = 8                 # tokens between two probes of the logits


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_inputs(cfg, S: int, device):
    """The weights and a (BATCH, S) prompt, seeded by SEED."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = lm.init_params(cfg, gen, torch.float32)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, S), generator=gen,
                           device=device)
    return params, prompt


def monitor(cfg, params, prompt, T: int, device, *, probe: bool = True
            ) -> dict:
    """Prefill ``prompt`` (B, S) into a cache of ``cfg.window`` slots a
    layer, then ``T`` greedy decode steps; every EVERY-th step's logits
    go through the chain unless ``probe`` is False. Returns the tokens
    (B, T), the prefill's last-position logits, each probe's [min, max,
    mean, std, rms] and high-frequency energy fraction, the cache's slots
    a layer, the chain's marshaling report, and the host ms of the
    prefill and of a decode step (to the device's end)."""
    prompt = torch.as_tensor(prompt, device=device)
    B = prompt.shape[0]
    _sync(device)
    t0 = time.perf_counter()
    logits, state = lm.prefill(cfg, params, {"tokens": prompt},
                               cache_len=cfg.window)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    chain = build_chain({
        "mode": "intransit",
        "chain": [
            {"endpoint": "stats", "array": "field"},
            {"endpoint": "fft", "array": "field", "direction": "forward",
             "local": True},
            {"endpoint": "bandpass", "array": "field", "keep_frac": 0.25},
        ],
    }, mesh=None, grid=GridMeta((B, cfg.vocab_size)))
    prefill_logits = logits
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    tokens, stats, hf = [], [], []
    t0 = time.perf_counter()
    for t in range(T):
        logits, state = lm.decode_step(cfg, params, tok, state)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        tokens.append(tok)
        if probe and t % EVERY == 0:
            out = chain.execute(BridgeData(arrays={"field": logits[:, 0, :]},
                                           step=t))
            kept = float(out.arrays["insitu_kept_energy"])
            tot = float(out.arrays["insitu_total_energy"])
            st = out.arrays["insitu_stats"].tolist()
            stats.append(st)
            hf.append(1 - kept / tot)
            print(f"tok {t:3d}: logit mean={st[2]:+.3f} std={st[3]:.3f} "
                  f"high-freq energy frac={1 - kept / tot:.3f}")
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(T, 1)
    window = next(iter(state["caches"].values())).k.shape[2]
    return {"tokens": torch.cat(tokens, 1).cpu(),
            "prefill_logits": prefill_logits, "stats": stats,
            "hf_frac": hf, "cache_window": window,
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "marshal": chain.marshaling_report()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the published width and depth (default: reduced)")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to serve on "
                           "the CPU")
    cfg = (registry.get_config(ARCH) if args.full
           else registry.get_reduced(ARCH))     # SWA arch: rolling cache
    params, prompt = make_inputs(cfg, args.prompt_len, args.device)
    res = monitor(cfg, params, prompt, args.tokens, args.device)
    print("decode finished; cache window:", res["cache_window"],
          "(rolling, = cfg.window)", f"marshal={res['marshal']}")
    assert len(res["hf_frac"]) == -(-args.tokens // EVERY)
    assert res["cache_window"] == cfg.window
    print("OK")
    return res


if __name__ == "__main__":
    main()
