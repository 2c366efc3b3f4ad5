"""Model configuration dataclasses (a copy of ``repro/configs/base.py``;
the port keeps its own, since it imports nothing of the reference).

Every assigned architecture is expressed as a :class:`ModelConfig`. The
fields deliberately cover the union of the features in the assigned pool
(GQA, qk-norm, qkv-bias, logit softcap, sliding windows, local/global
alternation, MoE, SSD state spaces, enc-dec, hybrid shared-attention,
stub modality frontends) so a single model zoo serves all ten configs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # "tp": expert weights tensor-parallel over the model axis (used when
    #       num_experts does not divide the model axis, e.g. grok-1 E=8).
    # "ep": experts sharded over the model axis, tokens dispatched with an
    #       all_to_all (used when num_experts == model axis, e.g. dbrx E=16).
    mode: str = "tp"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # TP implementation detail: compute with this many heads (extra heads
    # are hard-zeroed before the out-projection, so the model stays exactly
    # the published one); lets e.g. 40 heads shard on a 16-way axis as 48.
    pad_heads_to: Optional[int] = None

    # attention variants
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window: Optional[int] = None              # sliding-window size (SWA)
    layer_pattern: Tuple[str, ...] = ("full",)  # repeating per-layer kinds
    # pattern entries: "full" | "swa" | "ssm" | "hybrid"

    # norm / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"                         # silu | gelu
    post_norm: bool = False                   # gemma2-style post block norms
    embed_scale: bool = False                 # gemma2 scales embeds by sqrt(d)

    # mixture of experts
    moe: Optional[MoEConfig] = None

    # state-space (mamba2 / zamba2)
    ssm: Optional[SSMConfig] = None
    attn_every: Optional[int] = None          # zamba2: shared attn period

    # enc-dec (whisper)
    encoder_layers: int = 0
    decoder_layers: int = 0
    max_source_positions: int = 1500

    # modality frontend stubs
    frontend: Optional[str] = None            # "vit_stub" | "audio_stub"
    num_patches: int = 256                    # VLM: image tokens per sample

    # sub-quadratic? decides whether long_500k applies
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def heads_padded(self) -> int:
        return self.pad_heads_to or self.num_heads

    # ---- parameter counting (for MODEL_FLOPS = 6 N D) -------------------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or active, for MoE) parameter count, embeddings included."""
        d, hd = self.d_model, self.head_dim
        nh, nkv, f = self.num_heads, self.num_kv_heads, self.d_ff

        def attn_params() -> int:
            p = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            if self.qkv_bias:
                p += (nh + 2 * nkv) * hd
            return p

        def mlp_params(ff: int) -> int:
            n_in = 2 if self.act in ("silu", "geglu") else 1  # gated acts
            return n_in * d * ff + ff * d

        def moe_params(active: bool) -> int:
            assert self.moe is not None
            e = self.moe.top_k if active else self.moe.num_experts
            return e * mlp_params(f) + d * self.moe.num_experts  # + router

        def ssm_params() -> int:
            assert self.ssm is not None
            di = self.ssm.expand * d
            nheads = di // self.ssm.head_dim
            g = self.ssm.n_groups
            in_proj = d * (2 * di + 2 * g * self.ssm.d_state + nheads)
            conv = self.ssm.d_conv * (di + 2 * g * self.ssm.d_state)
            out_proj = di * d
            return in_proj + conv + out_proj + 2 * nheads  # + A_log, D

        total = self.vocab_size * d  # embeddings
        if not self.tie_embeddings:
            total += self.vocab_size * d  # LM head

        if self.family == "encdec":
            enc = self.encoder_layers * (attn_params() + mlp_params(f) + 2 * d)
            dec = self.decoder_layers * (2 * attn_params() + mlp_params(f) + 3 * d)
            return total + enc + dec + self.max_source_positions * d

        for i in range(self.num_layers):
            kind = self.layer_pattern[i % len(self.layer_pattern)]
            if kind == "ssm":
                total += ssm_params() + d
            else:
                total += attn_params() + 2 * d
                if self.moe is not None:
                    total += moe_params(active_only)
                else:
                    total += mlp_params(f)
        if self.family == "hybrid" and self.attn_every:
            # one shared attention+mlp block (counted once; reused)
            total += attn_params() + mlp_params(f) + 2 * d
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
