"""Wire codecs — compressed transport formats for distribution exchanges
(counterpart of ``repro/core/fft/wire.py``).

A distributed FFT across nodes is bound by its all_to_all bytes, not by
its local FLOPs. ``schedule.AllToAll`` treats the wire *dtype* as a plan
knob (``wire_dtype="bfloat16"`` halves the bytes); a wire **codec**
goes further: the exchange encodes its payload (int8 + per-block float32
scales), moves the encoded parts, and decodes on arrival. Compute stays
float32; only the wire is lossy, and each codec documents an elementwise
error bound that the planner's error-budget gate (``plan.py``,
``wire_tol``) checks against the exact wire before a codec may win a
measured sweep.

========== ===================== =========================== =========
name       wire format           elementwise error bound     bytes/elt
========== ===================== =========================== =========
``bf16``   bfloat16 cast         ``2^-8 · |x|``              2
``int8``   int8 + 1 scale/row    ``absmax_row / 254``        1 + 4/n
``int8_blockB`` int8 + 1 scale   ``absmax_block / 254``      1 + 4/B
           per B-elt block
========== ===================== =========================== =========

(``absmax`` is the largest magnitude over the scaling span; ``row`` is
the whole last axis; any ``int8_block<B>`` name parses.) Rounding is
half to even in both packages (``torch.round``, ``jnp.round``), so the
port's payloads and scales are bit-identical to the reference's on the
same input.

Complex payloads travel as interleaved re/im planes
(``interleave_complex``), so a block's scale covers adjacent complex
samples. ``AllToAll`` moves a codec's parts as ONE packed byte buffer
through a single ``all_to_all_single`` (``pack_wire``/``unpack_wire``):
each shard's slice of the buffer holds its payload bytes, then its
scale bytes. ``encode_wire`` requires the last axis to be a multiple of
the block size, so blocks stay whole through the exchange, and raises
``ValueError`` otherwise (the planner's sweep records that as a skipped
candidate); standalone ``encode``/``decode`` accept any shape through a
zero-padded trailing block.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple

import torch

# absmax guard: a zero block must decode to zeros, not NaN
_EPS = 1e-12

# bfloat16 has 7 explicit mantissa bits -> round-to-nearest relative
# error <= 2^-8; the absolute term covers float32 values below bf16's
# smallest subnormal (which flush to zero on cast)
BF16_REL_BOUND = 2.0 ** -8
BF16_ABS_GUARD = 1e-38

# int8 absmax: scale = absmax/127, round error <= scale/2 = absmax/254
INT8_REL_BOUND = 0.5 / 127.0


def interleave_complex(x) -> torch.Tensor:
    """Complex (..., n) -> real (..., 2n) with re/im interleaved."""
    parts = torch.stack([x.real, x.imag], dim=-1)
    return parts.reshape(*x.shape[:-1], 2 * x.shape[-1]).float()


def deinterleave_complex(y) -> torch.Tensor:
    """Inverse of ``interleave_complex``: real (..., 2n) -> complex."""
    p = y.reshape(*y.shape[:-1], y.shape[-1] // 2, 2)
    return torch.complex(p[..., 0], p[..., 1])


def nblocks(n: int, block: Optional[int]) -> int:
    """Scale count for a length-``n`` last axis: ``ceil(n / block)``, or
    1 when ``block`` is None (one scale spans the axis)."""
    if block is None:
        return 1
    return -(-int(n) // int(block))


def _is_complex(dtype) -> bool:
    return dtype.is_complex if isinstance(dtype, torch.dtype) else False


class WireCodec:
    """One compressed wire format: ``encode(x)`` returns the tensors that
    travel (payload first), ``decode(parts, dtype)`` reconstructs. Every
    part has the payload's rank, so an exchange applies the same
    split/concat axes to each."""

    name: str = "?"

    def encode(self, x) -> Tuple:
        raise NotImplementedError

    def decode(self, parts: Tuple, dtype=torch.float32):
        raise NotImplementedError

    def encode_wire(self, x) -> Tuple:
        return self.encode(x)

    def max_error(self, x):
        """Elementwise bound on ``|decode(encode(x)) - x|`` for real
        ``x`` (for complex payloads, apply it to the interleaved view)."""
        raise NotImplementedError

    def wire_bytes(self, shape, dtype=torch.float32) -> int:
        """Bytes this codec puts on the wire for one array."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Bf16Codec(WireCodec):
    """The reduced-precision wire as a codec: one bfloat16 cast, no side
    payload. Error: ``2^-8 · |x|`` per element."""
    name: str = "bf16"

    def encode(self, x):
        if x.is_complex():
            x = interleave_complex(x)
        return (x.to(torch.bfloat16),)

    def decode(self, parts, dtype=torch.float32):
        (y,) = parts
        if _is_complex(dtype):
            return deinterleave_complex(y.float()).to(dtype)
        return y.to(dtype)

    def max_error(self, x):
        return BF16_REL_BOUND * torch.as_tensor(x).abs() + BF16_ABS_GUARD

    def wire_bytes(self, shape, dtype=torch.float32) -> int:
        n = math.prod(int(s) for s in shape)
        if _is_complex(dtype):
            n *= 2
        return 2 * n


@dataclasses.dataclass(frozen=True)
class Int8Codec(WireCodec):
    """Absmax int8 with per-block float32 scales over the last axis.

    ``block=None`` scales each whole last-axis row with one factor;
    ``block=B`` scales every B-element chunk on its own, so an outlier
    coarsens only its own block. Error bound: ``|decode(encode(x)) - x|
    <= absmax_span / 254`` per element, the span being the element's
    scaling block."""
    name: str = "int8"
    block: Optional[int] = None

    def _blocked(self, x):
        """(zero-padded blocks view (..., nb, b), true last extent)."""
        n = x.shape[-1]
        b = n if self.block is None else int(self.block)
        nb = nblocks(n, b)
        pad = nb * b - n
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        return x.reshape(*x.shape[:-1], nb, b), n

    def block_scales(self, x):
        """The per-block scales (shape ``x.shape[:-1] + (nb,)``)."""
        blocks, _ = self._blocked(torch.as_tensor(x).float())
        return (blocks.abs().amax(dim=-1) + _EPS) / 127.0

    def encode(self, x):
        if x.is_complex():
            x = interleave_complex(x)
        x = x.float()
        blocks, n = self._blocked(x)
        scales = (blocks.abs().amax(dim=-1) + _EPS) / 127.0
        q = torch.clamp(torch.round(blocks / scales[..., None]), -127, 127)
        q = q.reshape(*x.shape[:-1], blocks.shape[-2] * blocks.shape[-1])
        return q[..., :n].to(torch.int8), scales

    def encode_wire(self, x):
        n = int(x.shape[-1])
        if self.block is not None and n % int(self.block):
            raise ValueError(
                f"wire codec {self.name}: last-axis extent {n} is not a "
                f"multiple of the block size {self.block}: blocks would "
                f"not stay whole through the tiled all_to_all")
        return self.encode(x)

    def decode(self, parts, dtype=torch.float32):
        q, scales = parts
        n = q.shape[-1]
        nb = scales.shape[-1]
        # block span: the codec's block size, or (block=None) the span
        # each scale has after the exchange: a concat along the last axis
        # turns one scale a source row into nb scales, each spanning that
        # source's row extent
        b = int(self.block) if self.block is not None else n // max(nb, 1)
        rep = torch.repeat_interleave(scales.float(), b, dim=-1)[..., :n]
        out = q.float() * rep
        if _is_complex(dtype):
            return deinterleave_complex(out).to(dtype)
        return out.to(dtype)

    def max_error(self, x):
        scales = self.block_scales(x)
        n = x.shape[-1]
        b = n if self.block is None else int(self.block)
        return 0.5 * torch.repeat_interleave(scales, b, dim=-1)[..., :n]

    def wire_bytes(self, shape, dtype=torch.float32) -> int:
        shape = tuple(int(s) for s in shape)
        last = shape[-1] if shape else 1
        rows = math.prod(shape[:-1]) if len(shape) > 1 else 1
        if _is_complex(dtype):
            last *= 2
        return rows * last + 4 * rows * nblocks(last, self.block)


def exact_bytes(shape, dtype=torch.float32) -> int:
    """The exact-wire baseline: one float32 (complex64, ...) copy."""
    return math.prod(int(s) for s in shape) * dtype.itemsize


# ---------------------------------------------------------------------------
# Wire packing — all encoded parts ride ONE collective
# ---------------------------------------------------------------------------

def as_bytes(p) -> torch.Tensor:
    """View a tensor as uint8 along a widened last axis (little-endian
    bytes, as the reference's bitcast gives them)."""
    return p.contiguous().view(torch.uint8)


def from_bytes(b, dtype) -> torch.Tensor:
    """Inverse of ``as_bytes``: uint8 (..., nbytes) -> ``dtype``."""
    return b.contiguous().view(dtype)


def pack_wire(parts: Tuple, shards: int, *, split_last: bool,
              concat_last: bool) -> Tuple:
    """Pack encoded parts into ONE uint8 buffer for a single tiled
    all_to_all, so a codec's wire is one collective of one size.

    When the exchange SPLITS the last axis (``split_last``), the packed
    last axis is ``shards`` contiguous segments, each holding one shard's
    slice of every part, so the tiled split hands every shard exactly its
    own payload and scale bytes; each part's last extent must then be a
    multiple of ``shards`` (``ValueError`` otherwise). When the exchange
    CONCATS along the last axis, the received buffer holds ``shards``
    packed segments, which ``unpack_wire`` splices back. Returns
    ``(packed, meta)``; ``meta`` goes to ``unpack_wire``."""
    k = int(shards) if split_last else 1
    segs, spec = [], []
    for p in parts:
        n = int(p.shape[-1])
        if n % k:
            raise ValueError(
                f"wire pack: part last-axis extent {n} is not a multiple "
                f"of the {k} exchange shards: parts would not stay "
                f"aligned through the tiled all_to_all")
        segs.append(as_bytes(p.reshape(*p.shape[:-1], k, n // k)))
        spec.append((p.dtype, n))
    packed = torch.cat(segs, dim=-1)
    packed = packed.reshape(*packed.shape[:-2],
                            packed.shape[-2] * packed.shape[-1])
    m = int(shards) if concat_last else 1
    return packed, (tuple(spec), k, m)


def unpack_wire(packed, meta) -> Tuple:
    """Inverse of ``pack_wire``, after the exchange: the per-part tensors
    as per-part all_to_alls would have delivered them."""
    spec, k, m = meta
    seg_bytes = sum(d.itemsize * n for d, n in spec) // k
    seg = packed.reshape(*packed.shape[:-1], m, seg_bytes)
    parts, off = [], 0
    for dtype, n in spec:
        nb = dtype.itemsize * n // k
        piece = from_bytes(seg[..., off:off + nb], dtype)
        off += nb
        parts.append(piece.reshape(*piece.shape[:-2],
                                   piece.shape[-2] * piece.shape[-1]))
    return tuple(parts)


# ---------------------------------------------------------------------------
# Registry — codec names are the hashable plan-knob currency
# ---------------------------------------------------------------------------

DEFAULT_BLOCK = 64

_BLOCK_NAME = re.compile(r"^int8_block(\d+)$")

_REGISTRY: Dict[str, WireCodec] = {
    "bf16": Bf16Codec(),
    "int8": Int8Codec("int8", None),
    f"int8_block{DEFAULT_BLOCK}": Int8Codec(f"int8_block{DEFAULT_BLOCK}",
                                            DEFAULT_BLOCK),
}


def get_codec(name: str) -> WireCodec:
    """Resolve a codec name (``bf16`` / ``int8`` / ``int8_block<B>``).
    Raises ``ValueError`` for anything else: dtype names such as
    ``"bfloat16"`` are not codecs; they stay on the plain wire-dtype
    cast path."""
    codec = _REGISTRY.get(name)
    if codec is not None:
        return codec
    m = _BLOCK_NAME.match(name or "")
    if m:
        b = int(m.group(1))
        if b < 1:
            raise ValueError(f"wire codec block size must be >= 1: {name}")
        codec = Int8Codec(name, b)
        _REGISTRY[name] = codec
        return codec
    raise ValueError(f"unknown wire codec {name!r}; known: "
                     f"{sorted(_REGISTRY)} plus any int8_block<B>")


def is_codec(name) -> bool:
    """True when ``name`` names a wire codec (vs a plain wire dtype)."""
    if not isinstance(name, str):
        return False
    return name in _REGISTRY or bool(_BLOCK_NAME.match(name))


def codec_names() -> Tuple[str, ...]:
    """The stock codec names (stable order, for sweeps and docs)."""
    return ("bf16", "int8", f"int8_block{DEFAULT_BLOCK}")
