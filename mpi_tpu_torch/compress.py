"""Compressed collectives — the port's own copy of ``mpi_tpu/compress.py``:
``fold_dtype`` (:116), the bf16 bit conversions (:129, :141), the wire
formats ``WireFormat`` / ``_Bf16`` / ``_Int8`` (:150-250), ``resolve``
(:281), ``topk_k`` (:270), ``reset_residuals`` (:318) and
``topk_allreduce`` (:325) with its error-feedback residual slots keyed by
``compress_key``.

The WIRE dtype is split from the FOLD dtype: ``algorithm="compressed"``
(``"compressed:bf16"`` / ``"compressed:int8"``) for ``allreduce`` and
``reduce_scatter`` encodes every pipeline segment at send time into a
wire-tagged raw frame (``transport/codec.py`` ``Encoded``) and decodes it
at its fold site, while the working buffer folds in float32 (float64 for
float64 payloads).  ``"compressed:topk"`` (allreduce, SUM only) ships each
rank's ``compress_topk_ratio`` largest-magnitude entries as (indices,
values) pairs around a ring, accumulated densely in the fold dtype, with
the unsent remainder kept per slot and added to the next same-slot
gradient (error feedback).

Every tensor stays on the payload's device: the encodings, the folds and
the residuals run there.  The int8 encode divides by the scale held in a
float32 tensor on the payload's device, so the card divides exactly as
numpy 2 does (``np.rint(x32 / scale)`` casts the Python-float scale to
float32 and divides); a CUDA ``div`` by a CPU scalar multiplies by the
reciprocal instead, which moves a mantissa by one at a rounding tie.
``torch.round`` rounds half to even like ``np.rint``.

bf16 segments ship as ``torch.bfloat16`` tensors (the reference ships the
same bits as uint16).  torch's float32 -> bfloat16 cast rounds to nearest
even like ``ml_dtypes``; a NaN keeps its position but not necessarily its
payload bits.

Group coherence: reductions require congruent payloads, so the
eligibility decision is a pure function of congruent inputs plus
process-wide cvars, and every rank declines (counted in
``compress_fallbacks``) or proceeds together.  The verifier's signature
carries the RESOLVED name (``"compressed:bf16"``, never the
``"compressed"`` alias) and top-k's k in its counts.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

import torch

from . import mpit as _mpit
from .transport import codec as _codec

# Process-wide knobs (cvars ``compress_wire_dtype`` /
# ``compress_topk_ratio``); they must agree across the group.
_WIRE_DTYPE = "bf16"
_TOPK_RATIO = 0.01

# resolve() marker for the sparsified path (an (indices, values) ring
# allgather, not a segment codec)
TOPK = object()

_FLOAT_DTYPES = frozenset({torch.float16, torch.bfloat16, torch.float32,
                           torch.float64})

# Reduction ops the dense wire formats accept: both encodings are
# monotone, so MAX/MIN stay meaningful; everything else declines.
_DENSE_OPS = frozenset({"sum", "max", "min"})


def fold_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a compressed collective: float64 payloads
    keep float64 folds, every other float folds in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# -- bf16 bit conversions -----------------------------------------------------


def f32_to_bf16_bits(x32: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 bit patterns (int16), round to nearest even."""
    return x32.to(torch.float32).to(torch.bfloat16).view(torch.int16)


def bf16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns (int16) -> float32 (exact)."""
    return bits.view(torch.bfloat16).to(torch.float32)


# -- wire formats -------------------------------------------------------------


class WireFormat:
    """One dense wire encoding: fold-dtype view -> raw segments and back.
    ``encode`` returns a codec ``Encoded`` of fresh tensors (safe on
    aliasing transports without a snapshot); ``decode`` accepts the
    ``Encoded`` a peer's frame rebuilt (or this format's raw segment list,
    the arena's slot path) and returns a flat fold-dtype tensor."""

    name: str = "?"

    def encode_segs(self, x: torch.Tensor) -> List[torch.Tensor]:
        raise NotImplementedError

    def decode_segs(self, segs: List[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def wire_nbytes(self, n: int, itemsize: int) -> int:
        """Encoded payload bytes for ``n`` fold-dtype elements (arena slot
        sizing; must match what ``encode_segs`` produces)."""
        raise NotImplementedError

    def encode(self, view: torch.Tensor) -> _codec.Encoded:
        segs = self.encode_segs(view)
        _mpit.count(bytes_compressed_saved=view.numel() * view.element_size()
                    - sum(s.numel() * s.element_size() for s in segs))
        return _codec.Encoded(self.name, segs)

    def decode(self, payload: Any) -> torch.Tensor:
        """Fold-site decode; a payload that is not this format's frame (a
        peer ran uncompressed, or a different wire dtype slipped past a
        disabled verifier) raises a TYPED error instead of misfolding."""
        if not (type(payload) is _codec.Encoded and payload.wire == self.name):
            raise TypeError(
                f"compressed collective expected a {self.name!r} wire "
                f"frame, got {type(payload).__name__}"
                f"{'' if type(payload) is not _codec.Encoded else ' ' + repr(payload.wire)}"
                " — is every rank running the same algorithm and "
                "compress_wire_dtype? (enable mpi_tpu_torch.verify to "
                "diagnose divergence before data moves)")
        return self.decode_segs(payload.segs)


class _Bf16(WireFormat):
    """bf16 wire: 2 bytes per element.  Exact for values already
    representable in bf16 (a bf16 input round-trips its first hop)."""

    name = "bf16"

    def encode_segs(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x.reshape(-1).to(torch.float32).to(torch.bfloat16)]

    def decode_segs(self, segs: List[torch.Tensor]) -> torch.Tensor:
        return segs[0].to(torch.float32)

    def wire_nbytes(self, n: int, itemsize: int) -> int:
        return 2 * n


class _Int8(WireFormat):
    """Scaled-int wire: a per-segment float32 max-abs scale and int8
    mantissas, 1 byte per element plus 4 per segment.  A non-finite
    segment ships as a raw float32 passthrough (scale ``[nan]``), so an
    overflowed gradient's inf/NaN reaches every rank unchanged."""

    name = "int8"

    def encode_segs(self, x: torch.Tensor) -> List[torch.Tensor]:
        x32 = x.reshape(-1).to(torch.float32).contiguous()
        amax = float(x32.abs().max()) if x32.numel() else 0.0
        if not math.isfinite(amax):
            return [torch.full((1,), math.nan, dtype=torch.float32,
                               device=x32.device), x32.clone()]
        scale = amax / 127.0 if amax > 0.0 else 1.0
        # the divisor is a float32 tensor on the payload's device: a true
        # float32 division, as numpy 2 computes x32 / scale
        s = torch.full((1,), scale, dtype=torch.float32, device=x32.device)
        q = torch.round(x32 / s).clamp_(-127, 127).to(torch.int8)
        return [s, q]

    def decode_segs(self, segs: List[torch.Tensor]) -> torch.Tensor:
        scale, q = segs
        if q.dtype != torch.int8:  # non-finite passthrough segment
            return q.to(torch.float32)
        return q.to(torch.float32) * scale.to(torch.float32)[0]

    def wire_nbytes(self, n: int, itemsize: int) -> int:
        return n + 4


BF16 = _Bf16()
INT8 = _Int8()
FORMATS = {f.name: f for f in (BF16, INT8)}

# The algorithm= spellings the communicator's gate accepts; top-k has no
# blockwise scatter semantics, so reduce_scatter takes the dense ones.
ALLREDUCE_NAMES = ("compressed", "compressed:bf16", "compressed:int8",
                   "compressed:topk")
REDUCE_SCATTER_NAMES = ("compressed", "compressed:bf16", "compressed:int8")


def is_compressed(algorithm: str) -> bool:
    return algorithm == "compressed" or algorithm.startswith("compressed:")


def _decline() -> None:
    _mpit.count(compress_fallbacks=1)


def _array_eligible(arr: Any) -> bool:
    return isinstance(arr, torch.Tensor) and arr.dtype in _FLOAT_DTYPES


def topk_k(n: int) -> int:
    """Selection count for an ``n``-element gradient: ceil(ratio * n), at
    least 1, clamped to n (a ratio >= 1 degrades to dense)."""
    if n <= 0:
        return 0
    return min(n, max(1, int(math.ceil(_TOPK_RATIO * float(n)))))


def resolve(comm, coll: str, payload: torch.Tensor, op,
            algorithm: str) -> Tuple[Any, str, Optional[Tuple]]:
    """The ``"compressed"`` half of the algorithm gate: ``(wire,
    resolved_algorithm, verify_counts)``.  ``wire`` is a
    :class:`WireFormat`, :data:`TOPK`, or None — a group-coherent decline
    (ineligible dtype or op, counted in ``compress_fallbacks``) that lands
    the caller on ``"auto"``.  Top-k's k rides ``verify_counts``."""
    kind = algorithm.split(":", 1)[1] if ":" in algorithm else _WIRE_DTYPE
    if kind == "topk":
        if not _array_eligible(payload) or op.name != "sum":
            _decline()
            return None, "auto", None
        return TOPK, "compressed:topk", (topk_k(int(payload.numel())),)
    fmt = FORMATS.get(kind)
    if fmt is None:
        raise ValueError(
            f"compress_wire_dtype cvar holds unknown format {kind!r}; "
            f"accepted: {sorted(FORMATS)}")
    if not _array_eligible(payload) or op.name not in _DENSE_OPS:
        _decline()
        return None, "auto", None
    return fmt, "compressed:" + fmt.name, None


# -- top-k sparsified allreduce ----------------------------------------------


def _idx_dtype(n: int) -> torch.dtype:
    return torch.int32 if n <= (1 << 31) - 1 else torch.int64


def reset_residuals(comm) -> None:
    """Drop the communicator's error-feedback residual slots."""
    comm.__dict__.pop("_compress_residuals", None)


def topk_allreduce(comm, arr: torch.Tensor, op,
                   compress_key: Any = None) -> torch.Tensor:
    """Sparsified SUM allreduce: local top-k selection by magnitude (after
    adding this slot's residual), then a P-1 ring allgather of every
    rank's (indices, values) pair — each hop one wire-tagged raw frame —
    added into a dense fold-dtype accumulator on every rank.  Selected
    indices are distinct, so each element gets at most one add per hop and
    the folds run in ring-hop order on every rank.  The slot key is
    (compress_key, dtype, shape, op); the residual is this rank's private
    fold-dtype copy on the payload's device."""
    from .communicator import _TAG_COLL

    shape = tuple(arr.shape)
    fdt = fold_dtype(arr.dtype)
    x = arr.detach().reshape(-1).to(fdt).clone()
    n = x.numel()
    k = topk_k(n)
    store = comm.__dict__.setdefault("_compress_residuals", {})
    key = ("allreduce", compress_key, _codec.dtype_name(arr.dtype), shape,
           op.name)
    residual = store.get(key)
    if residual is not None and residual.shape == x.shape:
        x += residual
    idt = _idx_dtype(n)
    if k >= n:
        idx = torch.arange(n, dtype=torch.int64, device=x.device)
    elif k:
        idx = torch.topk(x.abs(), k, sorted=False).indices
    else:
        idx = torch.zeros(0, dtype=torch.int64, device=x.device)
    vals = x[idx].to(torch.float32)
    residual = x  # our private copy becomes the residual
    # peers receive the float32-cast values: the residual keeps the cast's
    # remainder too (exactly 0 for float32 folds)
    residual[idx] = residual[idx] - vals.to(fdt)
    store[key] = residual
    out = torch.zeros(n, dtype=fdt, device=x.device)
    out[idx] += vals.to(fdt)
    p, r = comm.size, comm.rank
    if p > 1:
        right, left = (r + 1) % p, (r - 1) % p
        payload = _codec.Encoded("topk", [idx.to(idt), vals])
        itemsize = torch.empty(0, dtype=fdt).element_size()
        dense = 2 * (p - 1) * n * itemsize // max(1, p)
        _mpit.count(bytes_compressed_saved=dense
                    - (p - 1) * int(payload.nbytes))
        for _ in range(p - 1):
            got = comm._sendrecv_internal(payload, right, left, _TAG_COLL)
            if not (type(got) is _codec.Encoded and got.wire == "topk"):
                raise TypeError(
                    f"compressed:topk expected a 'topk' wire frame, got "
                    f"{type(got).__name__} — is every rank running "
                    f"compressed:topk with the same compress_topk_ratio?")
            gi, gv = got.segs
            gi = gi.to(device=out.device, dtype=torch.int64)
            out[gi] += gv.to(device=out.device, dtype=fdt)
            payload = got  # forward the received pair around the ring
    return out.to(arr.dtype).reshape(shape)
