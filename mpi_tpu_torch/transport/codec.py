"""Payload framing of the byte-stream transport (socket) — the port's own
copy of ``mpi_tpu/transport/codec.py``: ``raw_eligible`` (:73),
``as_raw_array`` / ``as_raw_segments`` (:91-112), ``Encoded`` (:114),
the raw meta (:161-241), ``alloc_raw`` (:251), ``parse_raw_body``
(:283), ``pack_pickle_body`` (:313) and ``value_copy`` (:319).

Two frame formats ride the same length-prefixed stream, told apart by the
top bit of the u64 length word (``RAW_FLAG``):

* pickle frames — any picklable envelope ``(ctx, tag, obj)``;
* raw frames — a tensor ships as a tiny pickled meta ``(ctx, tag,
  dtype_name, shape)`` followed by its bytes, never pickled; a plain list
  of tensors ships as ONE multi-segment raw frame, meta ``(ctx, tag,
  [(dtype_name, shape), ...])`` then every segment's bytes back to back;
* wire-tagged raw frames — an :class:`Encoded` payload (a compressed
  collective's segment in its wire encoding, ``compress.py``) ships its
  segments like the multi-segment frame, with the encoding's name as a
  fourth meta field: ``(ctx, tag, [(dtype_name, shape), ...], wire)``,
  told apart from the single-tensor 4-tuple by its third element being a
  list.  The receiver rebuilds an ``Encoded`` with the same tag, so the
  payload stays encoded up to the fold site.

The meta carries torch dtype NAMES (``"float32"``, ``"bfloat16"``; numpy
has no bfloat16, so the reference's ``dtype.str`` cannot describe one)
and no device: the receiver allocates on its own device.  A CPU tensor's
bytes go to the socket straight from its memory; a CUDA tensor is first
staged into host memory by a blocking copy, complete before the frame is
written and before the engine's next in-place fold can rewrite the
working buffer it came from.

Eligibility is an exact-type rule: ``type(x) is torch.Tensor``.
Subclasses (``nn.Parameter`` and others) carry state a raw frame cannot
represent and take the pickle path, as ndarray subclasses do in the
reference.  Non-contiguous tensors are compacted first (counted in
``payload_copies``).  Every frame build counts into ``bytes_raw_sent`` /
``bytes_pickled_sent``.
"""

from __future__ import annotations

import copy
import pickle
import struct
from typing import Any, List, Optional, Tuple, Union

import torch

from .. import mpit as _mpit
from .. import recvpool as _recvpool
from ..bufpool import byte_view

# u64 length word: top bit = raw frame, low bits = body length
RAW_FLAG = 1 << 63
META = struct.Struct("<I")  # meta-pickle length prefix inside a raw body

_PROTO = pickle.HIGHEST_PROTOCOL


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(dtype)[len("torch."):]


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"raw frame names an unknown dtype {name!r}")
    return dt


def raw_eligible(payload: Any) -> bool:
    """Whether a payload can ship as raw bytes: an exact ``torch.Tensor``
    with strided dense layout."""
    return type(payload) is torch.Tensor and payload.layout == torch.strided


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    if t.is_contiguous():
        return t
    _mpit.count(copies=1)  # compact a strided view
    return t.contiguous()


def as_raw_array(payload: Any) -> Optional[torch.Tensor]:
    """The contiguous tensor to ship raw, or None → use pickle."""
    if raw_eligible(payload):
        return _contiguous(payload)
    return None


def _is_plain_raw_list(payload: Any) -> bool:
    """Plain non-empty ``list``, every element raw-eligible, no element
    twice (pickle's memo keeps that aliasing on the receiver; independent
    raw segments could not) — the ONE predicate behind the wire path and
    the self-send copy."""
    return (type(payload) is list and bool(payload)
            and all(raw_eligible(item) for item in payload)
            and len({id(item) for item in payload}) == len(payload))


def as_raw_segments(payload: Any) -> Optional[List[torch.Tensor]]:
    """The contiguous tensors of a list payload to ship as ONE
    multi-segment raw frame, or None → use pickle (tuples, empty and mixed
    lists keep the pickle path for type fidelity)."""
    if not _is_plain_raw_list(payload):
        return None
    return [_contiguous(item) for item in payload]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def stage(t: torch.Tensor):
    """The host bytes that go on the wire for contiguous tensor ``t``: the
    tensor itself on the CPU (retained by reference, see bufpool.py), or
    an immutable byte view of a host copy for a device tensor.  The copy
    is blocking, so it is complete when this returns."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=torch.cuda.is_available())
    host.copy_(t)
    return byte_view(host)


class Encoded:
    """A payload in a WIRE encoding distinct from its fold dtype: ``segs``
    are the contiguous tensors that ship back to back in one wire-tagged
    raw frame, ``wire`` names the encoding (a ``compress.py`` format) so
    the receiving fold site knows how to decode.  The codec only moves
    it; ``compress.py`` owns what the bytes mean."""

    __slots__ = ("wire", "segs")

    def __init__(self, wire: str, segs: List[torch.Tensor]):
        self.wire = wire
        self.segs = segs

    @property
    def nbytes(self) -> int:
        """Wire payload size (probe/Status sizing: ``payload_nbytes``
        duck-types on this attribute)."""
        return sum(_nbytes(s) for s in self.segs)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Encoded({self.wire!r}, "
                f"{[(dtype_name(s.dtype), tuple(s.shape)) for s in self.segs]})")


def pack_raw_frame(ctx, tag: int, payload: Any):
    """The raw-frame plan for ``payload``: ``(head, bufs)`` where ``head``
    is the length-prefixed meta and ``bufs`` the host buffers whose bytes
    follow it on the wire — or None → the payload must ride pickle."""
    if type(payload) is Encoded:
        segs = [_contiguous(s) for s in payload.segs]
        return (pack_raw_wire_meta(ctx, tag, segs, payload.wire),
                tuple(stage(s) for s in segs))
    arr = as_raw_array(payload)
    if arr is not None:
        return pack_raw_meta(ctx, tag, arr), (stage(arr),)
    segs = as_raw_segments(payload)
    if segs is not None:
        return pack_raw_segs_meta(ctx, tag, segs), tuple(stage(s) for s in segs)
    return None


def pack_raw_meta(ctx, tag: int, arr: torch.Tensor) -> bytes:
    """``<u32 meta_len><meta pickle>`` — everything in the raw body except
    the tensor bytes themselves."""
    meta = pickle.dumps((ctx, tag, dtype_name(arr.dtype), tuple(arr.shape)),
                        protocol=_PROTO)
    _mpit.count(bytes_raw=_nbytes(arr))
    return META.pack(len(meta)) + meta


def pack_raw_segs_meta(ctx, tag: int, segs: List[torch.Tensor]) -> bytes:
    """Multi-segment meta ``(ctx, tag, [(dtype_name, shape), ...])``: a
    3-tuple, told apart from the single-tensor 4-tuple by arity."""
    meta = pickle.dumps(
        (ctx, tag, [(dtype_name(a.dtype), tuple(a.shape)) for a in segs]),
        protocol=_PROTO)
    _mpit.count(bytes_raw=sum(_nbytes(a) for a in segs))
    return META.pack(len(meta)) + meta


def pack_raw_wire_meta(ctx, tag: int, segs: List[torch.Tensor],
                       wire: str) -> bytes:
    """Wire-tagged meta ``(ctx, tag, [(dtype_name, shape), ...], wire)``:
    a 4-tuple whose third element is a LIST, told apart from the
    single-tensor 4-tuple (third element a str) by type."""
    meta = pickle.dumps(
        (ctx, tag, [(dtype_name(a.dtype), tuple(a.shape)) for a in segs],
         wire), protocol=_PROTO)
    _mpit.count(bytes_raw=sum(_nbytes(a) for a in segs))
    return META.pack(len(meta)) + meta


RawPayload = Union[torch.Tensor, List[torch.Tensor], Encoded]


def parse_raw_meta(meta: bytes) -> Tuple[Any, int, tuple]:
    """Decode a raw frame's meta WITHOUT allocating destinations: (ctx,
    tag, plan), plan ``("arr", dtype_name, shape)`` for a single tensor,
    ``("segs", descs)`` for a multi-segment frame and ``("wire", descs,
    wire)`` for a wire-tagged one.  The socket reader consults the
    steering registry with the plan before any allocation."""
    tup = pickle.loads(meta)
    if len(tup) == 4 and isinstance(tup[2], str):
        return tup[0], tup[1], ("arr", tup[2], tuple(tup[3]))
    descs = [(ds, tuple(sh)) for ds, sh in tup[2]]
    if len(tup) == 4:
        return tup[0], tup[1], ("wire", descs, tup[3])
    return tup[0], tup[1], ("segs", descs)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _descs(plan: tuple):
    return [plan[1:]] if plan[0] == "arr" else plan[1]


def plan_nbytes(plan: tuple) -> int:
    """Total body bytes a parsed plan describes (frame-length check)."""
    return sum(_numel(shape) * dtype_of(ds).itemsize
               for ds, shape in _descs(plan))


def alloc_raw(plan: tuple, device) -> List[torch.Tensor]:
    """Host destinations to read a parsed plan's body into, in fill order
    — the path of a frame that was not steered into a posted receive's
    destination.  Bound for the CPU they are the delivered tensors
    themselves; bound for a card, pooled host buffers
    (:class:`recvpool.RecvPool`) that ``finish_raw`` copies from."""
    if torch.device(device).type == "cpu":
        return [torch.empty(shape, dtype=dtype_of(ds)) for ds, shape in _descs(plan)]
    return [_recvpool.RECV_POOL.empty(shape, dtype_of(ds))
            for ds, shape in _descs(plan)]


def _assemble(plan: tuple, out: List[torch.Tensor]) -> RawPayload:
    if plan[0] == "arr":
        return out[0]
    return Encoded(plan[2], out) if plan[0] == "wire" else out


def finish_raw(plan: tuple, host: List[torch.Tensor], device) -> RawPayload:
    """The delivered payload of a frame read into ``host``: on the CPU the
    host tensors themselves; on a card a copy there, after which the
    pooled host buffers go back to the pool.  A wire-tagged plan comes
    back as an :class:`Encoded` with the frame's tag."""
    if torch.device(device).type == "cpu":
        out = host
    else:
        out = [h.to(device) for h in host]
        for h in host:
            _recvpool.RECV_POOL.give_back(h)
    return _assemble(plan, out)


def parse_raw_body(body: bytes, device="cpu") -> Tuple[Any, int, RawPayload]:
    """Decode an entire raw body held in memory: meta prefix + tensor
    bytes → (ctx, tag, tensor-or-list) on ``device``, each a fresh copy."""
    (mlen,) = META.unpack_from(body)
    ctx, tag, plan = parse_raw_meta(body[META.size:META.size + mlen])
    off = META.size + mlen
    out = []
    for ds, shape in _descs(plan):
        dt = dtype_of(ds)
        n = _numel(shape) * dt.itemsize
        raw = torch.frombuffer(bytearray(body[off:off + n]), dtype=torch.uint8) \
            if n else torch.empty(0, dtype=torch.uint8)
        out.append(raw.view(dt).reshape(shape).to(device))
        off += n
    return ctx, tag, _assemble(plan, out)


def pack_pickle_body(ctx, tag: int, obj: Any) -> bytes:
    blob = pickle.dumps((ctx, tag, obj), protocol=_PROTO)
    _mpit.count(bytes_pickled=len(blob))
    return blob


def value_copy(payload: Any) -> Any:
    """Self-send copy with message (value) semantics: a tensor is cloned
    on its own device (detached: a message carries values, not a graph),
    elementwise for the multi-segment list shape; everything else takes a
    pickle round trip, as a peer send would."""
    if raw_eligible(payload):
        _mpit.count(copies=1)
        return payload.detach().clone()
    if type(payload) is Encoded:
        _mpit.count(copies=len(payload.segs))
        return Encoded(payload.wire, [s.clone() for s in payload.segs])
    if _is_plain_raw_list(payload):
        _mpit.count(copies=len(payload))
        return [item.detach().clone() for item in payload]
    _mpit.count(copies=1)
    return pickle.loads(pickle.dumps(payload, protocol=_PROTO))


def local_copy(payload: Any) -> Any:
    """The local transport's copy: tensors as ``value_copy`` (on their
    device), everything else deep-copied, as the reference's local
    transport does."""
    if raw_eligible(payload):
        return payload.detach().clone()
    if type(payload) is Encoded:
        return Encoded(payload.wire, [s.clone() for s in payload.segs])
    if _is_plain_raw_list(payload):
        return [item.detach().clone() for item in payload]
    return copy.deepcopy(payload)
