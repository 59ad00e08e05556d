"""The Communicator — rank/size bookkeeping, point-to-point, collectives,
split — the port's own copy of ``mpi_tpu/communicator.py``.

* :class:`Communicator` (:887-1245) is the abstract surface user MPI
  programs are written against; the SPMD ``gpu.TorchCommunicator`` and the
  host :class:`P2PCommunicator` both inherit it.
* :class:`P2PCommunicator` (:1249) runs over any point-to-point Transport
  (``transport/local.py`` threads, ``transport/socket.py`` processes):
  send / recv / probe / requests (:1326-1960) and the collectives of the
  segmented engine (bcast :2007, reduce :2087, allreduce :2122 with ring
  :2421, recursive halving :2450, Rabenseifner :2484 and reduce+bcast,
  allgather :2512, alltoall :2635, barrier :2725, scan :2747,
  reduce_scatter :2826, scatter/gather :2985-3030), split/dup/create
  (:3204-3237).
* The progress engine's hooks (``progress.py``): engine-side completion
  of posted receives (:658-708), ``_progress_wait_request`` (:1544), the
  registration of posted queues (:1815-1822), the segmented engine's
  engine-advanced send window ``_SegSender`` (:342) and the engine's
  ``stop`` (:3441).
* Nonblocking collectives (:3265-3385): ``ibcast``, ``ireduce``,
  ``iallreduce``, ``iallgather``, ``ialltoall``, ``ibarrier``,
  ``iscatter``, ``igather`` — schedule state machines on worlds with a
  progress engine (``nbc.py``), else one ``_ThreadRequest`` thread per
  call on an isolated context — and the persistent ``allreduce_init``,
  ``bcast_init``, ``alltoall_init``, ``reduce_scatter_init``
  (:3387-3421).
* Fault tolerance (ULFM, ``ft.py``): with ``_ft`` attached every blocking
  wait runs in slices that re-check the detector and the revocation flag
  (``_sliced_wait`` :1432, ``_empty_poll_check`` :1618), and ``revoke``,
  ``shrink``, ``agree``, ``get_failed``, ``failure_ack``,
  ``failure_get_acked``, ``membership_epoch`` and ``accept_rejoin``
  (:3032-3200) recover from a death.
* The runtime verifier (``verify/``), behind ``_verify is None``: the
  collective-signature check ``_verify_coll`` and ``_track_request``
  (:1975-2005), the verify branch of the sliced waits (:1352-1560), the
  request and buffer tracking of ``isend``, ``irecv(buf=)`` and
  ``isendrecv_replace`` (:1690-1760), ``_inherit_verify`` on ``dup`` /
  ``split`` / ``create`` and the free lint (:3227-3300, :3429).
* The flight recorder (``telemetry/``), behind ``telemetry.REC is
  None``: ``_traced_coll`` on the ten collectives, ``_trace_nbytes`` and
  ``_note_alg`` (:242-300), and the blocked-wait spans.

Payloads are ``torch.Tensor``s and stay on the device they live on: the
engine's working buffers are made on the payload's device and every fold
is an in-place torch op there (``ReduceOp.combine_into``).  A non-tensor
payload of a reduction (a Python scalar, a numpy array) becomes a tensor
on ``comm.device`` — so ``comm.allreduce(1)`` returns a 0-d tensor where
the reference returns a numpy scalar.  bcast / p2p / allgather / alltoall
carry arbitrary picklable objects as well.

API conventions (MPI-1.x semantics, pythonic spelling): comm-rank space
everywhere; user tags are ints >= 0 and the wildcards ANY_SOURCE /
ANY_TAG are -1; internal traffic (collectives, barrier, shift) uses
negative tags that user wildcards never match.

Streams: every host thread (a rank thread, the progress engine, the
fold pool, a nonblocking collective's thread) launches on its device's
default stream, so host order is launch order.  A nonblocking collective
issued under a side stream first makes the default stream wait on the
caller's stream (its inputs were produced there) and is issued on the
default stream; ``wait()``/``test()`` completion makes the caller's
current stream wait on the default stream.

The same-host data plane and its dispatch: on an shm transport the
collective arena (``coll_sm.py``, ``algorithm="sm"``, and the arena-first
tier of ``"auto"``, :2009-2216); the compressed algorithms
(``compress.py``, ``"compressed*"``, encoded segments through the
segmented engine's wire seam, :2281-2447, and ``_SegSender``'s
encode-on-send :342); tuned dispatch (``tuning/``, consulted by every
``"auto"`` decision of allreduce, reduce_scatter and alltoall); and the
one-sided windows ``win_create`` / ``win_create_dynamic`` (``window.py``
``P2PWindow`` / ``DynamicWindow``, :1960-1971).
"""

from __future__ import annotations

import contextlib
import functools
import pickle
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bufpool as _bufpool
from . import coll_sm as _coll_sm
from . import compress as _compress
from . import mpit as _mpit
from . import ops as _ops
from . import recvpool as _recvpool
from . import schedules
from . import telemetry as _telemetry
from . import tuning as _tuning
from .transport import codec as _codec
from .errors import ProcFailedError, RevokedError
from .transport.base import (ANY_SOURCE, ANY_TAG, RecvTimeout, Transport,
                             TransportError, bind_thread_device,
                             payload_nbytes)

# allreduce "auto": latency-optimal recursive halving below this size on
# power-of-two groups (mpit cvar allreduce_ring_crossover_bytes) ...
_RING_CROSSOVER_BYTES = 512 << 10
# ... and the Rabenseifner composition at or above this size, the classic
# ring in between (cvar allreduce_rabenseifner_crossover_bytes).  Both are
# the reference's constants, kept so "auto" picks the same schedules.
_RABENSEIFNER_CROSSOVER_BYTES = 1 << 20

# Segmented collective engine: element ranges larger than the segment
# size ship as several frames so the receiver's fold of segment k overlaps
# the transport moving segment k+1.  0 = ask the transport
# (coll_segment_hint); the collective_segment_bytes cvar sets a nonzero
# override.  _SEG_WINDOW bounds how many segments a rank sends ahead of
# its receive pointer.
_SEGMENT_BYTES = 0
_SEG_WINDOW = 4
# Arrays below this stay on the single-message bcast path (the segmented
# tree costs one header message per edge and an assemble copy).
_BCAST_SEGMENT_MIN_BYTES = 1 << 20
# Below this TOTAL size reduce_scatter keeps the simple per-chunk ring; a
# nonzero collective_segment_bytes lowers the gate to payloads spanning
# more than one configured segment.
_RS_SEGMENT_MIN_BYTES = 1 << 20

_TAG_COLL = -2
_TAG_SHIFT = -3
_TAG_BARRIER = -4

# Slice of the fault-tolerant and engine-parked blocking waits (ft.POLL_S).
_FT_POLL_S = 0.05

class _SegHeader:
    """Wire announcement of a segmented tree broadcast (the root's choice):
    the result geometry plus the segment count.  Pickled by class
    identity, so no user payload can collide with it."""

    __slots__ = ("dtype_name", "shape", "nseg")

    def __init__(self, dtype_name: str, shape: Tuple[int, ...], nseg: int):
        self.dtype_name = dtype_name
        self.shape = shape
        self.nseg = nseg


class Status:
    """Result metadata for a receive (MPI_Status): ``count_bytes`` is the
    payload's size when it is a sized buffer, None for opaque pickled
    objects (MPI_UNDEFINED).  Set by receives and by probe/iprobe."""

    __slots__ = ("source", "tag", "count_bytes")

    def __init__(self) -> None:
        self.source = ANY_SOURCE
        self.tag = ANY_TAG
        self.count_bytes: Optional[int] = None

    def _fill(self, source: int, tag: int, payload: Any) -> None:
        self.source = source
        self.tag = tag
        self.count_bytes = payload_nbytes(payload)

    def _fill_envelope(self, source: int, tag: int,
                       count_bytes: Optional[int] = None) -> None:
        self.source = source
        self.tag = tag
        self.count_bytes = count_bytes

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Status(source={self.source}, tag={self.tag})"


def _check_user_tag(tag: int) -> None:
    if tag != ANY_TAG and tag < 0:
        raise ValueError(f"user tags must be >= 0 (got {tag}); negative tags are reserved")


def seed_allreduce_algorithm(nbytes: int, size: int) -> str:
    """The ``auto`` allreduce pick: the Rabenseifner composition at or
    above its crossover, recursive halving for small payloads on
    power-of-two groups, the ring otherwise."""
    if nbytes >= _RABENSEIFNER_CROSSOVER_BYTES:
        return "rabenseifner"
    if schedules.is_pow2(size) and nbytes < _RING_CROSSOVER_BYTES:
        return "recursive_halving"
    return "ring"


def _resolve_algorithm(coll: str, algorithm: str, real: Tuple[str, ...],
                       aliases: dict) -> str:
    """The ONE ``algorithm=`` gate of the host collectives: aliases are
    explicit, real names pass through, anything else raises the same
    error everywhere, listing every accepted value (``"sm"`` is a real
    name only on an arena-capable transport, ``coll_sm.gate``)."""
    if algorithm in aliases:
        resolved = aliases[algorithm]
    elif algorithm in real:
        resolved = algorithm
    else:
        accepted = sorted(set(real) | set(aliases))
        raise ValueError(
            f"unknown {coll} algorithm {algorithm!r}; accepted: {accepted}")
    rec = _telemetry.REC
    if rec is not None:
        # the one gate every host collective passes: stamp the RESOLVED
        # algorithm into the open trace span
        rec.note_algorithm(resolved)
    return resolved


def _trace_nbytes(obj: Any) -> Optional[int]:
    """Cheap payload-size guess for a collective trace span (tracing-on
    path only): tensors and arrays report nbytes, list payloads
    (alltoall/scatter) sum their sized elements, opaque objects None."""
    n = getattr(obj, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, (list, tuple)):
        total = 0
        for item in obj:
            total += getattr(item, "nbytes", 0) or 0
        return total or None
    return None


def _note_alg(algorithm: str) -> str:
    """Stamp the FINAL concrete algorithm into the open trace span (the
    gate passes ``"auto"`` through; each dispatch point calls this once
    the pick is real).  Returns its argument."""
    rec = _telemetry.REC
    if rec is not None:
        rec.note_algorithm(algorithm)
    return algorithm


def _traced_coll(fn):
    """Collective begin/end tracing (``telemetry/``).  Off: ONE module
    attribute test before the undecorated call.  On: a span with the
    collective's name, its requested then resolved algorithm, the payload
    bytes, its duration (host time: on the card the device work it queued
    may still run after the span ends) and the error class on a raising
    exit; completed spans also feed the ``coll_latency_s`` histogram and
    ``profiling.comm_stats()``."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        rec = _telemetry.REC
        if rec is None:
            return fn(self, *args, **kwargs)
        cell = rec.coll_begin(
            fn.__name__, kwargs.get("algorithm"),
            _trace_nbytes(args[0]) if args else None)
        try:
            out = fn(self, *args, **kwargs)
        except BaseException as e:
            rec.coll_end(cell, error=type(e).__name__)
            raise
        rec.coll_end(cell)
        return out

    return wrapper


def _unpost(reqs: Sequence["_RecvRequest"]) -> None:
    """Failure path of a collective that posted internal irecvs: remove
    the not-yet-completed ones from their posted queues (and their
    steering entries), so a stale queue head cannot absorb the first
    frames of a LATER collective on the same channel and misfold.  Under
    the progress engine the removal holds its completion lock: the engine
    may be completing one of these right now."""
    if not reqs:
        return
    reg = reqs[0]._comm._recv_reg
    if reg is not None:
        for req in reqs:
            reg.cancel(req._steer_token)
    eng = reqs[0]._comm._progress
    with (eng.cv if eng is not None else contextlib.nullcontext()):
        for req in reqs:
            if not req._done and req in req._queue:
                req._queue.remove(req)


@contextlib.contextmanager
def _on_default_stream(device):
    """Issue a nonblocking collective on ``device``'s default stream (the
    stream every helper thread of the host layer works on): when the
    caller runs under a side stream, the default stream first waits on it,
    since the payload was produced there."""
    if device is None or device.type != "cuda":
        yield
        return
    cur = torch.cuda.current_stream(device)
    dflt = torch.cuda.default_stream(device)
    if cur == dflt:
        yield
        return
    dflt.wait_stream(cur)
    with torch.cuda.stream(dflt):
        yield


def _caller_waits(device) -> None:
    """Completion of a nonblocking collective: the caller's current stream
    waits on the default stream the collective's work was launched on."""
    if device is None or device.type != "cuda":
        return
    cur = torch.cuda.current_stream(device)
    dflt = torch.cuda.default_stream(device)
    if cur != dflt:
        cur.wait_stream(dflt)


class _SegSender:
    """Engine-advanced send window of one ``_seg_exchange`` step
    (``progress="thread"`` only): the pipelined sends beyond the initial
    ``_SEG_WINDOW`` credit are posted by whoever completes the matching
    receives — usually the progress engine, through each pipeline irecv's
    ``_on_complete`` — so the window advances without the caller being
    inside ``_seg_exchange``.  Sends happen under the sender lock (spans
    must leave in table order: the receiver folds by position).  A send
    failure on the engine thread is recorded, and re-raised at the
    caller's next fold/drain step (``check``)."""

    __slots__ = ("_comm", "_work", "_spans", "_dest", "_si", "_lock",
                 "_wire", "error")

    def __init__(self, comm: "P2PCommunicator", work: torch.Tensor,
                 spans, dest: int, wire=None):
        self._comm, self._work, self._spans = comm, work, spans
        self._dest = dest
        self._si = 0
        self._lock = threading.Lock()
        self._wire = wire  # wire-dtype codec (compress.py), None = plain
        self.error: Optional[BaseException] = None

    def post(self, n: int) -> None:
        with self._lock:
            while n > 0 and self._si < len(self._spans):
                lo, hi = self._spans[self._si]
                self._si += 1
                n -= 1
                self._comm._send_internal(
                    self._comm._seg_payload(self._work[lo:hi], self._wire),
                    self._dest, _TAG_COLL)

    def advance(self) -> None:
        """One receive completed: extend the credit window by one span
        (on the completing thread, outside the engine's lock)."""
        if self.error is not None:
            return
        try:
            self.post(1)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            self.error = e

    def check(self) -> None:
        if self.error is not None:
            raise self.error

    def drain(self) -> None:
        """Caller, after every fold: post what the callbacks have not
        (receive range shorter than the send range), then surface any
        engine-side send failure."""
        self.check()
        self.post(len(self._spans))
        self.check()


def _as_tensor(obj: Any, device) -> torch.Tensor:
    """A reduction payload as a tensor: a tensor as it is (on its own
    device), anything else (a Python scalar, a numpy array) built on
    ``device`` with numpy's dtype rules (``1.5`` is float64, as in the
    reference)."""
    if isinstance(obj, torch.Tensor):
        return obj
    return torch.as_tensor(np.asarray(obj), device=device)


def _flat_copy(arr: torch.Tensor) -> torch.Tensor:
    """A fresh, flat, contiguous copy of ``arr`` on its device — the
    engine's mutable working buffer (the reference's ``arr.flatten()``)."""
    out = torch.empty(arr.shape, dtype=arr.dtype, device=arr.device)
    out.copy_(arr.detach())
    return out.view(-1)


def _maybe_stack(local_payload: Any, items: List[Any]) -> Any:
    """Stack gathered results into a ``[P, ...]`` tensor ONLY when the
    local payload was a tensor and every result is a tensor of the same
    shape and dtype (the SPMD backend's stacked convention); a list
    otherwise (heterogeneous payloads stay general)."""
    if not isinstance(local_payload, torch.Tensor):
        return items
    first = items[0]
    for i in items:
        if not (isinstance(i, torch.Tensor) and i.shape == first.shape
                and i.dtype == first.dtype):
            return items
    dev = local_payload.device
    return torch.stack([i.to(dev) for i in items])


class Message:
    """A matched-probe message handle (MPI_Message): produced by
    ``comm.mprobe`` / ``comm.improbe``; already out of the matching
    queues, so it can only be consumed here."""

    __slots__ = ("source", "tag", "_payload", "_consumed", "_comm")

    def __init__(self, payload: Any, source: int, tag: int, comm=None):
        self._payload = payload
        self.source = source
        self.tag = tag
        self._consumed = False
        self._comm = comm

    def recv(self, status: Optional[Status] = None) -> Any:
        """MPI_Mrecv: consume the matched message (exactly once)."""
        if self._consumed:
            raise RuntimeError("MPI_Mrecv on an already-consumed message")
        self._consumed = True
        if status is not None:
            status._fill(self.source, self.tag, self._payload)
        payload, self._payload = self._payload, None
        return payload


def snapshot_payload(transport: Transport, payload: Any) -> Any:
    """Copy ``payload`` iff the transport delivers by reference (local with
    copy_payloads=False) — the buffer-reuse snapshot of persistent sends
    and isendrecv_replace.  Tensors are mutable, so they are cloned where
    the reference copies ndarrays; immutables pass through."""
    if not transport.aliases_payloads:
        return payload
    if isinstance(payload, torch.Tensor):
        return payload.detach().clone()
    if isinstance(payload, (int, float, complex, bool, str, bytes,
                            type(None))):
        return payload
    return pickle.loads(pickle.dumps(payload,
                                     protocol=pickle.HIGHEST_PROTOCOL))


def _refill(buf: Any, got: Any) -> None:
    """Copy a received payload into a bound destination in place (a tensor,
    an ndarray as the reference's ``np.copyto``, or a list of them),
    telling the ownership layer first; a geometry mismatch leaves the
    buffer alone (the payload is still returned)."""
    bufs, gots = (buf, got) if isinstance(buf, list) else ([buf], [got])
    try:
        for b, g in zip(bufs, gots):
            _bufpool.touch(b)
            if isinstance(b, np.ndarray):
                if isinstance(g, torch.Tensor):
                    g = g.detach().cpu().numpy()
                np.copyto(b, g)
            else:
                b.copy_(torch.as_tensor(g))
    except (TypeError, ValueError, RuntimeError):
        pass


class Request:
    """Handle for a nonblocking operation (MPI_Request): ``wait()`` blocks
    until completion and returns the payload (None for sends); ``test()``
    returns (done, payload-or-None) without blocking."""

    # Verifier tracking record (verify/state.py VInfo) — None when the
    # request was created with the verifier off: one attribute test
    _vinfo = None

    def _vnote(self, completed: bool, blocking: bool = True) -> None:
        vi = self._vinfo
        if vi is not None:
            vi.note(completed, blocking)

    def wait(self) -> Any:
        raise NotImplementedError

    def test(self) -> Tuple[bool, Any]:
        raise NotImplementedError


class _CompletedRequest(Request):
    """A request whose value already exists (buffered sends; SPMD
    nonblocking collectives, launched eagerly on the device stream)."""

    def __init__(self, value: Any = None):
        self._value = value

    def wait(self) -> Any:
        self._vnote(True)
        return self._value

    def test(self) -> Tuple[bool, Any]:
        self._vnote(True, blocking=False)
        return True, self._value


class _ReplaceRequest(Request):
    """isendrecv_replace's handle: delegates to the inner irecv and applies
    the in-place refill exactly once at completion."""

    def __init__(self, inner: Request, buf: Any):
        self._inner = inner
        self._buf = buf
        self._done = False
        self._value: Any = None

    def _finish(self, got: Any) -> Any:
        if isinstance(self._buf, torch.Tensor):
            _bufpool.touch(self._buf)
            self._buf.copy_(got)
        elif isinstance(self._buf, np.ndarray):  # the reference's buffers
            _bufpool.touch(self._buf)
            self._buf[...] = (got.detach().cpu().numpy()
                              if isinstance(got, torch.Tensor) else got)
        self._done, self._value = True, got
        return got

    def wait(self) -> Any:
        if self._done:
            return self._value
        return self._finish(self._inner.wait())

    def test(self) -> Tuple[bool, Any]:
        if self._done:
            return True, self._value
        done, got = self._inner.test()
        if not done:
            return False, None
        return True, self._finish(got)


class _RecvRequest(Request):
    """Outstanding receive.  Requests posted on the same (source, tag) key
    complete in POSTED order regardless of wait()/test() call order (the
    MPI matching rule): completing a later request first drains its
    earlier siblings from the shared posted queue.

    With the progress engine attached, completion is SHARED between the
    caller and the engine thread: both go through the engine's
    completion lock (``ProgressEngine.try_complete``), so a message is
    consumed once and ``_done`` may flip in the background.
    ``_on_complete`` is the engine's post-completion callback slot
    (``_SegSender.advance``, the state machines' kick)."""

    _on_complete = None
    # recv-steering registry token of a posted irecv (internal, or a user
    # irecv on a steering channel)
    _steer_token = None
    # irecv(buf=...) / recv_init destination (a tensor, an ndarray or a
    # list of them), filled at completion, and whether it was registered
    # as a claimable steering entry: an armed completion whose payload is
    # NOT the destination takes the counted fallback below
    _user_buf = None
    _user_armed = False

    def __init__(self, comm: "P2PCommunicator", source: int, tag: int,
                 queue: List["_RecvRequest"]):
        self._comm, self._source, self._tag = comm, source, tag
        self._queue = queue
        self._done = False
        self._value: Any = None
        queue.append(self)

    def _complete(self, payload: Any) -> None:
        reg = self._comm._recv_reg
        if reg is not None and reg.live_count and self._tag >= -1:
            # a user-facing completion may pop a steered user destination
            # still in the aliasing guard: the owner's pop is identity,
            # any other consumer's a private copy (recvpool.sanitize)
            payload = reg.sanitize(payload, self._user_buf)
        ub = self._user_buf
        if ub is not None:
            if payload is ub:
                # the reader landed the frame's bytes in the caller's
                # buffer itself: the zero-copy user rendezvous
                _mpit.count(recv_user_inplace=1)
            else:
                if self._user_armed:
                    # the match raced the reader (a frame queued before
                    # the post, a heal replay, a wildcard steal): rescue
                    # an unpopped claim, retire the entry so no later
                    # frame can claim the now user-owned buffer, count it
                    reg.pre_overwrite(ub)
                    reg.cancel(self._steer_token)
                    _mpit.count(recv_user_fallbacks=1)
                _refill(ub, payload)
        self._value, self._done = payload, True
        if self in self._queue:
            self._queue.remove(self)

    def _poll_once(self):
        src_world = (ANY_SOURCE if self._source == ANY_SOURCE
                     else self._comm._world(self._source))
        if src_world == ANY_SOURCE and self._tag >= -1 \
                and self._comm._verify is not None:
            # wildcard irecv: attribute any race the consume scan finds to
            # the posting site (the consuming thread may be the engine)
            vc = getattr(self._comm._t, "verify_clock", None)
            if vc is not None:
                vi = self._vinfo
                vc.set_site(vi.site if vi is not None else "<irecv>")
        return self._comm._t.poll(src_world, self._comm._ctx, self._tag)

    def wait(self) -> Any:
        if self._comm._progress is not None:
            # engine mode: a blocking consume here could swallow a message
            # the engine already matched to an earlier sibling, so the
            # wait parks on the engine instead
            self._comm._progress_wait_request(self)
            self._vnote(True)
            return self._value
        while not self._done:
            head = self._queue[0]  # earliest posted request gets the message
            # _recv_internal, not recv: internal (negative-tag) requests —
            # the engine's pipelined irecvs — must not trip the user-tag
            # check at completion time
            head._complete(self._comm._recv_internal(
                head._source, head._tag, _posted=True))
        self._vnote(True)
        return self._value

    def test(self) -> Tuple[bool, Any]:
        eng = self._comm._progress
        if eng is not None:
            if not self._done:
                with eng.cv:
                    cbs = eng.try_complete(self)
                for cb in cbs:  # outside the lock
                    cb()
            if not self._done:
                self._comm._empty_poll_check(self._source, self._tag)
                return False, None
            self._vnote(True, blocking=False)
            return True, self._value
        while not self._done:
            head = self._queue[0]
            hit = head._poll_once()
            if hit is None:
                # a polling loop over a dead peer (or a revoked comm) must
                # fail within the detection bound; a message already
                # delivered stays receivable
                self._comm._empty_poll_check(self._source, self._tag)
                return False, None
            head._complete(hit[0])
            if self._comm._verify is not None:
                # a poll hit is real progress (this path bypasses
                # _recv_internal): stamp it, retracting a published entry
                self._comm._verify.world.note_progress()
        self._vnote(True, blocking=False)
        return True, self._value


class PersistentRequest(Request):
    """A persistent operation (MPI_Send_init / MPI_Recv_init): binds the
    argument list once; each ``start()`` launches one operation and
    ``wait()`` completes it, returning the request to the inactive state.
    Sends read the bound buffer at start time; receives also copy the
    payload into the bound ``buf`` when one was given."""

    def __init__(self, comm: "P2PCommunicator", kind: str, buf: Any,
                 peer: int, tag: int):
        self._comm, self._kind, self._buf = comm, kind, buf
        self._peer, self._tag = peer, tag
        self._inner: Optional[Request] = None
        self._last: Any = None
        self._buf_key: Optional[int] = None  # verifier live-buffer handle

    @property
    def active(self) -> bool:
        return self._inner is not None

    def start(self) -> "PersistentRequest":
        if self._inner is not None:
            raise RuntimeError(
                "start() on an active persistent request (MPI: erroneous "
                "until the previous operation completes)")
        if self._kind == "send":
            payload = snapshot_payload(self._comm._t, self._buf)
            self._inner = self._comm.isend(payload, self._peer, self._tag)
        else:
            self._inner = self._comm.irecv(self._peer, self._tag)
            if self._buf is not None:
                # the bound buffer is filled at THIS operation's
                # completion, or steered into by the reader
                self._comm._arm_user_recv(
                    self._inner, self._peer, self._tag, self._buf)
            v = self._comm._verify
            if v is not None and isinstance(self._buf, torch.Tensor):
                # live receive buffer: overlapping another pending
                # nonblocking op's buffer is the message-race lint
                from .verify.state import user_site

                self._buf_key = v.world.buffer_live(
                    self._buf,
                    f"rank {self._comm.rank}: recv_init(source="
                    f"{self._peer}, tag={self._tag}).start() at "
                    f"{user_site()}", writes=True)
        return self

    def wait(self) -> Any:
        # a completed value stays readable until the next start()
        if self._inner is None:
            return self._last
        value = self._inner.wait()
        self._complete(value)
        return value

    def test(self) -> Tuple[bool, Any]:
        if self._inner is None:
            return True, self._last
        done, value = self._inner.test()
        if done:
            self._complete(value)
        return done, value

    def _complete(self, value: Any) -> None:
        self._inner, self._last = None, value
        if self._buf_key is not None:
            self._comm._verify.world.buffer_release(self._buf_key)
            self._buf_key = None


def startall(requests: Sequence[PersistentRequest]) -> List[PersistentRequest]:
    """MPI_Startall."""
    for r in requests:
        r.start()
    return list(requests)


class _ThreadRequest(Request):
    """A nonblocking collective in flight as the blocking algorithm on a
    thread of its own, against an isolated context (``_nbc_comm``): the
    path of worlds without the progress engine, of ``nbc_mode="thread"``
    and of payloads above ``nbc_sm_max_bytes``.  Counted in the
    ``nbc_threads_spawned`` pvar.  The thread binds ``device`` before its
    first launch; its error is re-raised at ``wait()``/``test()``."""

    def __init__(self, fn, device=None):
        _mpit.count(nbc_threads_spawned=1)
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._device = device

        def run():
            try:
                bind_thread_device(device)
                self._value = fn()
            except BaseException as e:  # noqa: BLE001 - re-raised at wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="mpi-tpu-torch-nbc")
        self._thread.start()

    def wait(self) -> Any:
        self._thread.join()
        self._vnote(True)
        if self._error is not None:
            raise self._error
        _caller_waits(self._device)
        return self._value

    def test(self) -> Tuple[bool, Any]:
        if self._thread.is_alive():
            return False, None
        self._vnote(True, blocking=False)
        if self._error is not None:
            raise self._error
        _caller_waits(self._device)
        return True, self._value


class Keyval:
    """Attribute key (MPI_Comm_create_keyval): ``copy_fn(comm, value) ->
    new value`` decides what a dup'd communicator inherits (return
    :data:`NO_COPY`, or leave ``copy_fn=None``, not to propagate);
    ``delete_fn(comm, value)`` runs when the attribute is deleted or
    overwritten."""

    __slots__ = ("copy_fn", "delete_fn", "name")

    def __init__(self, copy_fn=None, delete_fn=None, name: str = ""):
        self.copy_fn = copy_fn
        self.delete_fn = delete_fn
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Keyval({self.name or hex(id(self))})"


NO_COPY = object()  # sentinel a copy_fn returns to veto propagation


def dup_fn(comm, value):
    """MPI_COMM_DUP_FN: propagate the value as-is on dup."""
    return value


def create_keyval(copy_fn=None, delete_fn=None, name: str = "") -> Keyval:
    """MPI_Comm_create_keyval: the keyval OBJECT is the key."""
    return Keyval(copy_fn, delete_fn, name)


class Communicator(ABC):
    """Abstract communicator: the API user MPI programs are written against."""

    # -- attribute caching (keyvals) and error handlers ----------------------

    def set_attr(self, keyval: Keyval, value: Any) -> None:
        """MPI_Comm_set_attr; overwriting runs the old value's delete_fn."""
        attrs = self.__dict__.setdefault("_attrs", {})
        if keyval in attrs and keyval.delete_fn is not None:
            keyval.delete_fn(self, attrs[keyval])
        attrs[keyval] = value

    def get_attr(self, keyval: Keyval) -> Any:
        """MPI_Comm_get_attr: the value, or None when unset."""
        return self.__dict__.get("_attrs", {}).get(keyval)

    def delete_attr(self, keyval: Keyval) -> None:
        """MPI_Comm_delete_attr: remove + run delete_fn (no-op when unset)."""
        attrs = self.__dict__.get("_attrs", {})
        if keyval in attrs:
            value = attrs.pop(keyval)
            if keyval.delete_fn is not None:
                keyval.delete_fn(self, value)

    def _copy_attrs_to(self, new: "Communicator") -> "Communicator":
        """Dup-time attribute propagation per the copy callbacks (plus the
        error-handler inheritance dup also owes)."""
        for keyval, value in self.__dict__.get("_attrs", {}).items():
            if keyval.copy_fn is None:
                continue
            copied = keyval.copy_fn(self, value)
            if copied is not NO_COPY:
                new.set_attr(keyval, copied)
        return self._inherit_errhandler(new)

    def _inherit_errhandler(self, new: "Communicator") -> "Communicator":
        """A newly created communicator inherits the parent's handler."""
        if "_errhandler" in self.__dict__:
            new._errhandler = self._errhandler
        return new

    def set_errhandler(self, handler) -> None:
        """MPI_Comm_set_errhandler: ERRORS_ARE_FATAL, ERRORS_RETURN, or a
        callable ``handler(comm, exc)`` (consulted by ``errors.invoke_handler``)."""
        self._errhandler = handler

    def get_errhandler(self):
        from .errors import ERRORS_ARE_FATAL

        return getattr(self, "_errhandler", ERRORS_ARE_FATAL)

    # -- identity ----------------------------------------------------------

    @property
    @abstractmethod
    def rank(self):
        """This rank in this communicator (0..size-1)."""

    @property
    @abstractmethod
    def size(self) -> int:
        """Number of ranks in this communicator."""

    # -- point-to-point ----------------------------------------------------

    @abstractmethod
    def send(self, obj: Any, dest: int, tag: int = 0) -> None:
        """Blocking standard-mode send (buffered; completes locally)."""

    @abstractmethod
    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             status: Optional[Status] = None) -> Any:
        """Blocking matched receive; returns the payload."""

    @abstractmethod
    def sendrecv(self, sendobj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG,
                 status: Optional[Status] = None) -> Any:
        """Combined send+receive (deadlock-free halo-exchange primitive)."""

    @abstractmethod
    def shift(self, obj: Any, offset: int = 1, wrap: bool = True, fill: Any = None) -> Any:
        """Every rank sends ``obj`` to ``rank+offset`` and returns the
        payload from ``rank-offset``; with ``wrap=False`` the boundary hole
        is ``fill``."""

    def exchange(self, obj: Any, pairs: Sequence[Tuple[int, int]],
                 fill: Any = None) -> Any:
        """Static-pattern point-to-point: every ``(src, dst)`` in ``pairs``
        ships src's payload to dst; ranks receiving nothing get ``fill``."""
        raise NotImplementedError(f"{type(self).__name__} does not implement exchange")

    # -- collectives -------------------------------------------------------

    @abstractmethod
    def bcast(self, obj: Any, root: int = 0, algorithm: str = "auto") -> Any: ...

    @abstractmethod
    def reduce(self, obj: Any, op: _ops.ReduceOp = _ops.SUM, root: int = 0,
               algorithm: str = "auto") -> Any: ...

    @abstractmethod
    def allreduce(self, obj: Any, op: _ops.ReduceOp = _ops.SUM,
                  algorithm: str = "auto") -> Any: ...

    @abstractmethod
    def allgather(self, obj: Any, algorithm: str = "auto") -> Any: ...

    @abstractmethod
    def alltoall(self, objs: Sequence[Any], algorithm: str = "auto") -> Any: ...

    @abstractmethod
    def barrier(self) -> None: ...

    def localize(self, obj: Any) -> Any:
        """Mark ``obj`` as rank-local state: the identity here, as on the
        reference's process backends (``mpi_tpu/communicator.py:1034``);
        the SPMD communicator overrides it with the reference's ``pvary``
        (``TorchCommunicator.localize``)."""
        return obj

    def scan(self, obj: Any, op: _ops.ReduceOp = _ops.SUM) -> Any:
        """MPI_Scan: inclusive prefix reduction."""
        raise NotImplementedError(f"{type(self).__name__} does not implement scan")

    def exscan(self, obj: Any, op: _ops.ReduceOp = _ops.SUM) -> Any:
        """MPI_Exscan: rank r gets the reduction of ranks 0..r-1; rank 0
        gets the op identity, so ``scan == combine(exscan, local)``."""
        scanned = self.scan(obj, op)
        return self.shift(scanned, offset=1, wrap=False,
                          fill=op.identity(scanned.dtype))

    def maxloc(self, obj: Any):
        """MPI_MAXLOC: elementwise (max value, lowest rank attaining it)."""
        return self._allreduce_loc(obj, _ops.MAX)

    def minloc(self, obj: Any):
        """MPI_MINLOC: elementwise (min value, lowest rank attaining it)."""
        return self._allreduce_loc(obj, _ops.MIN)

    def _allreduce_loc(self, obj: Any, op: _ops.ReduceOp):
        best = self.allreduce(obj, op=op)
        arr = _as_tensor(obj, best.device).to(best.device)
        cand = torch.where(arr == best, self.rank, self.size).to(torch.int64)
        return best, self.allreduce(cand, op=_ops.MIN)

    def reduce_scatter(self, blocks: Any, op: _ops.ReduceOp = _ops.SUM,
                       algorithm: str = "auto") -> Any:
        """MPI_Reduce_scatter_block: ``blocks`` holds one block per rank;
        rank r gets the reduction of everyone's block r."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement reduce_scatter")

    def scatter(self, objs: Optional[Sequence[Any]], root: int = 0) -> Any:
        raise NotImplementedError(f"{type(self).__name__} does not implement scatter")

    def gather(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        raise NotImplementedError(f"{type(self).__name__} does not implement gather")

    # -- vector (variable-count) collectives --------------------------------
    #
    # MPI_*v semantics with counts as static Python ints: ``counts[i]`` is
    # the number of leading-axis rows rank i contributes (or receives, for
    # scatterv); inputs may be padded — only the first ``counts[rank]``
    # rows are used; allgatherv/gatherv return the ragged concatenation.

    def allgatherv(self, obj: Any, counts: Sequence[int]) -> Any:
        """MPI_Allgatherv: every rank's first ``counts[rank]`` rows, in
        rank order."""
        self._check_counts(counts)
        self._verify_counts("allgatherv", counts)
        items = self.allgather(self._take_rows(obj, counts[self.rank]))
        return _concat_rows(items)

    def gatherv(self, obj: Any, counts: Sequence[int],
                root: int = 0) -> Optional[Any]:
        """MPI_Gatherv: like allgatherv, the result at root only."""
        self._check_counts(counts)
        self._verify_counts("gatherv", counts)
        items = self.gather(self._take_rows(obj, counts[self.rank]), root)
        if items is None:
            return None
        return _concat_rows(items)

    def scatterv(self, obj: Any, counts: Sequence[int], root: int = 0) -> Any:
        """MPI_Scatterv: root holds the ``[sum(counts), ...]``
        concatenation; rank r receives its ``counts[r]``-row slice."""
        self._check_counts(counts)
        self._verify_counts("scatterv", counts)
        parts: Optional[List[Any]] = None
        if self.rank == root:
            offs = np.cumsum([0] + [int(c) for c in counts])
            arr = _as_tensor(obj, self.device)
            if arr.shape[0] != offs[-1]:
                raise ValueError(
                    f"scatterv root payload needs sum(counts)={offs[-1]} rows, "
                    f"got {arr.shape[0]}")
            parts = [arr[offs[i]:offs[i + 1]] for i in range(self.size)]
        return self.scatter(parts, root)

    def alltoallv(self, blocks: Any, counts: Sequence[Sequence[int]]) -> Any:
        """MPI_Alltoallv: ``counts[i][j]`` rows travel from rank i to rank
        j; returns one entry per source rank j with ``counts[j][rank]``
        rows."""
        self._check_counts_matrix(counts)
        self._verify_counts("alltoallv", counts)
        sendlist = [self._take_rows(blocks[d], counts[self.rank][d])
                    for d in range(self.size)]
        return self.alltoall(sendlist)

    def _verify_counts(self, coll: str, counts) -> None:
        """Vector-collective hook: with the runtime verifier on (host
        backends only — the attribute is never set elsewhere), cross-check
        the literal counts vector across ranks; divergence is the
        truncating-recv case."""
        v = getattr(self, "_verify", None)
        if v is not None and self.size > 1:
            from .verify import collcheck as _vcc

            _vcc.check(self, coll, counts=tuple(
                tuple(int(c) for c in row) if hasattr(row, "__len__")
                else int(row) for row in counts))

    def _take_rows(self, obj: Any, count: int) -> torch.Tensor:
        arr = _as_tensor(obj, self.device)
        if arr.shape[0] < count:
            raise ValueError(
                f"rank {self.rank}: payload has {arr.shape[0]} rows but its "
                f"declared count is {count}")
        return arr[:count]

    def _check_counts(self, counts: Sequence[int]) -> None:
        if len(counts) != self.size:
            raise ValueError(
                f"need one count per rank ({self.size}), got {len(counts)}")
        if any(int(c) < 0 for c in counts):
            raise ValueError(f"counts must be >= 0, got {list(counts)}")

    def _check_counts_matrix(self, counts: Sequence[Sequence[int]]) -> None:
        if len(counts) != self.size or any(len(row) != self.size for row in counts):
            raise ValueError(
                f"alltoallv counts must be a {self.size}x{self.size} matrix")
        if any(int(c) < 0 for row in counts for c in row):
            raise ValueError(
                f"alltoallv counts must be >= 0, got {[list(r) for r in counts]}")

    # -- communicator management ------------------------------------------

    @abstractmethod
    def split(self, color: Optional[int], key: int = 0) -> Optional["Communicator"]:
        """MPI_Comm_split: ranks sharing ``color`` form a new communicator
        ordered by (key, old rank); ``color=None`` opts out (None)."""

    @abstractmethod
    def dup(self) -> "Communicator":
        """New communicator over the same group with isolated message space."""

    def split_by_rank(self, color_fn, key_fn=None) -> Optional["Communicator"]:
        """``split`` with color/key as pure functions of the group-local
        rank — the spelling that also runs on the SPMD backend."""
        return self.split(color_fn(self.rank),
                          key_fn(self.rank) if key_fn else 0)

    def group(self):
        """MPI_Comm_group: this communicator's group (all ranks, in order)."""
        from .group import Group

        return Group(range(self.size))

    def split_type(self, split_type: str = "shared",
                   key: int = 0) -> Optional["Communicator"]:
        """MPI_Comm_split_type(COMM_TYPE_SHARED): worlds this library
        launches are single-host, so the shared-memory split is the whole
        communicator reordered by key."""
        if split_type != "shared":
            raise ValueError(f"unknown split_type {split_type!r}")
        return self.split(0, key)

    def win_create(self, init: Any):
        """MPI_Win_create: one-sided RMA windows."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement one-sided RMA")

    def _check_group(self, group) -> None:
        """Shared validation for create(): non-empty, ranks in range."""
        ranks = list(group.ranks)
        if not ranks:
            raise ValueError(
                "create(group) needs a non-empty group (MPI_GROUP_EMPTY has "
                "no communicator)")
        bad = [r for r in ranks if not (0 <= r < self.size)]
        if bad:
            raise ValueError(
                f"group ranks {bad} out of range for a size-{self.size} communicator")

    def create(self, group) -> Optional["Communicator"]:
        """MPI_Comm_create_group: members of ``group`` get a new
        communicator ordered by group position; non-members get None."""
        self._check_group(group)
        pos = group.rank_of(self.rank)
        return self.split(0 if pos is not None else None,
                          pos if pos is not None else 0)

    def free(self) -> None:
        """Release resources (no-op for sub-communicators)."""


def _concat_rows(items: List[Any]) -> torch.Tensor:
    dev = items[0].device if isinstance(items[0], torch.Tensor) else None
    return torch.cat([torch.as_tensor(it, device=dev) for it in items], dim=0)


class P2PCommunicator(Communicator):
    """Communicator over any point-to-point Transport (local threads,
    socket processes): collectives run the shared schedules of
    ``schedules.py`` with real sends and receives."""

    def __init__(self, transport: Transport, group: Sequence[int], context=0,
                 recv_timeout: Optional[float] = None):
        self._t = transport
        self._group: Tuple[int, ...] = tuple(group)
        if transport.world_rank not in self._group:
            raise ValueError(
                f"world rank {transport.world_rank} not in group {self._group}")
        self._rank = self._group.index(transport.world_rank)
        self._ctx = context
        self._nchildren = 0
        self._lock = threading.Lock()
        # with a timeout, a lost message surfaces as RecvTimeout (with the
        # pending-message summary) instead of a hang
        self.recv_timeout = recv_timeout
        self._irecv_queues: dict = {}
        # which collective is waiting on internal tags: named in
        # ProcFailedError diagnoses
        self._coll_name: Optional[str] = None
        # recv-steering registry (socket only); None = one attribute test
        self._recv_reg = transport.recv_registry
        # ULFM state (ft.CommFT), attached by ft.enable(); None = the
        # fault-tolerance machinery is one attribute test per operation
        self._ft = None
        # runtime-verifier state (verify/state.py CommVerify), attached by
        # verify.enable(); None = the whole verifier is one attribute test
        # per operation and every verify_* pvar stays 0
        self._verify = None
        # the world's progress engine (progress.py), inherited from the
        # transport so split/dup/nbc children share its thread
        self._progress = getattr(transport, "_progress_engine", None)

    # -- identity ----------------------------------------------------------

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return len(self._group)

    @property
    def context(self):
        return self._ctx

    @property
    def device(self) -> torch.device:
        """The device this rank's received and engine-made tensors live on."""
        return self._t.device

    def _world(self, comm_rank: int) -> int:
        if not (0 <= comm_rank < self.size):
            raise ValueError(f"rank {comm_rank} out of range for communicator of size {self.size}")
        return self._group[comm_rank]

    def _from_world(self, world_rank: int) -> int:
        return self._group.index(world_rank)

    # -- point-to-point ----------------------------------------------------

    def send(self, obj: Any, dest: int, tag: int = 0) -> None:
        _check_user_tag(tag)
        self._send_internal(obj, dest, tag)

    def _send_internal(self, obj: Any, dest: int, tag: int) -> None:
        _mpit.count(sends=1, send_bytes=int(payload_nbytes(obj) or 0))
        dest_world = self._world(dest)
        if self._ft is not None:
            self._ft.check(self)  # raises RevokedError on a revoked comm
            if dest_world in self._ft.world.failed:
                raise ProcFailedError(
                    f"rank {self._rank}: send to dead rank {dest}",
                    failed=(dest,),
                    collective=self._coll_name if tag < 0 else None)
            try:
                self._t.send(dest_world, self._ctx, tag, obj)
            except TransportError as e:
                # transport evidence beats the detector to the diagnosis
                self._ft.world.observe(dest_world, f"send failed: {e}")
                raise ProcFailedError(
                    f"rank {self._rank}: send to rank {dest} failed ({e})",
                    failed=(dest,),
                    collective=self._coll_name if tag < 0 else None) from e
            if self._verify is not None:
                self._verify.world.note_progress()
            return
        self._t.send(dest_world, self._ctx, tag, obj)
        if self._verify is not None:
            self._verify.world.note_progress()

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             status: Optional[Status] = None) -> Any:
        _check_user_tag(tag)
        return self._recv_internal(source, tag, status)

    def _recv_internal(self, source: int, tag: int,
                       status: Optional[Status] = None,
                       _posted: bool = False) -> Any:
        src_world = ANY_SOURCE if source == ANY_SOURCE else self._world(source)
        reg = self._recv_reg
        counted = False
        if (not _posted and src_world != ANY_SOURCE and reg is not None
                and (tag < 0 or (reg.user_count and reg.user_active(
                    src_world, self._ctx, tag)))):
            # a BLOCKING recv on a counted channel (internal, or a user
            # channel activated by irecv(buf=)) consumes a frame on the
            # channel the posted irecvs pair on: count it so the
            # frame/consumer indices stay aligned (_posted marks the
            # queue-head servicing call of an already-counted irecv,
            # whose sanitize and refill run in _RecvRequest._complete)
            reg.note_consume(src_world, self._ctx, tag)
            counted = True
        if self._verify is not None and src_world == ANY_SOURCE and tag >= -1:
            # wildcard-race attribution: the consume scan runs under the
            # mailbox lock, so the receive records its call site first
            vc = getattr(self._t, "verify_clock", None)
            if vc is not None:
                from .verify.state import user_site

                vc.set_site(user_site())
        if self._ft is not None or self._verify is not None:
            obj, src, t = self._sliced_wait(src_world, tag)
        else:
            obj, src, t = self._plain_recv(src_world, tag)
        if reg is not None and not _posted and t >= 0:
            if reg.live_count:
                # this pop may have taken a steered user destination an
                # armed irecv owns: a non-owner gets a private copy
                obj = reg.sanitize(obj)
            if not counted and reg.user_count:
                # an uncounted pop (wildcard envelope) on an active user
                # channel shifts every later consumer one message earlier
                reg.note_steal(src, self._ctx, t)
        _mpit.count(recvs=1)
        if status is not None:
            status._fill(self._from_world(src), t, obj)
        return obj

    def _plain_recv(self, src_world: int, tag: int):
        """The blocking receive without fault tolerance or the verifier,
        with the same blocked-wait trace span ``_sliced_wait`` emits."""
        rec = _telemetry.REC
        if rec is None:
            return self._t.recv(src_world, self._ctx, tag,
                                timeout=self.recv_timeout)
        t_trace = time.perf_counter_ns()
        out = self._t.recv(src_world, self._ctx, tag,
                           timeout=self.recv_timeout)
        dur = time.perf_counter_ns() - t_trace
        if dur >= _telemetry.WAIT_MIN_NS:
            rec.emit("wait", "recv", dur_ns=dur,
                     attrs={"src": src_world, "tag": tag,
                            "coll": self._coll_name if tag < 0 else None})
        return out

    # -- sliced blocking waits (ft.py, verify/) and the engine-parked wait ---

    def _sliced_wait(self, src_world: int, tag: int, consume: bool = True):
        """Every fault-tolerant or verified blocking wait (recv, probe, and
        through ``_RecvRequest.wait`` the segmented engine's receive
        drains): the transport wait runs in _FT_POLL_S slices, and between
        slices

        * (ft) a queued revocation raises RevokedError and a detector hit
          on a relevant peer raises ProcFailedError — a death is noticed
          within the detection bound whatever ``recv_timeout`` is;
        * (verify) past ``verify_stall_timeout_s`` the rank publishes its
          pending op on the out-of-band board and runs the wait-for
          deadlock analysis — a proven cycle or knot raises DeadlockError
          instead of hanging (``verify/deadlock.py``).

        A rank whose host thread is inside device work is not in here,
        so it publishes nothing and never reads as blocked."""
        ft = self._ft
        vw = self._verify.world if self._verify is not None else None
        rec = _telemetry.REC
        t_trace = time.perf_counter_ns() if rec is not None else 0
        timeout = self.recv_timeout
        start = time.monotonic()
        deadline = None if timeout is None else start + timeout
        block_id = vw.begin_block() if vw is not None else 0
        if vw is not None:
            vw.wait_enter()  # board-entry ownership: the engine stands down
        try:
            while True:
                if ft is not None:
                    ft.check(self)
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                slice_s = (_FT_POLL_S if remaining is None
                           else max(0.0, min(_FT_POLL_S, remaining)))
                try:
                    if consume:
                        hit = self._t.recv(src_world, self._ctx, tag,
                                           timeout=slice_s)
                    else:
                        hit = self._t.peek(src_world, self._ctx, tag,
                                           timeout=slice_s)
                except RecvTimeout:
                    if ft is not None:
                        suspects = self._ft_suspects(src_world, tag)
                        if suspects:
                            what = (f"collective {self._coll_name!r}"
                                    if tag < 0 else f"recv(tag={tag})")
                            raise ProcFailedError(
                                f"rank {self._rank}: peer death detected "
                                f"while blocked in {what}", failed=suspects,
                                collective=self._coll_name if tag < 0
                                else None)
                    if (vw is not None and
                            time.monotonic() - start >= vw.stall_timeout_s):
                        # may raise DeadlockError; the published entry is
                        # NOT cleared on that raise — peers confirming the
                        # same diagnosis need it stable
                        self._verify_stalled(vw, src_world, tag, block_id,
                                             consume)
                    if deadline is not None and time.monotonic() >= deadline:
                        raise RecvTimeout(
                            f"recv(source={src_world}, ctx={self._ctx}, "
                            f"tag={tag}) timed out after {timeout}s; "
                            f"pending={self._t.mailbox.pending_summary()}")
                else:
                    if vw is not None:
                        vw.note_progress()  # clears the published entry
                    return hit
        except (RecvTimeout, ProcFailedError, RevokedError):
            # the rank leaves this wait alive: retract a published
            # 'blocked' entry so no peer's analysis keeps implicating it
            if vw is not None:
                vw.clear_published()
            raise
        finally:
            if vw is not None:
                vw.wait_exit()
            if rec is not None:
                # blocked waits past the noise floor become spans
                dur = time.perf_counter_ns() - t_trace
                if dur >= _telemetry.WAIT_MIN_NS:
                    rec.emit("wait", "recv" if consume else "probe",
                             dur_ns=dur,
                             attrs={"src": src_world, "tag": tag,
                                    "coll": self._coll_name
                                    if tag < 0 else None})

    def _verify_stalled(self, vw, src_world: int, tag: int, block_id: int,
                        consume: bool) -> None:
        from .verify import deadlock as _vdl
        from .verify.state import user_site

        if src_world == ANY_SOURCE:
            targets = tuple(w for w in self._group
                            if w != self._t.world_rank)
            mode = "OR"
        else:
            targets, mode = (src_world,), "AND"
        _vdl.check_stalled(
            vw, self, targets, mode, tag, "recv" if consume else "probe",
            self._coll_name if tag < 0 else None, user_site(), block_id)

    def _progress_wait_request(self, req: "_RecvRequest") -> None:
        """Blocking wait on a posted receive under the progress engine:
        completion is serialized with the engine through its lock, and
        the caller PARKS on the engine's condition between slices.  Each
        slice keeps the fault-tolerance checks, the verifier's stall
        publication and ``recv_timeout``, and retries completion itself,
        so liveness never depends on the engine thread."""
        eng = self._progress
        ft = self._ft
        vw = self._verify.world if self._verify is not None else None
        timeout = self.recv_timeout
        start = time.monotonic()
        deadline = None if timeout is None else start + timeout
        block_id = vw.begin_block() if vw is not None else 0
        src_world = (ANY_SOURCE if req._source == ANY_SOURCE
                     else self._world(req._source))
        if vw is not None:
            vw.wait_enter()
        try:
            while True:
                if ft is not None:
                    ft.check(self)
                if not req._done:
                    with eng.cv:
                        cbs = eng.try_complete(req)
                    for cb in cbs:  # credit-window sends, lock released
                        cb()
                if req._done:
                    return
                if ft is not None:
                    suspects = self._ft_suspects(src_world, req._tag)
                    if suspects:
                        what = (f"collective {self._coll_name!r}"
                                if req._tag < 0 else f"irecv(tag={req._tag})")
                        raise ProcFailedError(
                            f"rank {self._rank}: peer death detected while "
                            f"waiting on {what}", failed=suspects,
                            collective=self._coll_name if req._tag < 0
                            else None)
                now = time.monotonic()
                if vw is not None and now - start >= vw.stall_timeout_s:
                    self._verify_stalled(vw, src_world, req._tag,
                                         block_id, True)
                if deadline is not None and now >= deadline:
                    raise RecvTimeout(
                        f"irecv wait(source={src_world}, ctx={self._ctx}, "
                        f"tag={req._tag}) timed out after {timeout}s; "
                        f"pending={self._t.mailbox.pending_summary()}")
                with eng.cv:
                    # _done flips under eng.cv: this re-check loses no wakeup
                    if not req._done:
                        eng.cv.wait(_FT_POLL_S)
        except (RecvTimeout, ProcFailedError, RevokedError):
            if vw is not None:
                vw.clear_published()
            raise
        finally:
            if vw is not None:
                vw.wait_exit()

    def _empty_poll_check(self, source: int, tag: int, req=None) -> None:
        """Fault-tolerance gate of the NONBLOCKING completion paths
        (``Request.test``, ``iprobe``, ``improbe``) on their empty path:
        apply a queued revocation and turn a detector hit on a relevant
        peer into ProcFailedError, as the sliced wait does.  An empty poll
        is not a blocked state for the verifier, except under the
        progress engine: it observes sustained empty polls, publishes an
        OR-set entry on the rank's behalf and parks a proven
        DeadlockError, re-raised here.  ``req`` (a state-machine
        collective, ``nbc.py``) names the call being polled."""
        eng = self._progress
        if eng is not None:
            eng.check_error()
            eng.note_empty_poll(req)
        if self._ft is None:
            return
        self._ft.check(self)
        src_world = ANY_SOURCE if source == ANY_SOURCE else self._world(source)
        suspects = self._ft_suspects(src_world, tag)
        if suspects:
            what = (f"collective {self._coll_name!r}" if tag < 0
                    else f"poll(tag={tag})")
            raise ProcFailedError(
                f"rank {self._rank}: peer death detected while polling "
                f"{what}", failed=suspects,
                collective=self._coll_name if tag < 0 else None)

    def _ft_suspects(self, src_world: int, tag: int) -> Tuple[int, ...]:
        """The known-dead comm ranks that make THIS wait hopeless.
        Internal (negative) tags are collective machinery: every failed
        member dooms it.  A user recv from a specific source fails only if
        that source is dead; a wildcard recv on any unacknowledged death
        (``failure_ack`` re-arms it)."""
        ft = self._ft
        failed_world = ft.world.failed_snapshot() & set(self._group)
        if not failed_world:
            return ()
        failed = sorted(self._group.index(w) for w in failed_world)
        if tag < 0:
            return tuple(failed)
        if src_world == ANY_SOURCE:
            return tuple(r for r in failed if r not in ft.acked)
        src = self._from_world(src_world)
        return (src,) if src in failed else ()

    def sendrecv(self, sendobj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG,
                 status: Optional[Status] = None) -> Any:
        # deadlock-free: transports buffer sends
        self.send(sendobj, dest, sendtag)
        return self.recv(source, recvtag, status)

    def _sendrecv_internal(self, sendobj: Any, dest: int, source: int, tag: int) -> Any:
        self._send_internal(sendobj, dest, tag)
        return self._recv_internal(source, tag)

    def isend(self, obj: Any, dest: int, tag: int = 0) -> Request:
        """MPI_Isend.  Sends are buffered (complete once enqueued on the
        transport), so the request is complete at once."""
        self.send(obj, dest, tag)
        req: Request = _CompletedRequest()
        if self._verify is not None:
            self._track_request(req, "isend", dest, tag)
        return req

    def isendrecv(self, sendobj: Any, dest: int, source: int = ANY_SOURCE,
                  sendtag: int = 0, recvtag: int = ANY_TAG) -> Request:
        """MPI_Isendrecv: the send completes on enqueue; the request is an
        irecv posted after it."""
        self.send(sendobj, dest, sendtag)
        return self.irecv(source, recvtag)

    def isendrecv_replace(self, buf, dest: int, source: int = ANY_SOURCE,
                          sendtag: int = 0, recvtag: int = ANY_TAG) -> Request:
        """MPI_Isendrecv_replace: the received payload overwrites ``buf`` in
        place at completion; the outgoing content is snapshotted now."""
        self.send(snapshot_payload(self._t, buf), dest, sendtag)
        inner = self.irecv(source, recvtag)
        if self._verify is not None and inner._vinfo is not None:
            # the replace writes ``buf`` in place at completion: a live
            # write buffer for the overlap (message-race) lint
            inner._vinfo.kind = "isendrecv_replace"
            self._verify.world.track_buffer(
                inner._vinfo, buf, inner._vinfo.describe(), writes=True)
        return _ReplaceRequest(inner, buf)

    def irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              buf: Any = None) -> Request:
        """MPI_Irecv: ``test()`` polls, ``wait()`` blocks; requests on the
        same (source, tag) complete in posted order.  ``buf`` (a tensor, an
        ndarray or a list of them) is filled in place at completion; on a
        steering transport (socket, shm) with a specific source and tag
        the matched frame's bytes land in it directly (the user-buffer
        rendezvous, ``recv_user_inplace`` / ``recv_user_fallbacks``)."""
        _check_user_tag(tag)
        req = self._irecv_internal(source, tag)
        if buf is not None:
            self._arm_user_recv(req, source, tag, buf)
        if self._verify is not None:
            self._track_request(req, "irecv", source, tag)
            if req._user_buf is not None and req._vinfo is not None:
                # a live WRITE buffer until completion: overlapping any
                # other pending op's buffer is the message-race lint
                bufs = buf if isinstance(buf, list) else [buf]
                for b in bufs:
                    self._verify.world.track_buffer(
                        req._vinfo, b, req._vinfo.describe(), writes=True)
        return req

    def _arm_user_recv(self, req: _RecvRequest, source: int, tag: int,
                       buf: Any) -> None:
        """Bind a user destination to a posted receive
        (``mpi_tpu/communicator.py:1758``): it is filled at completion,
        and — with a specific source, a user tag and an eligible
        destination on a steering transport — registered with the
        steering registry so the reader lands the matched frame's bytes
        in it directly (shared by ``irecv(buf=)`` and started
        ``recv_init`` handles)."""
        req._user_buf = buf
        reg = self._recv_reg
        bufs = buf if isinstance(buf, list) else [buf]
        if (reg is None or tag < 0 or source == ANY_SOURCE
                or not (0 <= source < self.size) or not bufs
                or not all(_recvpool.is_dest(b) for b in bufs)):
            return
        src_world = self._world(source)
        tok = req._steer_token
        if tok is None:
            # messages delivered before the channel's FIRST posted user
            # buffer were never counted: the mailbox backlog seeds the
            # pairing lag (recvpool.note_post_user)
            backlog = self._t.mailbox.count_matching(
                src_world, self._ctx, tag)
            tok = reg.note_post_user(src_world, self._ctx, tag, backlog)
            req._steer_token = tok
        reg.attach(tok, buf)
        req._user_armed = True

    def _irecv_internal(self, source: int, tag: int) -> _RecvRequest:
        """irecv without the user-tag gate — the engine posts pipelined
        receives on the internal _TAG_COLL tag through here."""
        with self._lock:
            queue = self._irecv_queues.setdefault((source, tag), [])
        req = _RecvRequest(self, source, tag, queue)
        reg = self._recv_reg
        if tag < 0 and source != ANY_SOURCE and reg is not None:
            # count the posted consumer on its steering channel; the
            # collective may attach a destination view to the token
            req._steer_token = reg.note_post(
                self._world(source), self._ctx, tag)
        elif (tag >= 0 and source != ANY_SOURCE and reg is not None
              and reg.user_count and 0 <= source < self.size
              and reg.user_active(self._world(source), self._ctx, tag)):
            # a BUFFERLESS user irecv on an active user channel is still
            # a counted consumer (pairing alignment); claimable only if
            # irecv(buf=) attaches a destination right after
            req._steer_token = reg.note_post_user(
                self._world(source), self._ctx, tag, claimable=False)
        if self._progress is not None:
            # background completion: the engine scans this comm's posted
            # queues while it has any
            self._progress.register(self)
        return req

    def send_init(self, buf: Any, dest: int, tag: int = 0) -> PersistentRequest:
        """MPI_Send_init: persistent send bound to ``buf``."""
        _check_user_tag(tag)
        self._world(dest)
        return PersistentRequest(self, "send", buf, dest, tag)

    def recv_init(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                  buf: Any = None) -> PersistentRequest:
        """MPI_Recv_init: persistent receive (refilling ``buf`` when given)."""
        _check_user_tag(tag)
        if source != ANY_SOURCE:
            self._world(source)
        return PersistentRequest(self, "recv", buf, source, tag)

    def probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              status: Optional[Status] = None) -> None:
        """MPI_Probe: wait until a matching message is queued (without
        consuming it); fills ``status`` with its envelope and size."""
        _check_user_tag(tag)
        src_world = ANY_SOURCE if source == ANY_SOURCE else self._world(source)
        if self._ft is not None or self._verify is not None:
            s, t, n = self._sliced_wait(src_world, tag, consume=False)
        else:
            s, t, n = self._t.peek(src_world, self._ctx, tag,
                                   timeout=self.recv_timeout)
        if status is not None:
            status._fill_envelope(self._from_world(s), t, n)

    def mprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
               status: Optional[Status] = None) -> Message:
        """MPI_Mprobe: block for a matching message and REMOVE it from
        matching; consume it later with ``message.recv()``."""
        _check_user_tag(tag)
        src_world = ANY_SOURCE if source == ANY_SOURCE else self._world(source)
        if self._ft is not None or self._verify is not None:
            obj, src, t = self._sliced_wait(src_world, tag)
        else:
            obj, src, t = self._plain_recv(src_world, tag)
        obj = self._note_probe_steal(obj, src, t)
        msg = Message(obj, self._from_world(src), t, comm=self)
        if status is not None:
            status._fill(msg.source, msg.tag, obj)
        return msg

    def _note_probe_steal(self, obj: Any, src_world: int, t: int) -> Any:
        """A matched probe REMOVED a message from matching: run it through
        the aliasing guard (it may be a steered destination an armed irecv
        owns) and shift the channel's pairing lag down
        (``recvpool.note_steal``)."""
        reg = self._recv_reg
        if reg is None or t < 0:
            return obj
        if reg.live_count:
            obj = reg.sanitize(obj)
        if reg.user_count:
            reg.note_steal(src_world, self._ctx, t)
        return obj

    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                status: Optional[Status] = None) -> Optional[Message]:
        """MPI_Improbe: non-blocking mprobe — a Message, or None."""
        _check_user_tag(tag)
        src_world = ANY_SOURCE if source == ANY_SOURCE else self._world(source)
        hit = self._t.poll(src_world, self._ctx, tag)
        if hit is None:
            self._empty_poll_check(source, tag)
            return None
        if self._verify is not None:
            self._verify.world.note_progress()
        obj, src, t = hit
        obj = self._note_probe_steal(obj, src, t)
        msg = Message(obj, self._from_world(src), t, comm=self)
        if status is not None:
            status._fill(msg.source, msg.tag, obj)
        return msg

    def iprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
               status: Optional[Status] = None) -> bool:
        """MPI_Iprobe: True iff a matching message is queued."""
        _check_user_tag(tag)
        src_world = ANY_SOURCE if source == ANY_SOURCE else self._world(source)
        hit = self._t.peek_nowait(src_world, self._ctx, tag)
        if hit is None:
            self._empty_poll_check(source, tag)
            return False
        if self._verify is not None:
            self._verify.world.note_progress()
        if status is not None:
            status._fill_envelope(self._from_world(hit[0]), hit[1], hit[2])
        return True

    def shift(self, obj: Any, offset: int = 1, wrap: bool = True, fill: Any = None) -> Any:
        self._coll_name = "shift"
        p, r = self.size, self._rank
        d, s = r + offset, r - offset
        if wrap:
            return self._sendrecv_internal(obj, d % p, s % p, _TAG_SHIFT)
        if 0 <= d < p:
            self._send_internal(obj, d, _TAG_SHIFT)
        if 0 <= s < p:
            return self._recv_internal(s, _TAG_SHIFT)
        return self._hole(obj, fill)

    def _hole(self, obj: Any, fill: Any) -> Any:
        """The boundary hole of a shift/exchange: a tensor payload gets a
        tensor-shaped fill (the SPMD backend's semantics), else ``fill``."""
        if fill is not None and hasattr(obj, "shape") and hasattr(obj, "dtype"):
            return torch.full_like(_as_tensor(obj, self.device), fill)
        return fill

    def exchange(self, obj: Any, pairs: Sequence[Tuple[int, int]],
                 fill: Any = None) -> Any:
        from .checker import validate_perm

        self._coll_name = "exchange"
        validate_perm(pairs, self.size)
        dsts = [d for s, d in pairs if s == self._rank]
        srcs = [s for s, d in pairs if d == self._rank]
        for d in dsts:
            self._send_internal(obj, d, _TAG_SHIFT)
        if srcs:
            return self._recv_internal(srcs[0], _TAG_SHIFT)
        return self._hole(obj, fill)

    # -- collectives -------------------------------------------------------

    def _verify_coll(self, coll: str, root: Optional[int] = None,
                     op: Any = None, payload: Any = None,
                     algorithm: Optional[str] = None,
                     counts: Optional[Tuple] = None) -> None:
        """Collective-matching hook (``verify/collcheck.py``): with the
        verifier on, circulate this entry's signature on the TAG_VERIFY
        ring and raise CollectiveMismatchError on divergence BEFORE any
        collective data moves."""
        if self._verify is not None and self.size > 1:
            if getattr(self, "_verify_sig_frozen", False):
                # persistent collective (nbc.py): the signature was
                # exchanged once at init, and the argument list is bound
                return
            from .verify import collcheck as _vcc

            _vcc.check(self, coll, root=root, op=op, payload=payload,
                       algorithm=algorithm, counts=counts)

    def _track_request(self, req: Request, kind: str, peer: int,
                       tag: int) -> Request:
        """Register a user-level nonblocking request with the verifier
        (leak / double-wait lints).  Caller checked ``self._verify``."""
        from .verify.state import user_site

        self._verify.world.track_request(req, kind, self._rank, peer, tag,
                                         user_site())
        return req

    @_traced_coll
    def bcast(self, obj: Any, root: int = 0, algorithm: str = "auto") -> Any:
        """MPI_Bcast over the binomial tree (``"tree"``; ``"fused"``
        aliases it); ``"sm"`` (shm transports) reads the root's arena slot
        in place; ``"auto"`` tries the arena where the transport has one.
        Large tensors take the SEGMENTED pipelined tree: the root
        announces the geometry with a _SegHeader, then every rank forwards
        each segment to its children the moment it lands."""
        _mpit.count(collectives=1)
        self._coll_name = "bcast"
        algorithm = _resolve_algorithm(
            "bcast", algorithm, ("auto", "tree") + _coll_sm.gate(self),
            {"fused": "tree"})
        self._world(root)  # validate
        self._verify_coll("bcast", root=root, algorithm=algorithm)
        if self.size == 1:
            return obj
        if algorithm in ("auto", "sm"):
            # the arena decides eligibility inside (only the root knows
            # the payload) and keeps the group in lockstep on a decline
            got = _coll_sm.bcast(self, obj, root)
            if got is not _coll_sm.FALLBACK:
                return got
        _note_alg("tree")
        parent, children = schedules.binomial_tree_links(
            self.size, self._rank, root)
        if self._rank == root:
            # size >= 3: with a single leaf there is no interior rank to
            # overlap forwarding with
            if (_codec.raw_eligible(obj) and self.size >= 3
                    and obj.nbytes >= _BCAST_SEGMENT_MIN_BYTES):
                arr = _codec.as_raw_array(obj)
                flat = arr.reshape(-1)
                spans = schedules.segment_spans(
                    0, flat.numel(), self._seg_elems(arr.element_size()))
                header = _SegHeader(_codec.dtype_name(arr.dtype),
                                    tuple(arr.shape), len(spans))
                for c in children:
                    self._send_internal(header, c, _TAG_COLL)
                for lo, hi in spans:
                    view = self._coll_payload(flat[lo:hi])
                    for c in children:
                        self._send_internal(view, c, _TAG_COLL)
                return obj
            for c in children:
                self._send_internal(obj, c, _TAG_COLL)
            return obj
        got = self._recv_internal(parent, _TAG_COLL)
        if isinstance(got, _SegHeader):
            # forward the header FIRST so the whole subtree allocates and
            # starts receiving before any payload bytes arrive
            for c in children:
                self._send_internal(got, c, _TAG_COLL)
            out = torch.empty(got.shape, dtype=_codec.dtype_of(got.dtype_name),
                              device=self.device)
            flat = out.view(-1)
            off = 0
            for _ in range(got.nseg):
                seg = self._recv_internal(parent, _TAG_COLL)
                n = seg.numel()
                flat[off:off + n].copy_(seg.reshape(-1))
                if children:
                    view = self._coll_payload(flat[off:off + n])
                    for c in children:
                        self._send_internal(view, c, _TAG_COLL)
                off += n
            return out
        for c in children:
            self._send_internal(got, c, _TAG_COLL)
        return got

    @_traced_coll
    def reduce(self, obj: Any, op: _ops.ReduceOp = _ops.SUM, root: int = 0,
               algorithm: str = "auto") -> Any:
        """MPI_Reduce over the binomial tree with in-place folds
        (``"tree"``; ``"fused"`` aliases it); ``"sm"`` (shm transports):
        ranks publish their payloads in the arena, the root folds them;
        ``"auto"`` tries the arena at eager sizes."""
        _mpit.count(collectives=1)
        self._coll_name = "reduce"
        algorithm = _resolve_algorithm(
            "reduce", algorithm, ("auto", "tree") + _coll_sm.gate(self),
            {"fused": "tree"})
        self._world(root)  # validate
        arr = _as_tensor(obj, self.device)
        self._verify_coll("reduce", root=root, op=op, payload=arr,
                          algorithm=algorithm)
        if algorithm in ("auto", "sm") and self.size > 1:
            got = _coll_sm.reduce(self, arr, op, root)
            if got is not _coll_sm.FALLBACK:
                (out,) = got
                return out if self._rank == root else None
        _note_alg("tree")
        acc = arr.detach().clone()
        for pairs in schedules.binomial_reduce_rounds(self.size, root):
            for s, d in pairs:
                if self._rank == s:
                    self._send_internal(self._coll_payload(acc), d, _TAG_COLL)
                elif self._rank == d:
                    # in place; a send of acc only happens in a LATER round
                    op.combine_into(acc, self._recv_internal(s, _TAG_COLL))
        return acc if self._rank == root else None

    @_traced_coll
    def allreduce(self, obj: Any, op: _ops.ReduceOp = _ops.SUM,
                  algorithm: str = "auto",
                  compress_key: Any = None) -> Any:
        """MPI_Allreduce.  ``algorithm``: ``"ring"`` (reduce-scatter ring +
        allgather ring), ``"recursive_halving"`` (power-of-two groups),
        ``"rabenseifner"`` (block-ring reduce_scatter + ring allgather,
        any group size), ``"reduce_bcast"``, ``"sm"`` (shm transports:
        the collective arena), or ``"auto"`` — a tuned table's row when
        one matches, else the arena first on shm transports, else the
        reference's size rule (``seed_allreduce_algorithm``); ``"fused"``
        aliases ``"auto"``.

        ``"compressed"`` / ``"compressed:bf16"`` / ``"compressed:int8"`` /
        ``"compressed:topk"`` (``compress.py``) split the wire dtype from
        the fold dtype; ineligible payloads decline group-coherently to
        ``"auto"`` (``compress_fallbacks``).  ``compress_key`` names the
        tensor a top-k error-feedback residual belongs to."""
        _mpit.count(collectives=1)
        self._coll_name = "allreduce"
        arr = _as_tensor(obj, self.device)
        algorithm = _resolve_algorithm(
            "allreduce", algorithm,
            ("auto", "ring", "recursive_halving", "rabenseifner",
             "reduce_bcast") + _compress.ALLREDUCE_NAMES
            + _coll_sm.gate(self), {"fused": "auto"})
        wire = vcounts = None
        if _compress.is_compressed(algorithm):
            # resolve BEFORE the signature exchange: the ring carries
            # "compressed:bf16" (and top-k's k), never the alias
            wire, algorithm, vcounts = _compress.resolve(
                self, "allreduce", arr, op, algorithm)
            _note_alg(algorithm)
        self._verify_coll("allreduce", op=op, payload=arr,
                          algorithm=algorithm, counts=vcounts)
        if wire is not None:
            if self.size == 1:
                return arr.detach().clone()
            if wire is _compress.TOPK:
                return _compress.topk_allreduce(self, arr, op,
                                                compress_key=compress_key)
            # shm transports: the arena's compressed eager path first
            got = _coll_sm.allreduce_wire(self, arr, op, wire)
            if got is not _coll_sm.FALLBACK:
                return got
            fold = arr.detach().to(_compress.fold_dtype(arr.dtype))
            return self._allreduce_ring(fold, op, wire=wire).to(arr.dtype)
        if algorithm == "auto" and self.size > 1:
            # tuned dispatch: a measured row for (transport, P, allreduce,
            # payload band) overrides the seed policy below, into the
            # arena or away from it
            pick = _tuning.pick(
                self, "allreduce", arr.nbytes,
                ("ring", "rabenseifner", "reduce_bcast")
                + (("recursive_halving",)
                   if schedules.is_pow2(self.size) else ())
                + _coll_sm.gate(self))
            if pick is not None:
                algorithm = pick
        if algorithm in ("auto", "sm") and self.size > 1:
            # shm transports: the collective arena first; on a decline the
            # wire auto policy picks the classic schedule
            got = _coll_sm.allreduce(self, arr, op)
            if got is not _coll_sm.FALLBACK:
                return got
            algorithm = "auto"
        if algorithm == "auto":
            algorithm = seed_allreduce_algorithm(arr.nbytes, self.size)
        _note_alg(algorithm)
        if self.size == 1:
            return arr.detach().clone()
        if algorithm == "ring":
            return self._allreduce_ring(arr, op)
        if algorithm == "recursive_halving":
            return self._allreduce_halving(arr, op)
        if algorithm == "rabenseifner":
            return self._allreduce_rabenseifner(arr, op)
        return self.bcast(self.reduce(arr, op, root=0), root=0)

    # -- segmented collective engine ----------------------------------------
    #
    # Every bandwidth-bound collective below works on ONE contiguous
    # working buffer on the payload's device: chunk boundaries come from
    # the pure tables of schedules.py (chunk_offsets / segment_spans),
    # payloads are VIEWS of the buffer, accumulation is in place
    # (op.combine_into), and each exchange step is pipelined — segments
    # stream while earlier segments fold.

    def _coll_payload(self, view: torch.Tensor) -> torch.Tensor:
        """Aliasing transports deliver by reference while the engine folds
        into its working buffer in place: hand them a snapshot."""
        return view.clone() if self._t.aliases_payloads else view

    def _seg_payload(self, view: torch.Tensor, wire) -> Any:
        """One pipeline segment as sent: encoded by ``wire`` (fresh
        tensors: no snapshot needed), else the plain view."""
        return (wire.encode(view) if wire is not None
                else self._coll_payload(view))

    def _seg_elems(self, itemsize: int) -> int:
        """Pipeline segment size in ELEMENTS: the collective_segment_bytes
        cvar when nonzero, else the transport's coll_segment_hint."""
        nbytes = _SEGMENT_BYTES or getattr(
            self._t, "coll_segment_hint", Transport.coll_segment_hint)
        return max(1, nbytes // max(1, itemsize))

    @staticmethod
    def _count_recv_store(dests) -> None:
        """Price a fold-site store whose destination WAS registered for
        steering but whose payload came through the pool path anyway —
        counted only while steering is switched off (whether one frame
        steers is a reader-vs-poster race; the counts the tests pin must
        stay deterministic)."""
        if dests is not None and not _recvpool._STEERING:
            _mpit.count(copies=1)

    def _seg_exchange(self, work: torch.Tensor, sbounds: Tuple[int, int],
                      rbounds: Tuple[int, int], dest: int, src: int,
                      op: Optional[_ops.ReduceOp] = None,
                      wire=None) -> None:
        """One pipelined exchange step: send ``work[sbounds]`` to ``dest``
        while receiving the same-global-range ``rbounds`` from ``src``,
        folding (``op``) or copying (``op=None``) each segment into the
        working buffer as it lands.  Receives are posted up front (they
        complete in posted order, matching the sender's FIFO channel);
        sends run at most _SEG_WINDOW segments ahead of the receive
        pointer.  Both sides derive spans from the same global tables, so
        message boundaries agree with no metadata traffic.

        ``wire`` (``compress.py``) is the wire-dtype != fold-dtype seam:
        each outgoing segment is ENCODED at send time and DECODED at its
        fold or copy site, so compression composes with the pipeline and
        the engine's credit callbacks unchanged."""
        seg = self._seg_elems(work.element_size())
        decode = None if wire is None else wire.decode
        sspans = schedules.segment_spans(sbounds[0], sbounds[1], seg)
        rspans = schedules.segment_spans(rbounds[0], rbounds[1], seg)
        # Pure-copy spans may land DIRECTLY in the working buffer on a
        # steering transport: register each posted receive's destination
        # view.  Fold spans never are (an early arrival would clobber the
        # accumulator before the fold reads it).  A steered segment is
        # recognised by identity (the delivered payload IS the view).
        dests = None
        if op is None and wire is None and self._recv_reg is not None:
            dests = [work[lo:hi] for lo, hi in rspans]
        eng = self._progress
        sender = None
        if eng is not None and len(sspans) > _SEG_WINDOW:
            # engine mode: the sends beyond the initial credit are posted
            # by whoever COMPLETES each receive (normally the engine, via
            # _on_complete), so the window advances while the caller
            # folds.  Receives are posted and their callbacks attached
            # under the completion lock, or an early completion in the
            # gap would lose its send credit.
            sender = _SegSender(self, work, sspans, dest, wire)
        reqs = []
        with (eng.cv if sender is not None else contextlib.nullcontext()):
            for i in range(len(rspans)):
                req = self._irecv_internal(src, _TAG_COLL)
                if dests is not None:
                    self._recv_reg.attach(req._steer_token, dests[i])
                if sender is not None:
                    req._on_complete = sender.advance
                reqs.append(req)
        try:
            si = 0
            if sender is not None:
                sender.post(_SEG_WINDOW)
                si = len(sspans)  # the sender owns every later send
            while si < min(len(sspans), _SEG_WINDOW):
                lo, hi = sspans[si]
                self._send_internal(self._seg_payload(work[lo:hi], wire),
                                    dest, _TAG_COLL)
                si += 1
            for seg_i, ((lo, hi), req) in enumerate(zip(rspans, reqs)):
                if sender is not None:
                    sender.check()  # engine-side send failures surface
                got = req.wait()
                view = work[lo:hi] if dests is None else dests[seg_i]
                if op is None:
                    if got is not view:  # else: steered in place
                        # the working buffer's spans were just SENT:
                        # retained frames must snapshot before this write
                        _bufpool.touch(view)
                        view.copy_(got if decode is None else decode(got))
                        self._count_recv_store(dests)
                else:
                    op.combine_into(view, got, decode)
                if si < len(sspans):
                    slo, shi = sspans[si]
                    self._send_internal(
                        self._seg_payload(work[slo:shi], wire), dest,
                        _TAG_COLL)
                    si += 1
            while si < len(sspans):  # recv range empty/shorter: drain tail
                slo, shi = sspans[si]
                self._send_internal(self._seg_payload(work[slo:shi], wire),
                                    dest, _TAG_COLL)
                si += 1
            if sender is not None:
                sender.drain()
        except BaseException as e:
            if isinstance(e, ProcFailedError) and e.segment is None:
                # name the pipeline segment in flight: the first receive
                # not yet completed (a send failure included)
                e.segment = next((i for i, q in enumerate(reqs)
                                  if not q._done), len(reqs))
            # a failed exchange must not leave stale queue heads on the
            # internal (src, _TAG_COLL) channel
            _unpost(reqs)
            raise

    def _allreduce_ring(self, arr: torch.Tensor, op: _ops.ReduceOp,
                        wire=None) -> torch.Tensor:
        # reduce-scatter ring + allgather ring, 2(P-1) steps, segmented
        # and in place on one flat working copy of the input; ``wire``
        # encodes BOTH phases (partial sums and reduced chunks), so the
        # quantization error compounds about linearly in P
        p, r = self.size, self._rank
        work = _flat_copy(arr)
        offs = schedules.chunk_offsets(work.numel(), p)
        right, left = (r + 1) % p, (r - 1) % p
        for step in range(p - 1):
            si = schedules.ring_rs_send_chunk(r, step, p)
            ri = schedules.ring_rs_recv_chunk(r, step, p)
            self._seg_exchange(work, (offs[si], offs[si + 1]),
                               (offs[ri], offs[ri + 1]), right, left, op,
                               wire=wire)
        for step in range(p - 1):
            si = schedules.ring_ag_send_chunk(r, step, p)
            ri = schedules.ring_ag_recv_chunk(r, step, p)
            self._seg_exchange(work, (offs[si], offs[si + 1]),
                               (offs[ri], offs[ri + 1]), right, left,
                               wire=wire)
        return work.view(arr.shape)

    def _allreduce_halving(self, arr: torch.Tensor, op: _ops.ReduceOp) -> torch.Tensor:
        # recursive-halving reduce-scatter + recursive-doubling allgather
        # (power-of-two groups): chunks [a, b) of the flat buffer are the
        # contiguous range [offs[a], offs[b]), one frame per segment
        p, r = self.size, self._rank
        work = _flat_copy(arr)
        offs = schedules.chunk_offsets(work.numel(), p)
        masks = schedules.halving_masks(p)
        lo, hi = 0, p
        for mask in masks:
            partner = r ^ mask
            mid = (lo + hi) // 2
            if r & mask:
                mine, theirs = (mid, hi), (lo, mid)
            else:
                mine, theirs = (lo, mid), (mid, hi)
            self._seg_exchange(work, (offs[theirs[0]], offs[theirs[1]]),
                               (offs[mine[0]], offs[mine[1]]),
                               partner, partner, op)
            lo, hi = mine
        # now [lo, hi) == [r, r+1): rank r holds reduced chunk r
        for mask in reversed(masks):
            partner = r ^ mask
            w = hi - lo
            rb = (lo - w, lo) if r & mask else (hi, hi + w)
            self._seg_exchange(work, (offs[lo], offs[hi]),
                               (offs[rb[0]], offs[rb[1]]), partner, partner)
            lo, hi = (rb[0], hi) if r & mask else (lo, rb[1])
        return work.view(arr.shape)

    def _allreduce_rabenseifner(self, arr: torch.Tensor,
                                op: _ops.ReduceOp) -> torch.Tensor:
        # block-ring reduce_scatter (rank r ends owning reduced chunk r) +
        # ring allgather of the reduced chunks: the ring's 2(P-1) steps and
        # volume, phase one being the reduce_scatter collective's schedule
        p, r = self.size, self._rank
        work = _flat_copy(arr)
        offs = schedules.chunk_offsets(work.numel(), p)
        right, left = (r + 1) % p, (r - 1) % p
        for step in range(p - 1):
            si = schedules.ring_rs_block_send_chunk(r, step, p)
            ri = schedules.ring_rs_block_recv_chunk(r, step, p)
            self._seg_exchange(work, (offs[si], offs[si + 1]),
                               (offs[ri], offs[ri + 1]), right, left, op)
        for step in range(p - 1):
            si = schedules.ring_ag_block_send_chunk(r, step, p)
            ri = schedules.ring_ag_block_recv_chunk(r, step, p)
            self._seg_exchange(work, (offs[si], offs[si + 1]),
                               (offs[ri], offs[ri + 1]), right, left)
        return work.view(arr.shape)

    @_traced_coll
    def allgather(self, obj: Any, algorithm: str = "auto") -> Any:
        """MPI_Allgather.  ``algorithm``: ``"ring"`` (rotating row views of
        one ``[P, ...]`` buffer), ``"doubling"`` (recursive doubling,
        power-of-two groups), or ``"auto"`` — doubling on power-of-two
        groups, the ring otherwise (the pick depends only on the group
        shape), after the arena on shm transports (``"sm"``: every rank
        reads every slot in place; ragged or object payloads decline
        inside the arena, on every rank together); ``"fused"`` aliases
        ``"auto"``.  Equal-geometry tensors come back stacked ``[P,
        ...]``, anything else as a list."""
        _mpit.count(collectives=1)
        self._coll_name = "allgather"
        p, r = self.size, self._rank
        algorithm = _resolve_algorithm(
            "allgather", algorithm,
            ("auto", "ring", "doubling") + _coll_sm.gate(self),
            {"fused": "auto"})
        self._verify_coll("allgather", algorithm=algorithm)
        if algorithm in ("auto", "sm") and p > 1:
            got = _coll_sm.allgather(self, obj)
            if got is not _coll_sm.FALLBACK:
                (got_items,) = got
                return _maybe_stack(obj, got_items)
            algorithm = "auto"
        if algorithm == "auto":
            algorithm = _note_alg("doubling" if schedules.is_pow2(p)
                                  else "ring")
        items: List[Any] = [None] * p
        items[r] = obj
        if p == 1:
            return items
        if algorithm == "ring":
            right, left = (r + 1) % p, (r - 1) % p
            arr = _codec.as_raw_array(obj)
            if arr is not None:
                # row-buffer fast path: rows are views of ONE [p, ...]
                # working buffer, and the result is that buffer.  The wire
                # protocol is the generic path's (one frame per step), so
                # a row that does not fit the local geometry (ragged
                # allgather) falls back to object storage for that slot.
                work = torch.empty((p,) + tuple(arr.shape), dtype=arr.dtype,
                                   device=arr.device)
                work[r].copy_(arr)
                ragged: dict = {}

                def slot(i: int) -> Any:
                    if i in ragged:
                        return ragged[i]
                    return self._coll_payload(work[i])

                for step in range(p - 1):
                    si = schedules.ring_ag_send_chunk(r, step + 1, p)
                    ri = schedules.ring_ag_recv_chunk(r, step + 1, p)
                    self._send_internal(slot(si), right, _TAG_COLL)
                    got = self._recv_internal(left, _TAG_COLL)
                    # exact type, as codec.raw_eligible: a tensor SUBCLASS
                    # row stays a ragged object
                    if (type(got) is torch.Tensor and got.shape == arr.shape
                            and got.dtype == arr.dtype):
                        work[ri].copy_(got)
                    else:
                        ragged[ri] = got
                if not ragged:
                    return work
                items = [ragged[i] if i in ragged else work[i]
                         for i in range(p)]
                items[r] = obj
                return _maybe_stack(obj, items)
            for step in range(p - 1):
                si = schedules.ring_ag_send_chunk(r, step + 1, p)
                ri = schedules.ring_ag_recv_chunk(r, step + 1, p)
                items[ri] = self._sendrecv_internal(items[si], right, left, _TAG_COLL)
        else:
            # Each round exchanges the whole owned batch: when every owned
            # value is raw-eligible, as a keyed LIST [int64 rank indices,
            # *values] (ONE multi-segment raw frame); otherwise as a dict
            # (pickle).  Each message's form is told apart by its type.
            owned = {r: obj}
            for mask in schedules.doubling_masks(p):
                partner = r ^ mask
                ks = sorted(owned)
                vals = [owned[k] for k in ks]
                if all(_codec.raw_eligible(v) for v in vals):
                    batch: Any = [torch.tensor(ks, dtype=torch.int64)] + vals
                else:
                    batch = owned
                recvd = self._sendrecv_internal(batch, partner, partner,
                                                _TAG_COLL)
                if isinstance(recvd, list):
                    # the rank indices are control data (a few ints)
                    owned.update(zip(recvd[0].tolist(), recvd[1:]))
                else:
                    owned.update(recvd)
            for i, v in owned.items():
                items[i] = v
        return _maybe_stack(obj, items)

    @_traced_coll
    def alltoall(self, objs: Sequence[Any], algorithm: str = "auto") -> Any:
        """MPI_Alltoall by windowed nonblocking pairwise exchange
        (``"pairwise"``; ``"fused"`` aliases it): all P-1 receives are
        posted up front and the sends run at most _SEG_WINDOW rounds ahead
        of the completed receives.  ``"sm"`` (shm transports): each rank
        writes its ``[P, ...]`` stack once and reads its column in place;
        ``"auto"`` tries the arena where the transport has one."""
        _mpit.count(collectives=1)
        self._coll_name = "alltoall"
        p, r = self.size, self._rank
        algorithm = _resolve_algorithm(
            "alltoall", algorithm, ("auto", "pairwise") + _coll_sm.gate(self),
            {"fused": "pairwise"})
        if len(objs) != p:
            raise ValueError(f"alltoall needs one payload per rank ({p}), got {len(objs)}")
        self._verify_coll("alltoall", algorithm=algorithm)
        tuned_wire = False
        if algorithm == "auto" and p > 1:
            # tuned dispatch.  Alltoall payloads may be rank-varying, so a
            # "pairwise" row never skips the arena's negotiation: this
            # rank enters it with no payload, which lands the whole group
            # on pairwise together
            try:
                nb = self._blocks_nbytes(objs)
            except (ValueError, TypeError, RuntimeError):
                nb = None
            if nb is not None:
                pick = _tuning.pick(self, "alltoall", nb,
                                    ("pairwise",) + _coll_sm.gate(self))
                tuned_wire = pick == "pairwise"
        if algorithm in ("auto", "sm") and p > 1:
            # the stacked view is built only when the payload fits a slot;
            # ragged or object payloads decline inside the arena
            arena = _coll_sm.arena_for(self)
            arr_sm = None
            if arena is not None and not tuned_wire:
                try:
                    if self._blocks_nbytes(objs) <= arena.capacity:
                        arr_sm = self._blocks_as_array(objs)
                except (ValueError, TypeError, RuntimeError):
                    arr_sm = None
            got = _coll_sm.alltoall(self, arr_sm)
            if got is not _coll_sm.FALLBACK:
                (items,) = got
                return _maybe_stack(objs, items)
        _note_alg("pairwise")
        result: List[Any] = [None] * p
        result[r] = objs[r]
        rounds = schedules.alltoall_rounds(p)
        reqs = [self._irecv_internal((r - k) % p, _TAG_COLL) for k in rounds]
        done = 0
        try:
            for i, k in enumerate(rounds):
                dst = (r + k) % p
                self._send_internal(objs[dst], dst, _TAG_COLL)
                if i - done >= _SEG_WINDOW:
                    result[(r - rounds[done]) % p] = reqs[done].wait()
                    done += 1
            while done < len(reqs):
                result[(r - rounds[done]) % p] = reqs[done].wait()
                done += 1
        except BaseException:
            _unpost(reqs)
            raise
        return _maybe_stack(objs, result)

    @_traced_coll
    def barrier(self, algorithm: str = "auto") -> None:
        """MPI_Barrier by dissemination, ceil(log2 P) message rounds
        (``"dissemination"``; ``"fused"`` aliases it); ``"sm"`` (shm
        transports): one flag round in the arena, no messages; ``"auto"``
        takes the arena where the transport has one."""
        _mpit.count(collectives=1)
        self._coll_name = "barrier"
        algorithm = _resolve_algorithm(
            "barrier", algorithm,
            ("auto", "dissemination") + _coll_sm.gate(self),
            {"fused": "dissemination"})
        self._verify_coll("barrier", algorithm=algorithm)
        p, r = self.size, self._rank
        if algorithm in ("auto", "sm") and p > 1:
            if _coll_sm.barrier(self) is not _coll_sm.FALLBACK:
                return
        _note_alg("dissemination")
        for off in schedules.dissemination_offsets(p):
            self._send_internal(None, (r + off) % p, _TAG_BARRIER)
            self._recv_internal((r - off) % p, _TAG_BARRIER)

    @_traced_coll
    def scan(self, obj: Any, op: _ops.ReduceOp = _ops.SUM,
             algorithm: str = "auto") -> Any:
        """MPI_Scan by Hillis-Steele distance doubling, log2(P) rounds
        (``"doubling"``; ``"fused"`` aliases it); ``"sm"`` (shm
        transports): write own payload, one flag round, rank r folds slots
        0..r in place; ``"auto"`` tries the arena where there is one."""
        _mpit.count(collectives=1)
        self._coll_name = "scan"
        arr = _as_tensor(obj, self.device)
        algorithm = _resolve_algorithm(
            "scan", algorithm, ("auto", "doubling") + _coll_sm.gate(self),
            {"fused": "doubling"})
        self._verify_coll("scan", op=op, payload=arr, algorithm=algorithm)
        if algorithm in ("auto", "sm") and self.size > 1:
            got = _coll_sm.scan(self, arr, op)
            if got is not _coll_sm.FALLBACK:
                (out,) = got
                return out
        _note_alg("doubling")
        acc = arr.detach().clone()
        p, r = self.size, self._rank
        d = 1
        while d < p:
            if r + d < p:
                self._send_internal(acc, r + d, _TAG_COLL)
            if r - d >= 0:
                recvd = self._recv_internal(r - d, _TAG_COLL)
                # the received prefix goes LEFT.  A copying transport hands
                # us a private buffer, so the fold runs in place into it;
                # an aliasing one hands us the SENDER's accumulator, which
                # must never be mutated
                if (not self._t.aliases_payloads
                        and type(recvd) is torch.Tensor
                        and recvd.shape == acc.shape
                        and recvd.dtype == acc.dtype
                        and recvd.device == acc.device):
                    acc = op.combine_into(recvd, acc)
                else:
                    acc = op.combine(recvd, acc)
            d *= 2
        return acc

    def _blocks_nbytes(self, blocks: Any) -> int:
        """Total size of a reduce_scatter input, copy-free (homogeneous
        blocks assumed — the heterogeneous case never segments)."""
        if isinstance(blocks, torch.Tensor):
            return int(blocks.nbytes)
        return int(_as_tensor(blocks[0], self.device).nbytes) * len(blocks)

    def _blocks_as_array(self, blocks: Any) -> Optional[torch.Tensor]:
        """The ``[P, ...]`` tensor of a reduce_scatter payload when every
        block agrees in dtype and shape (the segmented ring's eligibility
        test), else None → the per-chunk path."""
        if isinstance(blocks, torch.Tensor):
            return blocks
        ts = [_as_tensor(b, self.device) for b in blocks]
        first = ts[0]
        if any(t.dtype != first.dtype or t.shape != first.shape
               or t.device != first.device for t in ts[1:]):
            return None
        return torch.stack(ts)

    @_traced_coll
    def reduce_scatter(self, blocks: Any, op: _ops.ReduceOp = _ops.SUM,
                       algorithm: str = "auto") -> Any:
        """MPI_Reduce_scatter_block: ``blocks`` holds one block per rank;
        rank r gets the reduction of everyone's block r.  ``"ring"`` (P-1
        steps — segmented on one flat working buffer when the blocks are
        homogeneous and the payload large, per-chunk otherwise;
        ``"fused"`` aliases it); ``"sm"`` (shm transports): write the
        whole input, fold block ``rank`` reading peers in place; ``"auto"``
        — a tuned row, else the arena first on shm transports, else the
        ring.  ``"compressed"`` / ``"compressed:bf16"`` /
        ``"compressed:int8"`` run the block ring with encoded segments and
        float32 folds (float64 for float64 payloads)."""
        _mpit.count(collectives=1)
        self._coll_name = "reduce_scatter"
        p, r = self.size, self._rank
        algorithm = _resolve_algorithm(
            "reduce_scatter", algorithm,
            ("auto", "ring") + _compress.REDUCE_SCATTER_NAMES
            + _coll_sm.gate(self), {"fused": "ring"})
        if len(blocks) != p:
            raise ValueError(
                f"reduce_scatter needs one block per rank ({p}), got {len(blocks)}")
        block0 = _as_tensor(blocks[0], self.device)
        wire = None
        if _compress.is_compressed(algorithm):
            # the resolved wire dtype goes into the signature
            wire, algorithm, _ = _compress.resolve(
                self, "reduce_scatter", block0, op, algorithm)
        # geometry class of block 0 plus the block count: mismatched
        # reduce geometry is flagged before the ring can misfold
        self._verify_coll("reduce_scatter", op=op, payload=block0,
                          algorithm=algorithm, counts=(p,))
        if algorithm == "auto" and p > 1:
            # tuned dispatch: the measured arena-vs-wire-ring axis
            pick = _tuning.pick(self, "reduce_scatter",
                                self._blocks_nbytes(blocks),
                                ("ring",) + _coll_sm.gate(self))
            if pick is not None:
                algorithm = pick
        if algorithm in ("auto", "sm") and p > 1:
            # the stacked view is built only when the payload fits a slot;
            # an ineligible rank enters with no payload and the in-arena
            # negotiation lands everyone on the ring together
            arena = _coll_sm.arena_for(self)
            arr_sm = (self._blocks_as_array(blocks)
                      if arena is not None
                      and self._blocks_nbytes(blocks) <= arena.capacity
                      else None)
            got = _coll_sm.reduce_scatter(self, arr_sm, op)
            if got is not _coll_sm.FALLBACK:
                (out,) = got
                return out
        # size-gate BEFORE stacking: for list payloads eligibility stacks
        # the blocks, a copy the per-chunk path would throw away
        nbytes = self._blocks_nbytes(blocks)
        use_seg = (wire is not None or nbytes >= _RS_SEGMENT_MIN_BYTES
                   or 0 < _SEGMENT_BYTES < nbytes)
        arr = self._blocks_as_array(blocks) if use_seg and p > 1 else None
        if wire is not None and arr is None:
            # heterogeneous blocks cannot ride the flat working buffer the
            # encoded exchange needs; block geometry is congruent across
            # ranks, so every rank declines together
            _compress._decline()
            wire = None
        _note_alg(algorithm if wire is not None else "ring")
        if arr is not None:
            if wire is not None:
                # the fold-dtype cast is itself the fresh working buffer
                work = arr.detach().reshape(-1).to(
                    _compress.fold_dtype(arr.dtype))
                if work.data_ptr() == arr.data_ptr():
                    work = work.clone()
            else:
                # list payloads were just STACKED into a fresh buffer nobody
                # else holds; a tensor payload aliases the caller's memory
                work = (_flat_copy(arr) if isinstance(blocks, torch.Tensor)
                        else arr.view(-1))
            bn = work.numel() // p
            right, left = (r + 1) % p, (r - 1) % p
            for step in range(p - 1):
                si = schedules.ring_rs_block_send_chunk(r, step, p)
                ri = schedules.ring_rs_block_recv_chunk(r, step, p)
                self._seg_exchange(work, (si * bn, (si + 1) * bn),
                                   (ri * bn, (ri + 1) * bn), right, left, op,
                                   wire=wire)
            # own block copied out so the P·n working buffer is released
            mine = work[r * bn:(r + 1) * bn].view(arr.shape[1:])
            return (mine.to(arr.dtype) if mine.dtype != arr.dtype
                    else mine.clone())
        # Generic path: only the chunks this rank folds INTO need a private
        # copy — chunk (r-1)%p is sent in step 0 and never touched again,
        # so it stays a view of the caller's data
        view_only = (r - 1) % p
        chunks = [_as_tensor(b, self.device) if i == view_only and p > 1
                  else _as_tensor(b, self.device).detach().clone()
                  for i, b in enumerate(blocks)]
        if p == 1:
            return chunks[0]
        right, left = (r + 1) % p, (r - 1) % p
        for step in range(p - 1):
            si = schedules.ring_rs_block_send_chunk(r, step, p)
            ri = schedules.ring_rs_block_recv_chunk(r, step, p)
            payload = self._coll_payload(chunks[si]) if step == 0 \
                else chunks[si]
            recvd = self._sendrecv_internal(payload, right, left, _TAG_COLL)
            mine = chunks[ri]
            # in-place fold only when the received chunk matches exactly;
            # cross-rank drift keeps the allocating combine
            if (type(recvd) is torch.Tensor and recvd.shape == mine.shape
                    and recvd.dtype == mine.dtype):
                op.combine_into(mine, recvd)
            else:
                chunks[ri] = torch.as_tensor(op.combine(mine, recvd))
        return chunks[r]

    @_traced_coll
    def scatter(self, objs: Optional[Sequence[Any]], root: int = 0) -> Any:
        """MPI_Scatter: rank d receives ``objs[d]`` from ``root``; the
        root's fan-out is nonblocking (every payload enqueued first)."""
        _mpit.count(collectives=1)
        self._coll_name = "scatter"
        self._world(root)  # validate
        self._verify_coll("scatter", root=root)
        if self._rank == root:
            if objs is None or len(objs) != self.size:
                raise ValueError(f"scatter root needs one payload per rank ({self.size})")
            for d in range(self.size):
                if d != root:
                    self._send_internal(objs[d], d, _TAG_COLL)
            return objs[root]
        return self._recv_internal(root, _TAG_COLL)

    @_traced_coll
    def gather(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        """MPI_Gather: root returns ``[payload_0, ..., payload_{P-1}]``,
        every receive posted up front (nonblocking fan-in)."""
        _mpit.count(collectives=1)
        self._coll_name = "gather"
        self._world(root)  # validate
        self._verify_coll("gather", root=root)
        if self._rank == root:
            items: List[Any] = [None] * self.size
            items[root] = obj
            srcs = [s for s in range(self.size) if s != root]
            reqs = [self._irecv_internal(s, _TAG_COLL) for s in srcs]
            try:
                for s, req in zip(srcs, reqs):
                    items[s] = req.wait()
            except BaseException:
                _unpost(reqs)
                raise
            return items
        self._send_internal(obj, root, _TAG_COLL)
        return None

    def win_create(self, init: Any):
        """MPI_Win_create: an RMA window over this communicator
        (``window.P2PWindow``) — fence epochs, passive target, PSCW and
        the MPI-3 atomics.  Collective."""
        from .window import P2PWindow

        return P2PWindow(self, init)

    def win_create_dynamic(self):
        """MPI_Win_create_dynamic: a window with no initial memory
        (``window.DynamicWindow``; regions addressed by key in every op's
        ``loc``).  Collective."""
        from .window import DynamicWindow

        return DynamicWindow(self)

    # -- fault tolerance (ULFM, ft.py) ----------------------------------------

    def _require_ft(self, what: str):
        if self._ft is None:
            raise RuntimeError(
                f"{what}() needs fault tolerance enabled on this "
                f"communicator: mpi_tpu_torch.ft.enable(comm), MPI_TPU_FT=1 "
                f"under the launcher, or run(..., backend='local', "
                f"fault_tolerance=True)")
        return self._ft

    @property
    def revoked(self) -> bool:
        """True once this communicator was revoked (locally or by a
        delivered remote revocation)."""
        return self._ft is not None and self._ft.revoked

    def revoke(self) -> None:
        """MPIX_Comm_revoke: mark this communicator dead everywhere — a
        best-effort notice to every other rank on the reserved control
        tag; every rank entering or blocked inside an operation on it
        raises RevokedError.  Not collective."""
        from . import ft as _ftm

        ft = self._require_ft("revoke")
        if not ft.revoked:
            ft.revoked = True
            _mpit.count(revokes=1)
        for peer in range(self.size):
            if peer == self._rank:
                continue
            try:
                self._t.send(self._group[peer], ft.home_ctx,
                             _ftm.TAG_REVOKE, None)
            except (TransportError, ValueError):
                pass  # dead or unreachable peers need no revocation

    def get_failed(self) -> List[int]:
        """The comm ranks this process currently believes dead (sorted;
        empty without fault tolerance)."""
        from . import ft as _ftm

        return _ftm.failed_comm_ranks(self)

    def failure_ack(self) -> List[int]:
        """MPIX_Comm_failure_ack: acknowledge every known failure —
        wildcard receives stop raising for these ranks and ``agree`` stops
        treating them as fatal.  Returns the acknowledged comm ranks."""
        ft = self._require_ft("failure_ack")
        failed = set(self.get_failed())
        ft.acked |= failed
        # world-level record: membership's re-admission gate
        ft.world.ack_world(self._group[r] for r in failed)
        return sorted(ft.acked)

    def failure_get_acked(self) -> List[int]:
        """MPIX_Comm_failure_get_acked."""
        return sorted(self._require_ft("failure_get_acked").acked)

    def shrink(self) -> "P2PCommunicator":
        """MPIX_Comm_shrink: the survivors agree on the failed set
        (``ft._agreement``) and return a dense sub-communicator of the
        survivors, ordered by old rank.  Valid on a revoked communicator
        (the agreement runs below the revocation check).  Shrinking a
        world-generation communicator bumps the membership epoch in
        survivor lockstep."""
        from . import ft as _ftm

        ft = self._require_ft("shrink")
        view, _ = _ftm._agreement(self, _ftm.TAG_SHRINK, True)
        if (view >> self._rank) & 1:
            raise ProcFailedError(
                f"rank {self._rank}: suspected dead by the survivors during "
                f"shrink (false suspicion: this rank stalled past the "
                f"detection bound)", failed=(self._rank,),
                collective="shrink")
        survivors = [q for q in range(self.size) if not (view >> q) & 1]
        # derived from AGREED state with no further communication, the
        # agreement epoch included: two shrinks with the same failed set
        # get distinct contexts
        ctx = (self._ctx, "shrink", ft.current_epoch(_ftm.TAG_SHRINK),
               tuple(survivors))
        new = P2PCommunicator(self._t, [self._group[q] for q in survivors],
                              ctx, recv_timeout=self.recv_timeout)
        new._ft = _ftm.CommFT(ft.world, ctx)
        # only world-GENERATION comms (the world at creation, or an earlier
        # generation's shrink) bump the epoch: a sub-communicator's shrink
        # is no membership change
        if self._ctx in getattr(self._t, "_gen_ctxs", ()):
            self._t.epoch += 1
            self._t._gen_ctxs.add(ctx)
        _mpit.count(shrinks=1)
        return self._inherit_errhandler(new)

    def _mark_generation(self) -> "P2PCommunicator":
        """Register this communicator as a world-GENERATION comm: its
        ``shrink()`` is a membership transition and bumps the epoch.
        Marked at the world-creation sites (``init``, ``run_local``,
        ``rejoin``, ``accept_rejoin``) and propagated by ``shrink``."""
        if not hasattr(self._t, "_gen_ctxs"):
            self._t._gen_ctxs = set()
        self._t._gen_ctxs.add(self._ctx)
        return self

    @property
    def membership_epoch(self) -> int:
        """The monotone membership epoch of this communicator's world: 0
        at creation, bumped by every world ``shrink()``; stamped into the
        socket hello so generations never cross-wire."""
        return self._t.epoch

    def accept_rejoin(self, timeout: Optional[float] = None
                      ) -> "P2PCommunicator":
        """Elastic recovery, collective over the SURVIVORS (call it on the
        communicator ``shrink()`` returned): announce the vacant world
        slots under the current epoch on the rendezvous dir, admit fresh
        processes' claims (refusing an ousted-but-live incarnation until
        its failure was ``failure_ack``ed), wait for every replacement,
        and return a FULL-SIZE communicator over the world under the new
        epoch.  The joiner side is ``mpi_tpu_torch.membership.rejoin()``."""
        from . import membership as _membership

        return _membership.accept_rejoin(self, timeout=timeout)

    def agree(self, value: bool = True) -> bool:
        """MPIX_Comm_agree: fault-tolerant agreement on the AND of every
        live rank's ``value``.  Completes despite failures; raises
        ProcFailedError AFTER the agreement when a member is dead and not
        acknowledged (the agreed value rides on it as ``.value``)."""
        from . import ft as _ftm

        ft = self._require_ft("agree")
        view, anded = _ftm._agreement(self, _ftm.TAG_AGREE, value)
        failed = [q for q in range(self.size) if (view >> q) & 1]
        if set(failed) - ft.acked:
            exc = ProcFailedError(
                f"rank {self._rank}: agreement completed but members are "
                f"dead and unacknowledged", failed=failed,
                collective="agree")
            exc.value = anded
            raise exc
        return anded

    # -- nonblocking collectives (MPI-3 MPI_Ibcast & co.) ----------------------

    def _nbc_comm(self) -> "P2PCommunicator":
        """Isolated-context clone for ONE nonblocking collective: every
        rank issues them in the same order, so the per-comm counter gives
        the same context on every rank with no communication."""
        with self._lock:
            self._nbc_count = getattr(self, "_nbc_count", 0) + 1
            k = self._nbc_count
        c = P2PCommunicator(self._t, self._group, (self._ctx, "nbc", k),
                            recv_timeout=self.recv_timeout)
        # SHARE the parent's fault-tolerance state: revoking the parent
        # must unblock its collectives in flight
        c._ft = self._ft
        if self._verify is not None:
            # fresh per-comm sequence (the clone's ctx isolates its
            # TAG_VERIFY traffic); single-use machinery, so not in the
            # unfreed-comm registry
            from .verify.state import CommVerify

            c._verify = CommVerify(self._verify.world)
        # no collective arena on clones: each is single-use, and an arena
        # per clone would map (and unlink) a segment per call
        c._no_coll_sm = True
        return c

    def _nbc_issue(self, kind: str, fn, *args: Any, **kwargs: Any) -> Request:
        """Issue one i-collective on the default stream: a schedule state
        machine on the progress engine when this call compiles into one
        (``nbc.py``), else the blocking algorithm ``fn(clone)`` on a
        thread.  Eligibility depends only on group-congruent facts (the
        world's engine and mode, the kind, root and reduction geometry),
        so every rank takes the same path.  Verified worlds keep the
        thread: the per-call signature exchange is a blocking ring the
        state machine skips (persistent collectives hoist it to init)."""
        from . import nbc as _nbc

        with _on_default_stream(self.device):
            if (self._progress is not None and self._verify is None
                    and _nbc.mode() == "auto"):
                req = _nbc.try_state_machine(self, kind, *args, **kwargs)
                if req is not None:
                    return req
            c = self._nbc_comm()
            req = _ThreadRequest(lambda: fn(c), self.device)
            if self._verify is not None:
                self._track_request(req, kind, kwargs.get("root", -1),
                                    _TAG_COLL)
            return req

    def ibcast(self, obj: Any, root: int = 0) -> Request:
        return self._nbc_issue("ibcast", lambda c: c.bcast(obj, root),
                               obj, root=root)

    def ireduce(self, obj: Any, op: _ops.ReduceOp = _ops.SUM,
                root: int = 0) -> Request:
        return self._nbc_issue("ireduce", lambda c: c.reduce(obj, op, root),
                               obj, op=op, root=root)

    def iallreduce(self, obj: Any, op: _ops.ReduceOp = _ops.SUM,
                   algorithm: str = "auto",
                   compress_key: Any = None) -> Request:
        return self._nbc_issue(
            "iallreduce",
            lambda c: c.allreduce(obj, op, algorithm,
                                  compress_key=compress_key),
            obj, op=op, algorithm=algorithm, compress_key=compress_key)

    def iallgather(self, obj: Any) -> Request:
        return self._nbc_issue("iallgather", lambda c: c.allgather(obj), obj)

    def ialltoall(self, objs: Sequence[Any]) -> Request:
        return self._nbc_issue("ialltoall", lambda c: c.alltoall(objs), objs)

    def ibarrier(self) -> Request:
        return self._nbc_issue("ibarrier", lambda c: c.barrier())

    def iscatter(self, objs: Optional[Sequence[Any]], root: int = 0) -> Request:
        return self._nbc_issue("iscatter", lambda c: c.scatter(objs, root),
                               objs, root=root)

    def igather(self, obj: Any, root: int = 0) -> Request:
        return self._nbc_issue("igather", lambda c: c.gather(obj, root),
                               obj, root=root)

    # -- persistent collectives (MPI-4 MPI_Allreduce_init & co., nbc.py) -------

    def allreduce_init(self, obj: Any, op: _ops.ReduceOp = _ops.SUM,
                       algorithm: str = "auto", compress_key: Any = None):
        """MPI_Allreduce_init: a ``PersistentColl`` handle that hoists the
        child context, the algorithm resolution, the schedule and the
        working buffers out of the loop; ``start()`` re-reads ``obj`` (the
        buffer-reuse idiom: refill it in place between rounds)."""
        from . import nbc as _nbc

        return _nbc.persistent_init(self, "allreduce", obj, op, algorithm,
                                    compress_key)

    def bcast_init(self, obj: Any, root: int = 0, algorithm: str = "auto"):
        """MPI_Bcast_init: a planned binomial-tree broadcast."""
        from . import nbc as _nbc

        return _nbc.persistent_init(self, "bcast", obj, root, algorithm)

    def alltoall_init(self, objs: Sequence[Any], algorithm: str = "auto"):
        """MPI_Alltoall_init: a planned pairwise exchange."""
        from . import nbc as _nbc

        return _nbc.persistent_init(self, "alltoall", objs, algorithm)

    def reduce_scatter_init(self, blocks: Any, op: _ops.ReduceOp = _ops.SUM,
                            algorithm: str = "auto"):
        """MPI_Reduce_scatter_init: a planned block-ring reduce_scatter."""
        from . import nbc as _nbc

        return _nbc.persistent_init(self, "reduce_scatter", blocks, op,
                                    algorithm)

    # -- communicator management ------------------------------------------

    def _alloc_context(self):
        # deterministic across ranks: split/dup are collective, so every
        # rank allocates the same sequence; tree-path tuples never collide
        with self._lock:
            self._nchildren += 1
            return (self._ctx, self._nchildren)

    def split(self, color: Optional[int], key: int = 0) -> Optional["P2PCommunicator"]:
        infos = self.allgather((color, key), algorithm="ring")
        ctx = self._alloc_context()
        if color is None:
            return None
        members = sorted(
            (k, cr) for cr, (c, k) in enumerate(infos) if c == color)
        group = [self._group[cr] for _, cr in members]
        return self._inherit_errhandler(self._inherit_ft(self._inherit_verify(
            P2PCommunicator(self._t, group, ctx,
                            recv_timeout=self.recv_timeout), "split")))

    def dup(self) -> "P2PCommunicator":
        self.barrier()  # collectiveness check + sync, like MPI_Comm_dup
        ctx = self._alloc_context()
        return self._copy_attrs_to(self._inherit_ft(self._inherit_verify(
            P2PCommunicator(self._t, self._group, ctx,
                            recv_timeout=self.recv_timeout), "dup")))

    def _inherit_ft(self, new: "P2PCommunicator") -> "P2PCommunicator":
        """A split/dup child of a fault-tolerant communicator is fault
        tolerant too: the same detector world, FRESH revocation state."""
        if self._ft is not None:
            from . import ft as _ftm

            new._ft = _ftm.CommFT(self._ft.world, new._ctx)
        return new

    def _inherit_verify(self, new: "P2PCommunicator",
                        how: str) -> "P2PCommunicator":
        """A split/dup/create child of a verified communicator is verified
        too (same world board, fresh collective sequence) and joins the
        unfreed-communicator registry: ``free()`` checks it out, the
        finalize report lists the leftovers."""
        if self._verify is not None:
            from .verify.state import CommVerify, user_site

            cv = CommVerify(self._verify.world)
            cv.comm_key = self._verify.world.track_comm(new, how,
                                                        user_site())
            new._verify = cv
        return new

    def free(self) -> None:
        """Sub-communicators share the world transport: nothing to
        release, apart from the verifier's unfreed-comm checkout.  A comm
        flagged as OWNING its transport (a spawn or accept/connect bridge,
        a socket world of its own, ``spawn.py``) closes it, or every
        bridge would leak a listener and its reader threads."""
        if self._verify is not None and self._verify.comm_key is not None:
            self._verify.world.free_comm(self._verify.comm_key)
            self._verify.comm_key = None
        if getattr(self, "_owns_transport", False):
            self._owns_transport = False
            self.close_transport()

    def close_transport(self) -> List[Tuple[int, Any, int]]:
        """Finalize-time shutdown: stops the detector and the progress
        engine, returns any unexpected pending messages (the 'unreceived
        message' check)."""
        if self._ft is not None:
            self._ft.world.stop()
        if self._progress is not None:
            self._progress.stop()
        pending = self._t.mailbox.drain()
        self._t.close()
        return pending
