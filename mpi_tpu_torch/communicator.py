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

Not ported yet, each raising ``NotImplementedError`` where a program
reaches it: the shared-memory arena ``algorithm="sm"`` (ROADMAP 16.4),
the ``compressed*`` algorithms (16.3), nonblocking and persistent
collectives (16.2), fault tolerance and RMA windows on host backends.
"""

from __future__ import annotations

import pickle
import threading
from abc import ABC, abstractmethod
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bufpool as _bufpool
from . import mpit as _mpit
from . import ops as _ops
from . import recvpool as _recvpool
from . import schedules
from .transport import codec as _codec
from .transport.base import ANY_SOURCE, ANY_TAG, Transport, payload_nbytes

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

# The reference's algorithm names this slice accepts but does not run yet.
_COMPRESSED_ALLREDUCE = ("compressed", "compressed:bf16", "compressed:int8",
                         "compressed:topk")
_COMPRESSED_REDUCE_SCATTER = ("compressed", "compressed:bf16",
                              "compressed:int8")


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
                       aliases: dict, unported: Tuple[str, ...] = ()) -> str:
    """The ONE ``algorithm=`` gate of the host collectives: aliases are
    explicit, real names pass through, anything else raises the same
    error everywhere, listing every accepted value (the reference's list
    on these transports).  ``"sm"`` and the names in ``unported`` are
    refused with the ROADMAP item that ports them."""
    if algorithm == "sm":
        raise NotImplementedError(
            f"{coll} algorithm 'sm' (the shared-memory collective arena of "
            f"the shm transport) is not ported yet: ROADMAP.md item 16.4")
    if algorithm in unported:
        raise NotImplementedError(
            f"{coll} algorithm {algorithm!r} (compressed wire dtypes) is not "
            f"ported yet: ROADMAP.md item 16.3")
    if algorithm in aliases:
        return aliases[algorithm]
    if algorithm in real:
        return algorithm
    accepted = sorted(set(real) | set(aliases) | set(unported))
    raise ValueError(
        f"unknown {coll} algorithm {algorithm!r}; accepted: {accepted}")


def _unpost(reqs: Sequence["_RecvRequest"]) -> None:
    """Failure path of a collective that posted internal irecvs: remove
    the not-yet-completed ones from their posted queues (and their
    steering entries), so a stale queue head cannot absorb the first
    frames of a LATER collective on the same channel and misfold."""
    if not reqs:
        return
    reg = reqs[0]._comm._recv_reg
    for req in reqs:
        if reg is not None:
            reg.cancel(req._steer_token)
        if not req._done and req in req._queue:
            req._queue.remove(req)


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
    """Copy a received payload into a bound destination in place (a tensor
    or a list of tensors), telling the ownership layer first; a geometry
    mismatch leaves the buffer alone (the payload is still returned)."""
    bufs, gots = (buf, got) if isinstance(buf, list) else ([buf], [got])
    try:
        for b, g in zip(bufs, gots):
            _bufpool.touch(b)
            b.copy_(torch.as_tensor(g))
    except (TypeError, ValueError, RuntimeError):
        pass


class Request:
    """Handle for a nonblocking operation (MPI_Request): ``wait()`` blocks
    until completion and returns the payload (None for sends); ``test()``
    returns (done, payload-or-None) without blocking."""

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
        return self._value

    def test(self) -> Tuple[bool, Any]:
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
    earlier siblings from the shared posted queue."""

    # recv-steering registry token of an internal posted irecv
    _steer_token = None
    # irecv(buf=...) destination, filled at completion
    _user_buf = None

    def __init__(self, comm: "P2PCommunicator", source: int, tag: int,
                 queue: List["_RecvRequest"]):
        self._comm, self._source, self._tag = comm, source, tag
        self._queue = queue
        self._done = False
        self._value: Any = None
        queue.append(self)

    def _complete(self, payload: Any) -> None:
        if self._user_buf is not None:
            _refill(self._user_buf, payload)
        self._value, self._done = payload, True
        if self in self._queue:
            self._queue.remove(self)

    def _poll_once(self):
        src_world = (ANY_SOURCE if self._source == ANY_SOURCE
                     else self._comm._world(self._source))
        return self._comm._t.poll(src_world, self._comm._ctx, self._tag)

    def wait(self) -> Any:
        while not self._done:
            head = self._queue[0]  # earliest posted request gets the message
            # _recv_internal, not recv: internal (negative-tag) requests —
            # the engine's pipelined irecvs — must not trip the user-tag
            # check at completion time
            head._complete(self._comm._recv_internal(
                head._source, head._tag, _posted=True))
        return self._value

    def test(self) -> Tuple[bool, Any]:
        while not self._done:
            head = self._queue[0]
            hit = head._poll_once()
            if hit is None:
                return False, None
            head._complete(hit[0])
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
            self._inner = self._comm.irecv(self._peer, self._tag,
                                           buf=self._buf)
        return self

    def wait(self) -> Any:
        # a completed value stays readable until the next start()
        if self._inner is None:
            return self._last
        value = self._inner.wait()
        self._inner, self._last = None, value
        return value

    def test(self) -> Tuple[bool, Any]:
        if self._inner is None:
            return True, self._last
        done, value = self._inner.test()
        if done:
            self._inner, self._last = None, value
        return done, value


def startall(requests: Sequence[PersistentRequest]) -> List[PersistentRequest]:
    """MPI_Startall."""
    for r in requests:
        r.start()
    return list(requests)


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
        items = self.allgather(self._take_rows(obj, counts[self.rank]))
        return _concat_rows(items)

    def gatherv(self, obj: Any, counts: Sequence[int],
                root: int = 0) -> Optional[Any]:
        """MPI_Gatherv: like allgatherv, the result at root only."""
        self._check_counts(counts)
        items = self.gather(self._take_rows(obj, counts[self.rank]), root)
        if items is None:
            return None
        return _concat_rows(items)

    def scatterv(self, obj: Any, counts: Sequence[int], root: int = 0) -> Any:
        """MPI_Scatterv: root holds the ``[sum(counts), ...]``
        concatenation; rank r receives its ``counts[r]``-row slice."""
        self._check_counts(counts)
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
        sendlist = [self._take_rows(blocks[d], counts[self.rank][d])
                    for d in range(self.size)]
        return self.alltoall(sendlist)

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


def _unported(name: str, what: str, item: str):
    """A method of the reference's host communicator this slice does not
    port: it raises, naming the ROADMAP item that ports it."""
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name}: {what} on the host backends are not ported yet: "
            f"ROADMAP.md item {item}")
    method.__name__ = name
    return method


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
        self._coll_name: Optional[str] = None
        # recv-steering registry (socket only); None = one attribute test
        self._recv_reg = transport.recv_registry

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
        self._t.send(self._world(dest), self._ctx, tag, obj)

    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             status: Optional[Status] = None) -> Any:
        _check_user_tag(tag)
        return self._recv_internal(source, tag, status)

    def _recv_internal(self, source: int, tag: int,
                       status: Optional[Status] = None,
                       _posted: bool = False) -> Any:
        src_world = ANY_SOURCE if source == ANY_SOURCE else self._world(source)
        if (not _posted and tag < 0 and src_world != ANY_SOURCE
                and self._recv_reg is not None):
            # a BLOCKING recv on an internal channel consumes a frame on
            # the channel the posted irecvs pair on: count it so the
            # frame/consumer indices stay aligned (_posted marks the
            # queue-head servicing call of an already-counted irecv)
            self._recv_reg.note_consume(src_world, self._ctx, tag)
        obj, src, t = self._t.recv(src_world, self._ctx, tag,
                                   timeout=self.recv_timeout)
        _mpit.count(recvs=1)
        if status is not None:
            status._fill(self._from_world(src), t, obj)
        return obj

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
        return _CompletedRequest()

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
        return _ReplaceRequest(self.irecv(source, recvtag), buf)

    def irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              buf: Any = None) -> Request:
        """MPI_Irecv: ``test()`` polls, ``wait()`` blocks; requests on the
        same (source, tag) complete in posted order.  ``buf`` (a tensor or
        a list of tensors) is filled in place at completion."""
        _check_user_tag(tag)
        req = self._irecv_internal(source, tag)
        if buf is not None:
            req._user_buf = buf
        return req

    def _irecv_internal(self, source: int, tag: int) -> _RecvRequest:
        """irecv without the user-tag gate — the engine posts pipelined
        receives on the internal _TAG_COLL tag through here."""
        with self._lock:
            queue = self._irecv_queues.setdefault((source, tag), [])
        req = _RecvRequest(self, source, tag, queue)
        if tag < 0 and source != ANY_SOURCE and self._recv_reg is not None:
            # count the posted consumer on its steering channel; the
            # collective may attach a destination view to the token
            req._steer_token = self._recv_reg.note_post(
                self._world(source), self._ctx, tag)
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
        obj, src, t = self._t.recv(src_world, self._ctx, tag,
                                   timeout=self.recv_timeout)
        msg = Message(obj, self._from_world(src), t, comm=self)
        if status is not None:
            status._fill(msg.source, msg.tag, obj)
        return msg

    def improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                status: Optional[Status] = None) -> Optional[Message]:
        """MPI_Improbe: non-blocking mprobe — a Message, or None."""
        _check_user_tag(tag)
        src_world = ANY_SOURCE if source == ANY_SOURCE else self._world(source)
        hit = self._t.poll(src_world, self._ctx, tag)
        if hit is None:
            return None
        obj, src, t = hit
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
            return False
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

    def bcast(self, obj: Any, root: int = 0, algorithm: str = "auto") -> Any:
        """MPI_Bcast over the binomial tree (``"tree"``; ``"auto"`` and
        ``"fused"`` alias it).  Large tensors take the SEGMENTED pipelined
        tree: the root announces the geometry with a _SegHeader, then every
        rank forwards each segment to its children the moment it lands."""
        _mpit.count(collectives=1)
        self._coll_name = "bcast"
        _resolve_algorithm("bcast", algorithm, ("auto", "tree"),
                           {"fused": "tree"})
        self._world(root)  # validate
        if self.size == 1:
            return obj
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

    def reduce(self, obj: Any, op: _ops.ReduceOp = _ops.SUM, root: int = 0,
               algorithm: str = "auto") -> Any:
        """MPI_Reduce over the binomial tree with in-place folds
        (``"tree"``; ``"auto"`` and ``"fused"`` alias it)."""
        _mpit.count(collectives=1)
        self._coll_name = "reduce"
        _resolve_algorithm("reduce", algorithm, ("auto", "tree"),
                           {"fused": "tree"})
        self._world(root)  # validate
        acc = _as_tensor(obj, self.device).detach().clone()
        for pairs in schedules.binomial_reduce_rounds(self.size, root):
            for s, d in pairs:
                if self._rank == s:
                    self._send_internal(self._coll_payload(acc), d, _TAG_COLL)
                elif self._rank == d:
                    # in place; a send of acc only happens in a LATER round
                    op.combine_into(acc, self._recv_internal(s, _TAG_COLL))
        return acc if self._rank == root else None

    def allreduce(self, obj: Any, op: _ops.ReduceOp = _ops.SUM,
                  algorithm: str = "auto") -> Any:
        """MPI_Allreduce.  ``algorithm``: ``"ring"`` (reduce-scatter ring +
        allgather ring), ``"recursive_halving"`` (power-of-two groups),
        ``"rabenseifner"`` (block-ring reduce_scatter + ring allgather,
        any group size), ``"reduce_bcast"``, or ``"auto"`` (the reference's
        size rule, ``seed_allreduce_algorithm``); ``"fused"`` aliases
        ``"auto"``."""
        _mpit.count(collectives=1)
        self._coll_name = "allreduce"
        arr = _as_tensor(obj, self.device)
        algorithm = _resolve_algorithm(
            "allreduce", algorithm,
            ("auto", "ring", "recursive_halving", "rabenseifner",
             "reduce_bcast"), {"fused": "auto"}, _COMPRESSED_ALLREDUCE)
        if algorithm == "auto":
            algorithm = seed_allreduce_algorithm(arr.nbytes, self.size)
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
                      op: Optional[_ops.ReduceOp] = None) -> None:
        """One pipelined exchange step: send ``work[sbounds]`` to ``dest``
        while receiving the same-global-range ``rbounds`` from ``src``,
        folding (``op``) or copying (``op=None``) each segment into the
        working buffer as it lands.  Receives are posted up front (they
        complete in posted order, matching the sender's FIFO channel);
        sends run at most _SEG_WINDOW segments ahead of the receive
        pointer.  Both sides derive spans from the same global tables, so
        message boundaries agree with no metadata traffic."""
        seg = self._seg_elems(work.element_size())
        sspans = schedules.segment_spans(sbounds[0], sbounds[1], seg)
        rspans = schedules.segment_spans(rbounds[0], rbounds[1], seg)
        # Pure-copy spans may land DIRECTLY in the working buffer on a
        # steering transport: register each posted receive's destination
        # view.  Fold spans never are (an early arrival would clobber the
        # accumulator before the fold reads it).  A steered segment is
        # recognised by identity (the delivered payload IS the view).
        dests = None
        if op is None and self._recv_reg is not None:
            dests = [work[lo:hi] for lo, hi in rspans]
        reqs = []
        for i in range(len(rspans)):
            req = self._irecv_internal(src, _TAG_COLL)
            if dests is not None:
                self._recv_reg.attach(req._steer_token, dests[i])
            reqs.append(req)
        try:
            si = 0
            while si < min(len(sspans), _SEG_WINDOW):
                lo, hi = sspans[si]
                self._send_internal(self._coll_payload(work[lo:hi]), dest,
                                    _TAG_COLL)
                si += 1
            for seg_i, ((lo, hi), req) in enumerate(zip(rspans, reqs)):
                got = req.wait()
                view = work[lo:hi] if dests is None else dests[seg_i]
                if op is None:
                    if got is not view:  # else: steered in place
                        # the working buffer's spans were just SENT:
                        # retained frames must snapshot before this write
                        _bufpool.touch(view)
                        view.copy_(got)
                        self._count_recv_store(dests)
                else:
                    op.combine_into(view, got)
                if si < len(sspans):
                    slo, shi = sspans[si]
                    self._send_internal(self._coll_payload(work[slo:shi]),
                                        dest, _TAG_COLL)
                    si += 1
            while si < len(sspans):  # recv range empty/shorter: drain tail
                slo, shi = sspans[si]
                self._send_internal(self._coll_payload(work[slo:shi]), dest,
                                    _TAG_COLL)
                si += 1
        except BaseException:
            # a failed exchange must not leave stale queue heads on the
            # internal (src, _TAG_COLL) channel
            _unpost(reqs)
            raise

    def _allreduce_ring(self, arr: torch.Tensor, op: _ops.ReduceOp) -> torch.Tensor:
        # reduce-scatter ring + allgather ring, 2(P-1) steps, segmented
        # and in place on one flat working copy of the input
        p, r = self.size, self._rank
        work = _flat_copy(arr)
        offs = schedules.chunk_offsets(work.numel(), p)
        right, left = (r + 1) % p, (r - 1) % p
        for step in range(p - 1):
            si = schedules.ring_rs_send_chunk(r, step, p)
            ri = schedules.ring_rs_recv_chunk(r, step, p)
            self._seg_exchange(work, (offs[si], offs[si + 1]),
                               (offs[ri], offs[ri + 1]), right, left, op)
        for step in range(p - 1):
            si = schedules.ring_ag_send_chunk(r, step, p)
            ri = schedules.ring_ag_recv_chunk(r, step, p)
            self._seg_exchange(work, (offs[si], offs[si + 1]),
                               (offs[ri], offs[ri + 1]), right, left)
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

    def allgather(self, obj: Any, algorithm: str = "auto") -> Any:
        """MPI_Allgather.  ``algorithm``: ``"ring"`` (rotating row views of
        one ``[P, ...]`` buffer), ``"doubling"`` (recursive doubling,
        power-of-two groups), or ``"auto"`` — doubling on power-of-two
        groups, the ring otherwise (the pick depends only on the group
        shape); ``"fused"`` aliases ``"auto"``.  Equal-geometry tensors
        come back stacked ``[P, ...]``, anything else as a list."""
        _mpit.count(collectives=1)
        self._coll_name = "allgather"
        p, r = self.size, self._rank
        algorithm = _resolve_algorithm(
            "allgather", algorithm, ("auto", "ring", "doubling"),
            {"fused": "auto"})
        if algorithm == "auto":
            algorithm = "doubling" if schedules.is_pow2(p) else "ring"
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

    def alltoall(self, objs: Sequence[Any], algorithm: str = "auto") -> Any:
        """MPI_Alltoall by windowed nonblocking pairwise exchange
        (``"pairwise"``; ``"auto"`` and ``"fused"`` alias it): all P-1
        receives are posted up front and the sends run at most
        _SEG_WINDOW rounds ahead of the completed receives."""
        _mpit.count(collectives=1)
        self._coll_name = "alltoall"
        p, r = self.size, self._rank
        _resolve_algorithm("alltoall", algorithm, ("auto", "pairwise"),
                           {"fused": "pairwise"})
        if len(objs) != p:
            raise ValueError(f"alltoall needs one payload per rank ({p}), got {len(objs)}")
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

    def barrier(self, algorithm: str = "auto") -> None:
        """MPI_Barrier by dissemination, ceil(log2 P) message rounds
        (``"dissemination"``; ``"auto"`` and ``"fused"`` alias it)."""
        _mpit.count(collectives=1)
        self._coll_name = "barrier"
        _resolve_algorithm("barrier", algorithm, ("auto", "dissemination"),
                           {"fused": "dissemination"})
        p, r = self.size, self._rank
        for off in schedules.dissemination_offsets(p):
            self._send_internal(None, (r + off) % p, _TAG_BARRIER)
            self._recv_internal((r - off) % p, _TAG_BARRIER)

    def scan(self, obj: Any, op: _ops.ReduceOp = _ops.SUM,
             algorithm: str = "auto") -> Any:
        """MPI_Scan by Hillis-Steele distance doubling, log2(P) rounds
        (``"doubling"``; ``"auto"`` and ``"fused"`` alias it)."""
        _mpit.count(collectives=1)
        self._coll_name = "scan"
        arr = _as_tensor(obj, self.device)
        _resolve_algorithm("scan", algorithm, ("auto", "doubling"),
                           {"fused": "doubling"})
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

    def reduce_scatter(self, blocks: Any, op: _ops.ReduceOp = _ops.SUM,
                       algorithm: str = "auto") -> Any:
        """MPI_Reduce_scatter_block: ``blocks`` holds one block per rank;
        rank r gets the reduction of everyone's block r.  ``"ring"`` (P-1
        steps — segmented on one flat working buffer when the blocks are
        homogeneous and the payload large, per-chunk otherwise);
        ``"auto"`` and ``"fused"`` alias it."""
        _mpit.count(collectives=1)
        self._coll_name = "reduce_scatter"
        p, r = self.size, self._rank
        _resolve_algorithm("reduce_scatter", algorithm, ("auto", "ring"),
                           {"fused": "ring"}, _COMPRESSED_REDUCE_SCATTER)
        if len(blocks) != p:
            raise ValueError(
                f"reduce_scatter needs one block per rank ({p}), got {len(blocks)}")
        # size-gate BEFORE stacking: for list payloads eligibility stacks
        # the blocks, a copy the per-chunk path would throw away
        nbytes = self._blocks_nbytes(blocks)
        use_seg = (nbytes >= _RS_SEGMENT_MIN_BYTES
                   or 0 < _SEGMENT_BYTES < nbytes)
        arr = self._blocks_as_array(blocks) if use_seg and p > 1 else None
        if arr is not None:
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
                                   (ri * bn, (ri + 1) * bn), right, left, op)
            # own block copied out so the P·n working buffer is released
            return work[r * bn:(r + 1) * bn].view(arr.shape[1:]).clone()
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

    def scatter(self, objs: Optional[Sequence[Any]], root: int = 0) -> Any:
        """MPI_Scatter: rank d receives ``objs[d]`` from ``root``; the
        root's fan-out is nonblocking (every payload enqueued first)."""
        _mpit.count(collectives=1)
        self._coll_name = "scatter"
        self._world(root)  # validate
        if self._rank == root:
            if objs is None or len(objs) != self.size:
                raise ValueError(f"scatter root needs one payload per rank ({self.size})")
            for d in range(self.size):
                if d != root:
                    self._send_internal(objs[d], d, _TAG_COLL)
            return objs[root]
        return self._recv_internal(root, _TAG_COLL)

    def gather(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        """MPI_Gather: root returns ``[payload_0, ..., payload_{P-1}]``,
        every receive posted up front (nonblocking fan-in)."""
        _mpit.count(collectives=1)
        self._coll_name = "gather"
        self._world(root)  # validate
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

    ibcast = _unported("ibcast", "nonblocking collectives", "16.2")
    ireduce = _unported("ireduce", "nonblocking collectives", "16.2")
    iallreduce = _unported("iallreduce", "nonblocking collectives", "16.2")
    iallgather = _unported("iallgather", "nonblocking collectives", "16.2")
    ialltoall = _unported("ialltoall", "nonblocking collectives", "16.2")
    ibarrier = _unported("ibarrier", "nonblocking collectives", "16.2")
    iscatter = _unported("iscatter", "nonblocking collectives", "16.2")
    igather = _unported("igather", "nonblocking collectives", "16.2")
    win_create = _unported("win_create", "one-sided RMA (P2PWindow)", "16.4")

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
        return self._inherit_errhandler(P2PCommunicator(
            self._t, group, ctx, recv_timeout=self.recv_timeout))

    def dup(self) -> "P2PCommunicator":
        self.barrier()  # collectiveness check + sync, like MPI_Comm_dup
        ctx = self._alloc_context()
        return self._copy_attrs_to(P2PCommunicator(
            self._t, self._group, ctx, recv_timeout=self.recv_timeout))

    def close_transport(self) -> List[Tuple[int, Any, int]]:
        """Finalize-time shutdown: returns any unexpected pending messages
        (the 'unreceived message' check)."""
        pending = self._t.mailbox.drain()
        self._t.close()
        return pending
