"""Shared-memory collective arena (coll/sm) — the port's own copy of
``mpi_tpu/coll_sm.py``: ``gate`` (:108), ``arena_for`` (:116), the
``Arena`` (:193) with its in-arena meta negotiation and sliced flag
waits, and the entry points ``barrier``, ``bcast``, ``allreduce`` (flat
and block in place), ``allreduce_wire`` (compressed slot writes),
``reduce``, ``allgather``, ``alltoall``, ``scan`` and ``reduce_scatter``
(:490-854), and the serve layer's pooled lease arenas: a communicator
stamped with ``_coll_sm_pool_ctx`` resolves through ``_pooled_arena``
(:139), one epoch-stamped arena per worker set reused across leases,
and ``retire_pooled`` (:442) unlinks them at pool shutdown.

One POSIX shared-memory arena per shm communicator: P 64-byte flag lines
(a monotone sequence counter per rank, posted with release and awaited
with acquire semantics by ``shmflag_*`` in ``native/shmring.cpp``) and P
data slots (a length-prefixed meta pickle, then the payload bytes at a
64-byte-aligned offset).  Every payload-bearing entry writes its meta
first and the group negotiates inside the arena: when any rank's payload
cannot ride it (not a plain tensor, larger than a slot, a reduction of
mismatched geometry) every rank sees the same metas after the entry
barrier and falls back to the wire algorithms together, counted in
``coll_sm_fallbacks``.  Small reductions take the flat path (every rank
folds every slot in rank order), larger allreduces the block in-place
path (each rank folds its ``schedules.chunk_offsets`` chunk, publishes
it, then gathers the others).

Tensors and the arena: the arena is ``mmap``ped pageable host memory,
seen as a CPU uint8 tensor.  A payload on the card is copied into its
slot by a blocking copy, complete before the rank posts its flag line;
a result read from the arena into a card tensor is a blocking copy too,
complete before the exit barrier lets a peer overwrite the slot.  Folds
run on the result's device (``op.combine_into`` in the reference's
order), so results are bitwise across ranks and against the reference on
the CPU; the result lives on the payload's device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pickle
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import mpit as _mpit
from . import schedules
from . import telemetry as _telemetry
from . import tuning as _tuning
from .transport import codec as _codec
from .transport.base import ANY_SOURCE, RecvTimeout, TransportError

# Sentinel: the arena declined this payload (after keeping the group in
# lockstep); the caller runs the wire algorithm.
FALLBACK = object()

# Arena size per communicator (cvar coll_sm_arena_bytes; 0 = off)
_ARENA_BYTES = 8 << 20
# Flat-path gate of the reductions (cvar coll_sm_eager_bytes)
_EAGER_BYTES = 32 << 10

_LINE = 64          # flag line stride (cache-line separation)
_META_MAX = 256     # per-slot meta region: u32 length + meta pickle
_META_LEN = struct.Struct("<I")
_SLICE_S = 0.05     # fault-tolerance / teardown re-check cadence of waits
_OPEN_TIMEOUT = 60.0

_KIND_NONE = 0      # "my payload cannot ride the arena" (or no payload)
_KIND_DATA = 1
_KIND_WIRE = 2      # wire-encoded payload (allreduce_wire)

# name -> {"refs": int, "creator": bool}
_LIVE: Dict[str, Dict[str, Any]] = {}
_LIVE_LOCK = threading.Lock()


def gate(comm) -> Tuple[str, ...]:
    """The extra ``algorithm=`` names this communicator's transport earns:
    ``("sm",)`` on an arena-capable (shm) transport, ``()`` otherwise, so
    socket and local worlds reject ``"sm"`` with the gate's error."""
    return ("sm",) if getattr(comm._t, "supports_coll_sm", False) else ()


def arena_for(comm) -> Optional["Arena"]:
    """This communicator's arena, created collectively on first use; None
    when the arena cannot serve it (not shm, a one-rank group, a
    nonblocking-collective clone, or the cvar kill switch).  A
    communicator stamped with ``_coll_sm_pool_ctx`` (a serve lease's)
    resolves through the transport's pool instead: one epoch-stamped
    arena per worker set, reused across leases."""
    if _ARENA_BYTES <= 0 or comm.size < 2:
        return None
    if not getattr(comm._t, "supports_coll_sm", False):
        return None
    if getattr(comm, "_no_coll_sm", False):
        return None
    arena = comm.__dict__.get("_coll_sm_arena")
    if arena is None:
        pool_ctx = getattr(comm, "_coll_sm_pool_ctx", None)
        if pool_ctx is not None:
            arena = _pooled_arena(comm, pool_ctx)
        else:
            arena = Arena(comm)
        comm._coll_sm_arena = arena
    return arena


def _pooled_arena(comm, pool_ctx: Tuple) -> "Arena":
    """The arena of a serve lease communicator.  Lease communicators get a
    fresh context per job, so the per-communicator path would map and
    unlink a multi-MiB segment per lease; instead the arena is keyed
    ``(pool_ctx, worker set)`` in the transport's ``_coll_arenas``
    registry (which the transport's close tears down) and outlives the
    lease: the next lease over the same workers maps nothing.

    ``pool_ctx`` carries the pool's membership epoch as the server
    granted it with the lease (one value for the whole group).  An epoch
    bump after a worker death retires the old segment: the first
    same-group lease under the new epoch closes the stale arena, every
    handle unlinking (its creator may be the dead worker), and builds a
    fresh one the replacement can map.  Barrier sequences live in the
    mapped flag lines, so a rank that re-attaches stays in lockstep."""
    t = comm._t
    pool = t._coll_arenas = getattr(t, "_coll_arenas", {})
    key = (pool_ctx, comm._group)
    arena = pool.get(key)
    if arena is not None and not arena._closed:
        return arena
    for (ctx2, grp2) in list(pool):
        if (grp2 == comm._group and ctx2 != pool_ctx
                and isinstance(ctx2, tuple) and ctx2[:1] == pool_ctx[:1]):
            pool.pop((ctx2, grp2)).close(force_unlink=True)
    return Arena(comm, ctx=pool_ctx)


def _arena_name(session: str, ctx, group) -> str:
    """/dev/shm name of one communicator's arena: a digest of the context
    AND the member group (disjoint split children share a context but
    each needs its own arena), under the session prefix the launcher's
    crash cleanup globs."""
    from .transport.shm import shm_prefix

    digest = hashlib.sha1(repr((ctx, tuple(group))).encode()).hexdigest()[:16]
    return f"/{shm_prefix(session)}arena_{digest}"


class Arena:
    """One mapped collective arena: flag lines, data slots, and the sliced
    flag wait that turns a peer's death into ProcFailedError."""

    def __init__(self, comm, ctx=None):
        from .native import load_shmring

        t = comm._t
        self._lib = load_shmring()
        p = comm.size
        self._p = p
        self._rank = comm.rank
        slot = ((_ARENA_BYTES - _LINE * p) // p) // _LINE * _LINE
        if slot < _META_MAX + _LINE:
            raise TransportError(
                f"coll_sm_arena_bytes={_ARENA_BYTES} too small for {p} "
                f"ranks (slot would be {slot} bytes)")
        self.slot_bytes = slot
        self.capacity = slot - _META_MAX  # payload bytes per slot
        nbytes = _LINE * p + slot * p
        # ``ctx`` overrides the naming and registration context: a pooled
        # lease arena keeps one name across leases whose communicator
        # contexts differ per job, and every one of its handles unlinks
        # on close (its creator may be a dead worker)
        self._pooled = ctx is not None
        if ctx is None:
            ctx = comm._ctx
        self.name = _arena_name(t._session, ctx, comm._group)
        self._creator = comm.rank == 0
        with _LIVE_LOCK:
            ent = _LIVE.setdefault(self.name, {"refs": 0, "creator": False})
            if self._creator:
                if ent["creator"]:
                    raise RuntimeError(
                        f"concurrent creation of arena {self.name!r} "
                        f"(two communicators resolved the same context?)")
                ent["creator"] = True
            ent["refs"] += 1
        name_b = self.name.encode()
        # the creator publishes a readiness file in the rendezvous dir
        # AFTER creating the segment; openers wait for that file, so none
        # maps a stale same-named segment of a crashed earlier run
        rdv = getattr(t, "_rdv", None)
        flag = (None if rdv is None else
                os.path.join(rdv, "arena." + self.name.rsplit("_", 1)[-1]))
        timeout = getattr(t, "_connect_timeout", _OPEN_TIMEOUT)
        self._flag_file = flag if comm.rank == 0 else None
        if self._creator:
            self._ptr = self._lib.shmarena_create(name_b, nbytes)
            if self._ptr and flag is not None:
                try:
                    tmp = flag + f".tmp.{os.getpid()}"
                    with open(tmp, "w") as f:
                        f.write("ready")
                    os.replace(tmp, flag)
                except OSError:
                    pass  # rdv dir tearing down: openers wait on the magic
        else:
            if flag is not None:
                deadline = time.monotonic() + timeout
                while not os.path.exists(flag):
                    if time.monotonic() > deadline:
                        break  # open-by-magic is still bounded
                    time.sleep(0.002)
            self._ptr = self._lib.shmarena_open(name_b, timeout)
        if not self._ptr:
            with _LIVE_LOCK:
                ent = _LIVE.get(self.name)
                if ent:
                    ent["refs"] -= 1
                    if self._creator:
                        ent["creator"] = False
                    if ent["refs"] <= 0:
                        _LIVE.pop(self.name, None)
            raise TransportError(
                f"rank {comm.rank}: arena "
                f"{'create' if self._creator else 'open'}({self.name!r}) "
                f"failed")
        self._base = int(self._lib.shmarena_addr(self._ptr))
        cbuf = (ctypes.c_ubyte * nbytes).from_address(self._base)
        self._cbuf = cbuf  # keeps the mapping's Python view alive
        self._mem: Optional[torch.Tensor] = torch.frombuffer(
            cbuf, dtype=torch.uint8)
        self._slots_off = _LINE * p
        # the barrier sequence resumes from this rank's own flag line (a
        # fresh segment reads 0)
        self.seq = int(self._lib.shmflag_read(self._flag_addr(self._rank)))
        self._closed = False
        self._active = 0  # collectives currently touching the mapping
        t._coll_arenas = getattr(t, "_coll_arenas", {})
        t._coll_arenas[(ctx, comm._group)] = self

    # -- slots -------------------------------------------------------------

    def _slot(self, rank: int) -> torch.Tensor:
        off = self._slots_off + rank * self.slot_bytes
        return self._mem[off:off + self.slot_bytes]

    def _put_meta(self, rank: int, meta: bytes) -> None:
        off = self._slots_off + rank * self.slot_bytes
        blob = _META_LEN.pack(len(meta)) + meta
        ctypes.memmove(self._base + off, blob, len(blob))

    def write_meta(self, kind: int, arr: Optional[torch.Tensor]) -> int:
        """Write this rank's meta word (and the payload bytes when ``kind``
        is data); returns the kind actually written (a meta pickle that
        overflows its region degrades to _KIND_NONE)."""
        desc = (None if arr is None
                else (_codec.dtype_name(arr.dtype), tuple(arr.shape)))
        meta = pickle.dumps((kind, desc), protocol=pickle.HIGHEST_PROTOCOL)
        if len(meta) > _META_MAX - _META_LEN.size:  # absurd ndim: decline
            kind, meta = _KIND_NONE, pickle.dumps(
                (_KIND_NONE, None), protocol=pickle.HIGHEST_PROTOCOL)
        self._put_meta(self._rank, meta)
        if kind == _KIND_DATA and arr is not None and arr.numel():
            # blocking copy: on the card it completes before this rank
            # posts its flag line
            self.data(self._rank, arr.dtype, arr.numel()).copy_(
                arr.reshape(-1))
        return kind

    def read_meta(self, rank: int):
        off = self._slots_off + rank * self.slot_bytes
        (mlen,) = _META_LEN.unpack(ctypes.string_at(self._base + off,
                                                    _META_LEN.size))
        return pickle.loads(ctypes.string_at(
            self._base + off + _META_LEN.size, mlen))

    def data(self, rank: int, dtype: torch.dtype, nelems: int) -> torch.Tensor:
        """Rank ``rank``'s payload as a flat IN-PLACE view of the arena —
        valid only between the entry barrier and the exit barrier; never
        returned to the caller (results are private copies)."""
        itemsize = torch.empty(0, dtype=dtype).element_size()
        slot = self._slot(rank)
        return slot[_META_MAX:_META_MAX + nelems * itemsize].view(dtype)

    # -- synchronization ---------------------------------------------------

    def _flag_addr(self, rank: int) -> int:
        return self._base + rank * _LINE

    def barrier(self, comm) -> None:
        """One flag round: post my next sequence value, wait until every
        peer posted it too."""
        self.seq += 1
        target = self.seq & 0xFFFFFFFF
        self._lib.shmflag_post(self._flag_addr(self._rank), target)
        for q in range(self._p):
            if q != self._rank:
                self._wait_flag(comm, q, target)

    def _wait_flag(self, comm, peer: int, target: int) -> None:
        """Sliced flag wait: between ~50 ms native waits a revocation
        raises RevokedError and a detector hit ProcFailedError; without
        fault tolerance the wait is bounded by the communicator's
        recv_timeout (RecvTimeout) or the shm stall constant."""
        from .transport import shm as _shm

        addr = self._flag_addr(peer)
        timeout = comm.recv_timeout
        bound = _shm._WRITE_TIMEOUT if timeout is None else timeout
        deadline = time.monotonic() + bound
        while True:
            cur = self._lib.shmflag_wait_ge(addr, target, _SLICE_S)
            if ((cur - target) & 0xFFFFFFFF) < 0x80000000:  # wrap-safe >=
                return
            if self._closed:
                raise TransportError(
                    f"rank {self._rank}: arena closed while waiting for "
                    f"rank {peer} in {comm._coll_name!r}")
            comm._empty_poll_check(ANY_SOURCE, -2)
            if time.monotonic() > deadline:
                what = (f"arena wait on rank {peer} in collective "
                        f"{comm._coll_name!r}")
                if timeout is not None:
                    raise RecvTimeout(f"{what} timed out after {timeout}s")
                raise TransportError(
                    f"rank {self._rank}: {what} made no progress for "
                    f"{bound}s — is the peer alive?")

    # -- lifecycle ---------------------------------------------------------

    def _begin(self) -> None:
        if self._closed:
            raise TransportError(
                f"rank {self._rank}: collective arena {self.name!r} is "
                f"closed")
        self._active += 1

    def _end(self) -> None:
        self._active -= 1

    def close(self, force_unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        if self._active == 0:
            # quiescent: release the mapping now; a close racing an
            # in-flight collective leaks it until process exit instead
            self._mem = None
            self._cbuf = None
            self._lib.shmarena_close(self._ptr)
            self._ptr = None
        with _LIVE_LOCK:
            ent = _LIVE.get(self.name)
            if ent:
                ent["refs"] -= 1
                if ent["refs"] <= 0:
                    _LIVE.pop(self.name, None)
        # ``force_unlink``: a pooled arena retired by an epoch bump may
        # have lost its creator with the dead worker, so every survivor
        # unlinks (unlinking a name already gone is a harmless ENOENT)
        if self._creator or force_unlink:
            self._lib.shmarena_unlink(self.name.encode())
            if self._flag_file is not None:
                try:
                    os.unlink(self._flag_file)
                except OSError:
                    pass


def live_arenas() -> Dict[str, int]:
    """name -> live handle count."""
    with _LIVE_LOCK:
        return {k: v["refs"] for k, v in _LIVE.items()}


def retire_pooled(transport) -> int:
    """Close every pooled lease arena of ``transport``, each handle
    unlinking: a pooled arena whose worker set never leases again is
    retired by nothing else (the epoch sweep of :func:`_pooled_arena`
    runs only when a new same-group lease arrives).  A serve worker calls
    this when its job loop ends at pool shutdown.  Returns the number of
    arenas retired."""
    pool = getattr(transport, "_coll_arenas", None) or {}
    retired = 0
    for key, arena in list(pool.items()):
        if getattr(arena, "_pooled", False):
            pool.pop(key, None)
            arena.close(force_unlink=True)
            retired += 1
    return retired


# -- the collectives ---------------------------------------------------------
#
# Every entry point returns FALLBACK (after keeping the group's flag
# sequence in lockstep) when the arena cannot serve the call, the result
# otherwise.  Each payload pass counts one payload_copies tick per rank:
# the copy in at write_meta time and the copy out (or fold) pass.


def _sm_coll(fn):
    """Entry-point wrapper: resolve the arena (FALLBACK and a counted
    decline where the transport has an arena tier but this communicator
    none) and hold the active-use guard across every arena touch."""
    @functools.wraps(fn)
    def run(comm, *args):
        arena = arena_for(comm)
        if arena is None:
            if getattr(comm._t, "supports_coll_sm", False):
                _mpit.count(coll_sm_fallbacks=1)
            return FALLBACK
        arena._begin()
        try:
            out = fn(arena, comm, *args)
        finally:
            arena._end()
        rec = _telemetry.REC
        if rec is not None:
            if out is not FALLBACK:
                rec.note_algorithm("sm")
            rec.emit("arena",
                     "hit" if out is not FALLBACK else "fallback",
                     attrs={"coll": fn.__name__})
        return out
    return run


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _eligible(arena: Arena, payload: Any) -> Optional[torch.Tensor]:
    """The contiguous tensor to place in this rank's slot, or None — the
    local half of the in-arena negotiation."""
    arr = _codec.as_raw_array(payload)
    if arr is None or _nbytes(arr) > arena.capacity:
        return None
    return arr


def _enter(arena: Arena, comm, payload: Any) -> Optional[torch.Tensor]:
    """Write this rank's meta (and data when eligible) and cross the entry
    barrier; returns the placed tensor or None."""
    mine = _eligible(arena, payload)
    kind = arena.write_meta(
        _KIND_DATA if mine is not None else _KIND_NONE, mine)
    if kind != _KIND_DATA:
        mine = None
    if mine is not None:
        _mpit.count(copies=1, coll_sm_bytes=_nbytes(mine))
    arena.barrier(comm)
    return mine


def _metas(arena: Arena) -> List[Tuple[int, Any]]:
    return [arena.read_meta(q) for q in range(arena._p)]


def _decline(arena: Arena, comm) -> Any:
    """Uniform fallback exit: one more barrier keeps every rank's flag
    sequence in lockstep, then the caller runs the wire algorithm."""
    arena.barrier(comm)
    _mpit.count(coll_sm_fallbacks=1)
    return FALLBACK


def _congruent(metas: List[Tuple[int, Any]]) -> bool:
    """True iff every rank placed data of identical (dtype, shape)."""
    kind0, desc0 = metas[0]
    return kind0 == _KIND_DATA and all(
        kind == _KIND_DATA and desc == desc0 for kind, desc in metas)


def _empty(shape, dtype_name: str, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=_codec.dtype_of(dtype_name),
                       device=device)


@_sm_coll
def barrier(arena: Arena, comm) -> Any:
    arena.barrier(comm)
    _mpit.count(coll_sm_hits=1)
    return None


@_sm_coll
def bcast(arena: Arena, comm, obj: Any, root: int) -> Any:
    me = comm.rank == root
    _enter(arena, comm, obj if me else None)
    kind, desc = arena.read_meta(root)
    if kind != _KIND_DATA:
        return _decline(arena, comm)
    if me:
        arena.barrier(comm)
        _mpit.count(coll_sm_hits=1)
        return obj
    dtype_name, shape = desc
    out = _empty(shape, dtype_name, comm.device)
    if out.numel():
        out.view(-1).copy_(arena.data(root, out.dtype, out.numel()))
    arena.barrier(comm)  # the root's slot is free for the next collective
    _mpit.count(copies=1, coll_sm_hits=1, coll_sm_bytes=_nbytes(out))
    return out


@_sm_coll
def allreduce(arena: Arena, comm, arr: torch.Tensor, op) -> Any:
    mine = _enter(arena, comm, arr)
    if not _congruent(_metas(arena)):
        return _decline(arena, comm)
    p, r = arena._p, comm.rank
    out = torch.empty(mine.shape, dtype=mine.dtype, device=mine.device)
    flat = out.view(-1)
    n = flat.numel()
    # flat vs chunked is a tuned decision ("sm_allreduce" rows); payloads
    # are congruent, so every rank picks the same side
    eager = _nbytes(mine) <= _EAGER_BYTES
    pick = _tuning.pick(comm, "sm_allreduce", _nbytes(mine),
                        ("flat", "chunked"))
    if pick is not None:
        eager = pick == "flat"
    if eager:
        # flat: every rank folds every slot in rank order (bitwise equal
        # results on every rank)
        if n:
            flat.copy_(arena.data(0, mine.dtype, n))
            for q in range(1, p):
                op.combine_into(flat, arena.data(q, mine.dtype, n))
        arena.barrier(comm)
        _mpit.count(copies=1, coll_sm_hits=1)
        return out
    # block in place: fold my chunk reading peers' blocks from the arena,
    # publish it in my own slot, then gather every reduced chunk
    offs = schedules.chunk_offsets(n, p)
    lo, hi = offs[r], offs[r + 1]
    if hi > lo:
        flat[lo:hi].copy_(arena.data(0, mine.dtype, n)[lo:hi])
        for q in range(1, p):
            op.combine_into(flat[lo:hi], arena.data(q, mine.dtype, n)[lo:hi])
        arena.data(r, mine.dtype, n)[lo:hi].copy_(flat[lo:hi])
    arena.barrier(comm)  # every reduced chunk published
    for q in range(p):
        if q != r and offs[q + 1] > offs[q]:
            flat[offs[q]:offs[q + 1]].copy_(
                arena.data(q, mine.dtype, n)[offs[q]:offs[q + 1]])
    arena.barrier(comm)  # slots free for the next collective
    _mpit.count(copies=1, coll_sm_hits=1)
    return out


# -- compressed eager path ---------------------------------------------------
#
# algorithm="compressed" on an shm world routes here first: each rank
# writes its payload ENCODED (segments 8-byte aligned after the meta
# region) and every rank decodes all P slots and folds in the fold dtype.
# The meta carries (wire name, payload dtype, shape, segment descs), so a
# group mixing encodings declines together.  Eager sizes only.

_WIRE_ALIGN = 8


def _wire_slot_layout(seg_descs) -> List[int]:
    """Byte offsets (within the slot, after the meta region) of each
    encoded segment — one rule for writer and readers."""
    offs, off = [], _META_MAX
    for dtype_name, shape in seg_descs:
        off = (off + _WIRE_ALIGN - 1) & ~(_WIRE_ALIGN - 1)
        offs.append(off)
        n = 1
        for s in shape:
            n *= int(s)
        off += n * _codec.dtype_of(dtype_name).itemsize
    offs.append(off)  # total extent (capacity check)
    return offs


def _read_wire_segs(arena: Arena, rank: int, seg_descs) -> List[torch.Tensor]:
    """Rank ``rank``'s encoded segments as in-place views of its slot."""
    slot = arena._slot(rank)
    offs = _wire_slot_layout(seg_descs)
    out = []
    for (dtype_name, shape), off in zip(seg_descs, offs):
        dt = _codec.dtype_of(dtype_name)
        n = 1
        for s in shape:
            n *= int(s)
        out.append(slot[off:off + n * dt.itemsize].view(dt).view(shape))
    return out


@_sm_coll
def allreduce_wire(arena: Arena, comm, arr: torch.Tensor, op, wire) -> Any:
    """Compressed eager allreduce: write own ENCODED payload, barrier,
    decode every slot and fold in the fold dtype (rank order), barrier.
    Returns the result in the payload's dtype on its device, or FALLBACK
    (group-coherent) when the encoded payload cannot ride."""
    from . import compress as _compress

    fdt = _compress.fold_dtype(arr.dtype)
    flat = arr.detach().reshape(-1).to(fdt)
    itemsize = torch.empty(0, dtype=fdt).element_size()
    est = wire.wire_nbytes(flat.numel(), itemsize) + _META_MAX \
        + _WIRE_ALIGN * 4
    desc = None
    if est <= min(arena.capacity, _EAGER_BYTES):
        enc = wire.encode(flat)
        seg_descs = [(_codec.dtype_name(s.dtype), tuple(s.shape))
                     for s in enc.segs]
        offs = _wire_slot_layout(seg_descs)
        desc = (wire.name, _codec.dtype_name(arr.dtype), tuple(arr.shape),
                seg_descs)
        meta = pickle.dumps((_KIND_WIRE, desc),
                            protocol=pickle.HIGHEST_PROTOCOL)
        if (len(meta) > _META_MAX - _META_LEN.size
                or offs[-1] > arena.slot_bytes):
            desc = None
    if desc is None:
        arena.write_meta(_KIND_NONE, None)
    else:
        arena._put_meta(comm.rank, meta)
        slot = arena._slot(comm.rank)
        for s, off in zip(enc.segs, offs):
            nb = _nbytes(s)
            if nb:
                slot[off:off + nb].view(s.dtype).copy_(s.reshape(-1))
        _mpit.count(copies=1,
                    coll_sm_bytes=sum(_nbytes(s) for s in enc.segs))
    arena.barrier(comm)
    metas = _metas(arena)
    kind0, desc0 = metas[0]
    if not (kind0 == _KIND_WIRE and all(
            kind == _KIND_WIRE and d == desc0 for kind, d in metas)):
        return _decline(arena, comm)
    seg_descs = desc0[3]

    def decode(segs):
        return wire.decode_segs([s.to(arr.device) for s in segs])

    # private fold buffer (slot views die at the exit barrier)
    out = decode(_read_wire_segs(arena, 0, seg_descs)).to(fdt).clone()
    for q in range(1, arena._p):
        op.combine_into(out, _read_wire_segs(arena, q, seg_descs), decode)
    arena.barrier(comm)  # slots free for the next collective
    _mpit.count(copies=1, coll_sm_hits=1)
    return out.to(arr.dtype).reshape(arr.shape)


@_sm_coll
def reduce(arena: Arena, comm, arr: torch.Tensor, op, root: int) -> Any:
    # above eager the binomial tree's distributed folds beat a flat P*N
    # fold at the root (a tuned decision: "sm_reduce" rows)
    use_arena = _nbytes(arr) <= _EAGER_BYTES
    pick = _tuning.pick(comm, "sm_reduce", _nbytes(arr), ("arena", "tree"))
    if pick is not None:
        use_arena = pick == "arena"
    if not use_arena:
        arena.write_meta(_KIND_NONE, None)
        arena.barrier(comm)
        mine = None
    else:
        mine = _enter(arena, comm, arr)
    if not _congruent(_metas(arena)):
        return _decline(arena, comm)
    out = None
    if comm.rank == root:
        out = torch.empty(mine.shape, dtype=mine.dtype, device=mine.device)
        flat = out.view(-1)
        if flat.numel():
            flat.copy_(arena.data(0, mine.dtype, flat.numel()))
            for q in range(1, arena._p):
                op.combine_into(flat, arena.data(q, mine.dtype, flat.numel()))
        _mpit.count(copies=1)
    arena.barrier(comm)
    _mpit.count(coll_sm_hits=1)
    return (out,)


@_sm_coll
def allgather(arena: Arena, comm, obj: Any) -> Any:
    _enter(arena, comm, obj)
    metas = _metas(arena)
    if any(kind != _KIND_DATA for kind, _ in metas):
        return _decline(arena, comm)
    items: List[Any] = [None] * arena._p
    for q, (_, (dtype_name, shape)) in enumerate(metas):
        if q == comm.rank:
            items[q] = obj
            continue
        dst = _empty(shape, dtype_name, obj.device)
        if dst.numel():
            dst.view(-1).copy_(arena.data(q, dst.dtype, dst.numel()))
        items[q] = dst
    arena.barrier(comm)
    _mpit.count(copies=1, coll_sm_hits=1)
    return (items,)


@_sm_coll
def alltoall(arena: Arena, comm, arr: Optional[torch.Tensor]) -> Any:
    """``arr`` is the stacked ``[P, ...]`` block tensor (None when the
    local payload cannot ride): write all blocks into own slot, one flag
    round, read your COLUMN (peer q's block ``rank``) in place."""
    mine = _enter(arena, comm, arr)
    if not _congruent(_metas(arena)):
        return _decline(arena, comm)
    p, r = arena._p, comm.rank
    if mine.shape[0] != p:
        return _decline(arena, comm)  # [P, ...] stacks only
    n = mine.numel()
    bn = n // p
    items: List[torch.Tensor] = []
    for q in range(p):
        dst = torch.empty(mine.shape[1:], dtype=mine.dtype,
                          device=mine.device)
        if bn:
            lo = r * bn
            dst.view(-1).copy_(arena.data(q, mine.dtype, n)[lo:lo + bn])
        items.append(dst)
    arena.barrier(comm)
    _mpit.count(copies=1, coll_sm_hits=1)
    return (items,)


@_sm_coll
def scan(arena: Arena, comm, arr: torch.Tensor, op) -> Any:
    """Inclusive prefix: write own payload, one flag round, rank r folds
    slots 0..r in rank order in place from the arena."""
    mine = _enter(arena, comm, arr)
    if not _congruent(_metas(arena)):
        return _decline(arena, comm)
    out = torch.empty(mine.shape, dtype=mine.dtype, device=mine.device)
    flat = out.view(-1)
    if flat.numel():
        flat.copy_(arena.data(0, mine.dtype, flat.numel()))
        for q in range(1, comm.rank + 1):
            op.combine_into(flat, arena.data(q, mine.dtype, flat.numel()))
    arena.barrier(comm)
    _mpit.count(copies=1, coll_sm_hits=1)
    return (out,)


@_sm_coll
def reduce_scatter(arena: Arena, comm, arr: Optional[torch.Tensor],
                   op) -> Any:
    """``arr`` is the stacked ``[P, ...]`` block tensor: write the whole
    input, one barrier, fold only block ``rank`` reading peers' blocks in
    place."""
    mine = _enter(arena, comm, arr)
    if not _congruent(_metas(arena)):
        return _decline(arena, comm)
    p, r = arena._p, comm.rank
    n = mine.numel()
    bn = n // p
    out = torch.empty(mine.shape[1:], dtype=mine.dtype, device=mine.device)
    flat = out.view(-1)
    if bn:
        lo = r * bn
        flat.copy_(arena.data(0, mine.dtype, n)[lo:lo + bn])
        for q in range(1, p):
            op.combine_into(flat, arena.data(q, mine.dtype, n)[lo:lo + bn])
    arena.barrier(comm)
    _mpit.count(copies=1, coll_sm_hits=1)
    return (out,)
