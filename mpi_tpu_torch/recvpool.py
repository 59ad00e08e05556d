"""Receive-side pool and rendezvous steering — the port's own copy of
``mpi_tpu/recvpool.py``.

* :class:`RecvPool` recycles the host buffers socket frames are read into,
  in power-of-two size classes (floor ``min_bytes``), pinned when a CUDA
  card is present so the copy to the card runs at full rate.  A frame
  bound for the card is read into a pooled host buffer, copied to the
  card, and the buffer goes straight back (:meth:`RecvPool.give_back`).
  Priced by ``recv_pool_hits`` / ``recv_pool_misses``.  A frame delivered
  on the CPU is read straight into the tensor handed to the receiver (the
  reference's recycle-on-collect of such buffers is not ported).

* :class:`PostedRecvRegistry` is the rendezvous half.  Every INTERNAL
  receive (negative tag, specific source) is counted on its ``(source,
  context, tag)`` channel in program order: posted irecvs via
  :meth:`note_post` (which returns a token the collective can
  :meth:`attach` a destination view to), blocking receives via
  :meth:`note_consume`.  The socket reader counts fresh data frames on
  the same channel; since the link delivers frames in sequence and
  collectives consume a channel in program order, the Nth fresh frame
  belongs to the Nth counted consumer.  When that consumer has an
  attached destination of the frame's exact geometry, :meth:`note_frame`
  returns it and the reader lands the body there: straight into the
  view's memory on the CPU, through a pooled host buffer and one copy on
  the card.  The fold site then sees the very view it owns and skips its
  store (``recv_pool_rendezvous`` / ``recv_bytes_steered``).  A missed
  pairing only costs steering, never correctness.

The ``recv_steering`` cvar disables claiming only; channel accounting
stays on so toggling mid-run cannot desync the pairing.  With the
flight recorder on, a lost steering race is a ``recvpool fold_fallback``
event (:474) and a steered frame a ``recvpool steer`` event.

User buffers (``mpi_tpu/recvpool.py:251-606``): the first
``irecv(buf=...)`` or started ``recv_init`` handle with a specific source
and a user tag activates its channel (:meth:`note_post_user`), and from
then on the readers count that channel's fresh frames like an internal
channel's.  A paired user destination — a contiguous CPU tensor or
ndarray, or a card tensor — takes the frame's body: a host destination
is read into in place (its own bytes; a list of them by one vectored
read on socket), a card tensor through pinned host staging and one
host-to-device copy (:func:`steer_targets`, :func:`finish_steer`).  Every
claimed user destination carries an aliasing guard (:class:`_LiveSteer`):
the owner's pop is identity, any other consumer's pop a private copy, so
a mispairing costs a copy (``recv_user_fallbacks``), never correctness.
"""

from __future__ import annotations

import functools
import threading
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import mpit as _mpit
from . import telemetry as _telemetry


# Rendezvous claiming on/off (the ``recv_steering`` cvar reads/writes it).
_STEERING = 1


class RecvPool:
    """Size-classed pool of host receive buffers (see module docstring).
    ``empty(shape, dtype)`` returns a writable contiguous host tensor."""

    def __init__(self, min_bytes: int = 1 << 20,
                 max_total: int = 256 << 20, max_per_size: int = 3):
        self._min, self._max_total = min_bytes, max_total
        self._max_per_size = max_per_size
        self._free: dict = {}   # class nbytes (pow2) -> [uint8 tensors]
        self._lent: dict = {}   # data_ptr of a handed-out view -> backing
        self._total = 0
        self._lock = threading.Lock()

    @staticmethod
    def class_bytes(nbytes: int) -> int:
        """The pow2 size class a request of ``nbytes`` draws from."""
        return 1 << max(0, (int(nbytes) - 1).bit_length())

    def empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= int(s)
        nbytes = n * dtype.itemsize
        if nbytes < self._min:
            return torch.empty(shape, dtype=dtype)
        cls = self.class_bytes(nbytes)
        with self._lock:
            stack = self._free.get(cls)
            buf = stack.pop() if stack else None
            if buf is not None:
                self._total -= cls
        if buf is None:
            _mpit.count(recv_pool_misses=1)
            buf = torch.empty(cls, dtype=torch.uint8,
                              pin_memory=torch.cuda.is_available())
        else:
            _mpit.count(recv_pool_hits=1)
        view = buf[:nbytes].view(dtype).reshape(shape)
        with self._lock:
            self._lent[view.data_ptr()] = buf
        return view

    def give_back(self, view: torch.Tensor) -> None:
        """Return a handed-out buffer once its bytes were copied away (the
        caller guarantees nothing else references ``view``)."""
        with self._lock:
            buf = self._lent.pop(view.data_ptr(), None)
            if buf is None:
                return
            stack = self._free.setdefault(buf.numel(), [])
            if (len(stack) < self._max_per_size
                    and self._total + buf.numel() <= self._max_total):
                stack.append(buf)
                self._total += buf.numel()


RECV_POOL = RecvPool()


def is_dest(d) -> bool:
    """A steering-eligible destination: a contiguous, writable host or card
    tensor outside autograd, or a writable C-contiguous ndarray in native
    byte order (the reference's gate, ``mpi_tpu/recvpool.py:364``)."""
    if isinstance(d, torch.Tensor):
        return (d.layout == torch.strided and d.is_contiguous()
                and not d.requires_grad)
    return (isinstance(d, np.ndarray) and d.flags.writeable
            and d.flags.c_contiguous and d.dtype.isnative)


def _desc(d) -> Tuple[str, Tuple[int, ...]]:
    """(wire dtype name, shape) of a destination: the torch dtype name the
    raw meta carries (``transport/codec.py dtype_name``)."""
    if isinstance(d, torch.Tensor):
        return str(d.dtype)[len("torch."):], tuple(d.shape)
    return d.dtype.name, tuple(d.shape)


@functools.lru_cache(maxsize=None)
def _wire_name(ds: str) -> Optional[str]:
    """A plan's dtype as a wire name: the port's raw meta spells torch
    names (``"float64"``); a numpy dtype string (``"<f8"``, the
    reference's spelling) maps to the same name when native."""
    if isinstance(getattr(torch, ds, None), torch.dtype):
        return ds
    try:
        dt = np.dtype(ds)
    except TypeError:
        return None
    return dt.name if dt.isnative else None


def _copy_steered(obj):
    """Private snapshot of a steered user destination (single tensor or
    ndarray, or the multi-segment list) — ``mpi_tpu/recvpool.py:124``."""
    if isinstance(obj, list):
        return [_copy_steered(a) for a in obj]
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    return obj.copy()


class _Entry:
    __slots__ = ("idx", "dest", "ds", "shape", "segs", "user", "declined")

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.dest = None                    # tensor/ndarray, or a list
        self.ds: Optional[str] = None
        self.shape: Tuple[int, ...] = ()
        # multi-segment destination (list attach): per-segment (dtype
        # name, shape) in fill order, matched against a "segs" plan
        self.segs: Optional[Tuple] = None
        # a USER-buffer entry (irecv(buf=) / recv_init): its claimed
        # destination enters the aliasing guard
        self.user = False
        # the poster's destination was not eligible: a later dest-less
        # match is a decision, not a lost race (never counted)
        self.declined = False


class _Channel:
    __slots__ = ("posted", "arrived", "wm", "entries", "lag", "user")

    def __init__(self) -> None:
        self.posted = 0    # consumers counted (posted irecvs + blocking recvs)
        self.arrived = 0   # fresh data frames counted (+ self-send deliveries)
        self.wm: Tuple[int, int] = (0, 0)   # (gen, seq) counting watermark
        self.entries: deque = deque()       # outstanding posted-irecv entries
        # USER channels only (tag >= 0, activated by the first
        # irecv(buf=)): messages delivered before activation were never
        # counted, so the Nth counted arrival pairs with consumer N + lag;
        # a matched-probe steal shifts it back down.  Internal channels
        # keep lag 0.
        self.lag = 0
        self.user = False


class _LiveSteer:
    """Aliasing guard of ONE claimed user destination, from the reader's
    claim to its consumer's pop (``mpi_tpu/recvpool.py:251``): a
    mispaired pop — a wildcard receive, a matched probe, an out-of-order
    blocking receive — costs a copy, never correctness."""

    __slots__ = ("obj", "writing", "sanitized", "owner_done", "rescue")

    def __init__(self, obj) -> None:
        self.obj = obj
        self.writing = True      # reader body-read in progress
        self.sanitized = False   # a foreign consumer already took a copy
        self.owner_done = False  # owner completed WITHOUT the destination
        self.rescue = None       # owner-made snapshot for a later popper


class PostedRecvRegistry:
    """Pairs fresh inbound frames with posted irecvs by per-channel
    arrival/post order.  One per steering transport; every method is
    thread-safe and one short critical section.  The bare ints
    ``user_count`` / ``live_count`` are the lock-free gates readers and
    completion sites test first while user steering is unused."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ch: Dict[Tuple[Any, Any, int], _Channel] = {}
        self._user_keys: set = set()
        self.user_count = 0
        self._live: Dict[int, _LiveSteer] = {}
        self.live_count = 0

    def _chan(self, src, ctx, tag) -> _Channel:
        key = (src, ctx, tag)
        ch = self._ch.get(key)
        if ch is None:
            ch = self._ch[key] = _Channel()
        return ch

    # -- consumer side (communicator) ---------------------------------------

    def note_post(self, src, ctx, tag):
        """Count a posted internal irecv on its channel; returns a token
        for :meth:`attach` / :meth:`cancel`."""
        with self._lock:
            ch = self._chan(src, ctx, tag)
            ch.posted += 1
            e = _Entry(ch.posted)
            ch.entries.append(e)
            return ((src, ctx, tag), e)

    def note_consume(self, src, ctx, tag) -> None:
        """Count a BLOCKING recv on a counted channel (a consumer with
        nothing to steer into — keeps the channel indices aligned)."""
        with self._lock:
            self._chan(src, ctx, tag).posted += 1

    def note_post_user(self, src, ctx, tag, backlog: int = 0,
                       claimable: bool = True):
        """Count a posted USER irecv (``irecv(buf=...)`` / a started
        ``recv_init``) on its channel, activating the channel on first use
        (``mpi_tpu/recvpool.py:312``): from then on the readers count its
        fresh frames like an internal channel's.  ``backlog`` (messages
        already queued for the envelope, never counted) seeds the pairing
        lag.  ``claimable=False`` counts a bufferless user irecv on an
        active channel (alignment only; a later :meth:`attach` re-arms
        it)."""
        with self._lock:
            ch = self._chan(src, ctx, tag)
            if not ch.user:
                ch.user = True
                ch.lag = backlog
                self._user_keys.add((src, ctx, tag))
                self.user_count = len(self._user_keys)
            ch.posted += 1
            e = _Entry(ch.posted)
            e.user = True
            e.declined = not claimable
            ch.entries.append(e)
            return ((src, ctx, tag), e)

    def user_active(self, src, ctx, tag) -> bool:
        """Whether a user channel was activated (callers pre-gate on the
        bare ``user_count``)."""
        if not self.user_count:
            return False
        return (src, ctx, tag) in self._user_keys

    def note_steal(self, src, ctx, tag) -> None:
        """A matched probe (or a wildcard receive) REMOVED a message of
        this envelope from matching: later consumers each shift one
        message earlier, so the pairing lag drops by one."""
        if not self.user_count:
            return
        with self._lock:
            ch = self._ch.get((src, ctx, tag))
            if ch is not None and ch.user:
                ch.lag -= 1

    def attach(self, token, dest) -> None:
        """Give a posted irecv's entry a destination the reader may steer
        into: one tensor or ndarray (matched against single-array frames)
        or a LIST of them (matched per segment against multi-segment
        frames, the scatter-gather receive).  An ineligible destination
        (non-contiguous, read-only, in autograd) declines the entry."""
        _key, e = token
        dests = dest if isinstance(dest, list) else [dest]
        ok = bool(dests) and all(is_dest(d) for d in dests)
        with self._lock:
            if not ok:
                e.declined = True
                return
            e.dest = dest
            e.declined = False
            if isinstance(dest, list):
                e.segs = tuple(_desc(d) for d in dest)
            else:
                e.ds, e.shape = _desc(dest)

    def cancel(self, token) -> None:
        """Remove a posted irecv's entry (failure paths, a user
        completion's fallback), so no later frame can claim it."""
        if token is None:
            return
        key, e = token
        with self._lock:
            ch = self._ch.get(key)
            if ch is not None:
                try:
                    ch.entries.remove(e)
                except ValueError:
                    pass

    # -- producer side (socket reader / shm drain / self-send) --------------

    def note_frame(self, src, ctx, tag, seq: int, gen: int, plan=None):
        """Count one FRESH data frame (the caller checked
        ``LinkState.rx_fresh``); returns the posted destination to steer
        into when the paired consumer has one of the frame's exact
        geometry, else None (pool path).  A steerable frame that found no
        destination because it outran its post (or the post's attach) is
        counted in ``recv_pool_fold_fallbacks``."""
        fold_race = False
        try:
            with self._lock:
                ch = self._chan(src, ctx, tag)
                if (gen, seq) <= ch.wm:
                    return None   # replay re-presentation: already counted
                ch.wm = (gen, seq)
                ch.arrived += 1
                j = ch.arrived + ch.lag
                q = ch.entries
                while q and q[0].idx < j:
                    q.popleft()   # stale: their frames already passed
                steerable = (_STEERING and plan is not None
                             and plan[0] in ("arr", "segs"))
                if not q or q[0].idx != j:
                    # a lost race only when no consumer was counted yet;
                    # an entry-less match with posted >= j is a blocking
                    # receive, which never steers
                    fold_race = steerable and ch.posted < j
                    return None
                e = q.popleft()
                if e.dest is None or not steerable \
                        or not self._plan_fits(e, plan):
                    fold_race = (steerable and e.dest is None
                                 and not e.declined)
                    return None
                if e.user:
                    # the guard tracks the claimed user destination until
                    # its consumer pops it; an earlier lifecycle of the
                    # same buffer still open declines the claim
                    if id(e.dest) in self._live:
                        return None
                    self._live[id(e.dest)] = _LiveSteer(e.dest)
                    self.live_count = len(self._live)
                return e.dest
        finally:
            if fold_race:
                _mpit.count(recv_pool_fold_fallbacks=1)
                rec = _telemetry.REC
                if rec is not None:
                    rec.emit("recvpool", "fold_fallback",
                             attrs={"src": src, "tag": tag})

    @staticmethod
    def _plan_fits(e: _Entry, plan) -> bool:
        """Geometry-exact match of a steerable plan against an entry's
        destination (one view against "arr", a list against "segs")."""
        if plan[0] == "arr":
            return (e.segs is None and e.ds == _wire_name(plan[1])
                    and e.shape == tuple(plan[2]))
        if e.segs is None or len(e.segs) != len(plan[1]):
            return False
        return all(_wire_name(ds) == eds and tuple(shape) == eshape
                   for (ds, shape), (eds, eshape) in zip(plan[1], e.segs))

    def note_local(self, src, ctx, tag) -> None:
        """Count a self-send delivery (value-copy path, never steered) so
        loopback traffic on a counted channel keeps indices aligned."""
        with self._lock:
            ch = self._chan(src, ctx, tag)
            ch.arrived += 1
            j = ch.arrived + ch.lag
            q = ch.entries
            while q and q[0].idx <= j:
                q.popleft()

    # -- user-buffer aliasing guard (mpi_tpu/recvpool.py:497-606) -----------
    #
    # A user claim writes frame bytes into a buffer the application owns,
    # and the mailbox is a scan queue: a wildcard receive, a matched probe
    # or an out-of-order blocking receive can pop the steered destination
    # instead of its own request.  The reader brackets the body read with
    # steer_done / steer_abort, every user-facing completion runs its
    # payload through sanitize (identity for the owner, a private copy
    # for anyone else), and an armed owner that completes without its
    # destination first rescues the steered bytes (pre_overwrite).

    def steer_done(self, obj) -> None:
        """Reader: the claimed user destination's body read finished."""
        with self._cv:
            ls = self._live.get(id(obj))
            if ls is not None and ls.obj is obj:
                ls.writing = False
                self._cv.notify_all()

    def steer_abort(self, obj) -> None:
        """Reader: the body read died mid-steer (torn frame, dead peer);
        the destination never reaches the mailbox, so its guard goes and
        the owner's fallback refill overwrites the partial bytes."""
        with self._cv:
            ls = self._live.get(id(obj))
            if ls is not None and ls.obj is obj:
                del self._live[id(obj)]
                self.live_count = len(self._live)
            self._cv.notify_all()

    def sanitize(self, value, own=None):
        """The owning request (``own is value``) takes its destination and
        closes the lifecycle; any OTHER consumer of a live steered
        destination gets a private copy (or the owner's rescue snapshot).
        Payloads outside the guard pass through."""
        with self._cv:
            ls = self._live.get(id(value))
            if ls is None or ls.obj is not value:
                return value
            while ls.writing:
                self._cv.wait()
            if own is value:
                del self._live[id(value)]
                self.live_count = len(self._live)
                return value
            out = ls.rescue if ls.rescue is not None \
                else _copy_steered(value)
            ls.sanitized = True
            if ls.owner_done:
                del self._live[id(value)]
                self.live_count = len(self._live)
            return out

    def pre_overwrite(self, buf) -> None:
        """An armed owner is about to overwrite its buffer on the fallback
        path: if a claim landed bytes there that another consumer has yet
        to pop, snapshot them first (waiting out a reader mid-steer)."""
        if not self.live_count:
            return
        with self._cv:
            ls = self._live.get(id(buf))
            if ls is None or ls.obj is not buf:
                return
            while ls.writing:
                self._cv.wait()
            if ls.sanitized:
                del self._live[id(buf)]
            else:
                ls.rescue = _copy_steered(buf)
                ls.owner_done = True
            self.live_count = len(self._live)

    def purge_src(self, src, gen: int) -> None:
        """Membership removal of ``src``: its in-flight frames died with the
        purged stream, so arrivals resync to posts, entries are dropped and
        the watermark is fenced to the bumped generation."""
        with self._lock:
            for key, ch in self._ch.items():
                if key[0] == src:
                    ch.entries.clear()
                    ch.arrived = ch.posted
                    ch.wm = (gen, 0)


def steer_targets(dest):
    """Where a steered frame's body is read, in fill order: a host
    destination itself (its own bytes), or for a card tensor a pinned host
    staging buffer from :data:`RECV_POOL`.  Returns ``(hosts, staged)``,
    ``staged`` the (card tensor, staging) pairs :func:`finish_steer`
    copies over."""
    hosts, staged = [], []
    for d in (dest if isinstance(dest, list) else [dest]):
        if isinstance(d, torch.Tensor) and d.device.type != "cpu":
            h = RECV_POOL.empty(d.shape, d.dtype)
            staged.append((d, h))
            hosts.append(h)
        else:
            hosts.append(d)
    return hosts, staged


def finish_steer(staged, ok: bool) -> None:
    """After the body read: one host-to-device copy from each staging
    buffer into its card tensor (on the reading thread's current stream,
    the default one; blocking, so the buffer can go straight back), then
    the staging returns to the pool.  A failing copy raises."""
    try:
        if ok:
            for d, h in staged:
                d.copy_(h)
    finally:
        for _, h in staged:
            RECV_POOL.give_back(h)


def host_view(d) -> memoryview:
    """Flat byte view of one host destination (tensor or ndarray)."""
    if isinstance(d, torch.Tensor):
        from .bufpool import byte_view

        return byte_view(d)
    return memoryview(d).cast("B")
