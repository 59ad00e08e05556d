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
event (:474) and a steered frame a ``recvpool steer`` event.  Steering into user buffers (``irecv(buf=...)``) is not ported
yet: a user buffer is filled at completion by a copy.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional, Tuple

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


class _Entry:
    __slots__ = ("idx", "dest", "ds", "shape")

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.dest: Optional[torch.Tensor] = None
        self.ds: Optional[str] = None
        self.shape: Tuple[int, ...] = ()


class _Channel:
    __slots__ = ("posted", "arrived", "wm", "entries")

    def __init__(self) -> None:
        self.posted = 0    # consumers counted (posted irecvs + blocking recvs)
        self.arrived = 0   # fresh data frames counted (+ self-send deliveries)
        self.wm: Tuple[int, int] = (0, 0)   # (gen, seq) counting watermark
        self.entries: deque = deque()       # outstanding posted-irecv entries


class PostedRecvRegistry:
    """Pairs fresh inbound frames with posted internal irecvs by
    per-channel arrival/post order.  One per steering transport; every
    method is thread-safe and one short critical section."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ch: Dict[Tuple[Any, Any, int], _Channel] = {}

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
        """Count a BLOCKING internal recv (a consumer with nothing to
        steer into — keeps the channel indices aligned)."""
        with self._lock:
            self._chan(src, ctx, tag).posted += 1

    def attach(self, token, dest: torch.Tensor) -> None:
        """Give a posted irecv's entry a destination view the reader may
        steer into (contiguous views only: they are filled whole)."""
        if not dest.is_contiguous():
            return
        _key, e = token
        from .transport.codec import dtype_name

        with self._lock:
            e.dest = dest
            e.ds = dtype_name(dest.dtype)
            e.shape = tuple(dest.shape)

    def cancel(self, token) -> None:
        """Remove a posted irecv's entry (failure paths), so a frame that
        never came cannot leave a stale claimable entry."""
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

    # -- producer side (socket reader / self-send) --------------------------

    def note_frame(self, src, ctx, tag, seq: int, gen: int,
                   plan=None) -> Optional[torch.Tensor]:
        """Count one FRESH data frame (the caller checked
        ``LinkState.rx_fresh``); returns the posted destination to steer
        into when the paired consumer has one of matching geometry, else
        None (pool path).  A steerable frame that found no destination
        because it outran its post (or the post's attach) is counted in
        ``recv_pool_fold_fallbacks``."""
        fold_race = False
        try:
            with self._lock:
                ch = self._chan(src, ctx, tag)
                if (gen, seq) <= ch.wm:
                    return None   # replay re-presentation: already counted
                ch.wm = (gen, seq)
                ch.arrived += 1
                j = ch.arrived
                q = ch.entries
                while q and q[0].idx < j:
                    q.popleft()   # stale: their frames already passed
                steerable = (_STEERING and plan is not None
                             and plan[0] == "arr")
                if not q or q[0].idx != j:
                    fold_race = steerable and ch.posted < j
                    return None
                e = q.popleft()
                if (e.dest is None or not steerable or e.ds != plan[1]
                        or e.shape != tuple(plan[2])):
                    fold_race = steerable and e.dest is None
                    return None
                return e.dest
        finally:
            if fold_race:
                _mpit.count(recv_pool_fold_fallbacks=1)
                rec = _telemetry.REC
                if rec is not None:
                    rec.emit("recvpool", "fold_fallback",
                             attrs={"src": src, "tag": tag})

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

    def note_local(self, src, ctx, tag) -> None:
        """Count a self-send delivery (value-copy path, never steered) so
        loopback traffic on a counted channel keeps indices aligned."""
        with self._lock:
            ch = self._chan(src, ctx, tag)
            ch.arrived += 1
            j = ch.arrived
            q = ch.entries
            while q and q[0].idx <= j:
                q.popleft()
