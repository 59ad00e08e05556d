"""Refcounted buffer ownership at the codec seam — the port's own copy of
``mpi_tpu/bufpool.py``: ``BufRef``, ``_addr_range`` (:89), ``touch``
(:280) and ``note_write`` (:296).

The resilient socket link (``resilience.py``) retains every unacked frame
body for replay after a connection reset.  A frame body is a list of
byte views: the meta ``bytes`` plus the payload's bytes.  A CUDA payload
is staged into a host copy the frame owns outright (immutable, nothing to
protect); a CPU tensor ships straight from its own memory, retained BY
REFERENCE.  Every in-place write the library makes into a tensor first
calls :func:`touch`, which snapshots any retained frame whose bytes
overlap the region, so a replay stays bit-exact.  A caller that mutates a
just-sent CPU tensor outside any library call must call
:func:`note_write` first.

Ranges are keyed by device and by the address of the storage's first
byte plus the tensor's byte offset (``untyped_storage().data_ptr()``),
the counterpart of the reference's numpy array-interface address.

Pinning: a snapshot must never race a thread streaming the same views
onto a socket; ``pin()`` marks them in use and :func:`touch` waits for
the pins to drain.  ``release()`` (ack prune, close) frees the views once
the last pin drops.
"""

from __future__ import annotations

import bisect
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from . import mpit as _mpit

# One process-wide condition guards every ref's pins/parts AND the
# live-range index.  ``_NLIVE`` is the lock-free fast-path gate: the count
# of range-bearing live refs, so a fold costs one int compare when nothing
# is retained.  The index is a sorted-interval structure: ``_starts``
# holds every registered range's (device, start) in sorted order with
# ``_ivals`` the parallel records, and ``_maxlen`` bounds the longest
# interval so a point query scans only starts in [qstart - _maxlen, qend).
_cv = threading.Condition()
_live: dict = {}   # id(ref) -> ref, refs that still hold mutable ranges
_NLIVE = 0
_starts: List[Tuple[str, int]] = []             # sorted (device, start)
_ivals: List[Tuple[Tuple[str, int], int, "BufRef"]] = []  # (s, e, ref)
_maxlen = 0


def _addr_range(t) -> Optional[Tuple[Tuple[str, int], int]]:
    """``((device, start), end)`` of a tensor's bytes — the storage's
    ``data_ptr()`` plus the tensor's byte offset, keyed by device so host
    and card addresses never meet — or None for payloads with no stable
    buffer address."""
    if not isinstance(t, torch.Tensor):
        return None
    start = (t.untyped_storage().data_ptr()
             + t.storage_offset() * t.element_size())
    return ((str(t.device), start), start + t.numel() * t.element_size())


def byte_view(t: torch.Tensor) -> memoryview:
    """A flat byte memoryview of a contiguous host tensor (any dtype,
    bfloat16 included — numpy has none, so the bytes go through uint8)."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


class BufRef:
    """One retained frame body, by reference until acked or copied."""

    __slots__ = ("_iov", "_owners", "ranges", "nbytes", "_pins",
                 "snapshotted", "_released")

    def __init__(self, parts: Sequence, register: bool = True) -> None:
        iov: List[memoryview] = []
        owners = []
        ranges: List[Tuple[Tuple[str, int], int]] = []
        nbytes = 0
        for p in parts:
            if isinstance(p, (bytes, bytearray, memoryview)):
                mv = memoryview(p)
                if mv.nbytes:
                    iov.append(mv if mv.format == "B" and mv.ndim == 1
                               else mv.cast("B"))
                    nbytes += mv.nbytes
                continue
            # a contiguous host tensor (the codec compacted or staged
            # it): keep the OWNER alive too while its views are retained
            n = p.numel() * p.element_size()
            if not n:
                continue
            iov.append(byte_view(p))
            owners.append(p)
            r = _addr_range(p)
            if r is not None:
                ranges.append(r)
            nbytes += n
        self._iov = iov
        self._owners = tuple(owners)
        self.ranges = tuple(ranges)
        self.nbytes = nbytes
        self._pins = 0
        self.snapshotted = not self.ranges  # immutable bodies need no CoW
        self._released = False
        if register and self.ranges:
            _register(self)

    # -- streaming (transport/socket.py) -----------------------------------

    def pin(self) -> Optional[List[memoryview]]:
        """Borrow the views for one streaming pass (sendmsg/sendall);
        None when the ref was already released (frame acked mid-replay:
        safe to skip — the receiver delivered it and dedups a replay).
        Pair with :meth:`unpin`."""
        with _cv:
            if self._released:
                return None
            self._pins += 1
            return list(self._iov)

    def unpin(self) -> None:
        with _cv:
            self._pins -= 1
            if self._released and self._pins == 0:
                self._clear_locked()
            _cv.notify_all()

    # -- ownership transitions ---------------------------------------------

    def _snapshot_locked(self) -> None:
        if self.snapshotted or self._released:
            return
        while self._pins:
            # a sender is streaming these exact views: copying under a
            # concurrent sendmsg is fine, but the CALLER of touch() is
            # about to MUTATE them — it must not proceed until the
            # in-flight pass is off the buffer
            _cv.wait(0.05)
            if self.snapshotted or self._released:
                return
        blob = b"".join(bytes(mv) for mv in self._iov)
        self._iov = [memoryview(blob)]
        self._owners = ()
        self.snapshotted = True
        _unregister_locked(self)
        _mpit.count(link_cow_snapshots=1, link_cow_bytes=len(blob))

    def release(self) -> None:
        """Ack prune / membership purge / window teardown: drop the
        ranges from the index now; free the views once unpinned."""
        with _cv:
            if self._released:
                return
            self._released = True
            _unregister_locked(self)
            if self._pins == 0:
                self._clear_locked()
            _cv.notify_all()

    def _clear_locked(self) -> None:
        self._iov = []
        self._owners = ()

    def tobytes(self) -> bytes:
        """Flat body content (tests / diagnostics)."""
        with _cv:
            return b"".join(bytes(mv) for mv in self._iov)


def _register(ref: BufRef) -> None:
    global _NLIVE, _maxlen
    with _cv:
        _live[id(ref)] = ref
        for (s, e) in ref.ranges:
            i = bisect.bisect_right(_starts, s)
            _starts.insert(i, s)
            _ivals.insert(i, (s, e, ref))
            if e - s[1] > _maxlen:
                _maxlen = e - s[1]
        _NLIVE = len(_live)


def _unregister_locked(ref: BufRef) -> None:
    global _NLIVE, _maxlen
    if _live.pop(id(ref), None) is not None:
        for (s, e) in ref.ranges:
            i = bisect.bisect_left(_starts, s)
            while i < len(_starts) and _starts[i] == s:
                if _ivals[i][2] is ref and _ivals[i][1] == e:
                    del _starts[i]
                    del _ivals[i]
                    break
                i += 1
        if not _ivals:
            _maxlen = 0
    _NLIVE = len(_live)


def live_refs() -> int:
    """Range-bearing retained refs process-wide (test introspection)."""
    with _cv:
        return len(_live)


def touch_ranges(ranges: Sequence[Tuple[Tuple[str, int], int]],
                 exclude: Optional[BufRef] = None) -> int:
    """Copy-on-write core: snapshot every live retained ref overlapping
    any of ``ranges`` (address intervals), BEFORE the caller's write or
    conflicting send proceeds.  Returns snapshots taken.

    Two-phase under the lock: COLLECT the overlapping refs from the
    sorted-interval index first (a snapshot mutates the index, and
    ``_snapshot_locked`` may drop the lock waiting for pins), THEN
    snapshot each — ``_snapshot_locked`` re-checks its own state so a
    concurrent ack prune or duplicate hit is benign."""
    if not _NLIVE or not ranges:
        return 0
    took = 0
    with _cv:
        hits: List[BufRef] = []
        seen: set = set()
        for ((dev, qs), qe) in ranges:
            i = bisect.bisect_left(_starts, (dev, qs - _maxlen))
            n = len(_starts)
            while i < n and _starts[i] < (dev, qe):
                s, e, ref = _ivals[i]
                if (e > qs and ref is not exclude
                        and not ref.snapshotted and id(ref) not in seen):
                    seen.add(id(ref))
                    hits.append(ref)
                i += 1
        for ref in hits:
            if not ref.snapshotted:
                ref._snapshot_locked()
                took += 1
    return took


def touch(arr) -> int:
    """Notify the ownership layer that ``arr``'s bytes are about to be
    WRITTEN in place.  Called by every internal mutation site (fold
    sites via ``ReduceOp.combine_into``, the segmented engine's
    copy-into-buffer sites, ``isendrecv_replace``'s refill);
    snapshot-copies any retained unacked frame still referencing the
    region.  Near-free when nothing is retained (one int compare)."""
    if not _NLIVE:
        return 0
    r = _addr_range(arr)
    if r is None:
        return 0
    return touch_ranges((r,))


def note_write(arr) -> int:
    """Public spelling of :func:`touch` — the borrow contract's hook for
    user code that mutates a just-sent host tensor outside any operation
    of the library.  Returns the number of retained frames snapshotted."""
    return touch(arr)
