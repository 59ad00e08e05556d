"""Transport plugin boundary and the shared message-matching engine — the
port's own copy of ``mpi_tpu/transport/base.py``: ``ANY_SOURCE`` /
``ANY_TAG``, ``TransportError`` / ``RecvTimeout``, ``payload_nbytes``
(:36), ``Mailbox`` (:47) and ``Transport`` (:234) with its
``aliases_payloads`` (:252) and ``coll_segment_hint`` (:261).

A Transport moves opaque payloads between world ranks; every transport
shares one Mailbox so matching semantics are identical across them:

* ANY_SOURCE matches any source rank;
* ANY_TAG matches only *user* tags (>= 0): internal negative tags (the
  collectives' and barrier's) must be matched exactly, so a user wildcard
  receive can never steal collective traffic;
* messages on one (source, context, tag) key match in FIFO order.

Payloads are whatever the communicator hands over — usually
``torch.Tensor``s, which stay on the device they live on.
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from typing import Any, List, Optional, Tuple

import torch

ANY_SOURCE = -1
ANY_TAG = -1


class TransportError(RuntimeError):
    pass


class RecvTimeout(TransportError):
    pass


def payload_nbytes(obj: Any) -> Optional[int]:
    """Size of a sized payload (tensor / array / bytes-like), None for
    opaque objects — the count a probe reports without consuming (Status
    applies the same rule after a receive)."""
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    return None


class Mailbox:
    """Thread-safe matching queue of (src, ctx, tag, payload) messages."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._items: List[Tuple[int, Any, int, Any]] = []
        self._closed = False

    def deliver(self, src: int, ctx, tag: int, payload: Any) -> None:
        with self._cv:
            self._items.append((src, ctx, tag, payload))
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @staticmethod
    def _matches(item, source: int, ctx, tag: int) -> bool:
        s, c, t = item[0], item[1], item[2]
        if c != ctx:
            return False
        if source != ANY_SOURCE and s != source:
            return False
        if tag == ANY_TAG:
            return t >= 0  # wildcards never match internal (negative) tags
        return t == tag

    def _scan_locked(self, source: int, ctx, tag: int,
                     consume: bool) -> Optional[Tuple[Any, int, int]]:
        """Oldest matching message as (payload, src, tag); pops iff
        consume.  Caller holds the lock."""
        for i, item in enumerate(self._items):
            if self._matches(item, source, ctx, tag):
                if consume:
                    self._items.pop(i)
                return item[3], item[0], item[2]
        return None

    def _blocking_scan(self, source: int, ctx, tag: int, consume: bool,
                       timeout: Optional[float], what: str) -> Tuple[Any, int, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                hit = self._scan_locked(source, ctx, tag, consume)
                if hit is not None:
                    return hit
                if self._closed:
                    raise TransportError(
                        f"transport closed while waiting for {what}"
                        f"(source={source}, ctx={ctx}, tag={tag})")
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise RecvTimeout(
                            f"{what}(source={source}, ctx={ctx}, tag={tag}) timed "
                            f"out after {timeout}s; pending="
                            f"{[i[:3] for i in self._items[:16]]}")
                    self._cv.wait(remaining)

    def match(self, source: int, ctx, tag: int,
              timeout: Optional[float] = None) -> Tuple[Any, int, int]:
        """Block until the oldest message matching (source, ctx, tag)
        arrives; return (payload, src, tag)."""
        return self._blocking_scan(source, ctx, tag, True, timeout, "recv")

    def poll(self, source: int, ctx, tag: int) -> Optional[Tuple[Any, int, int]]:
        """Non-blocking match: pop and return the oldest matching message,
        or None.  Raises TransportError on a closed, unmatched mailbox so
        polling loops fail like blocking receives do."""
        with self._lock:
            hit = self._scan_locked(source, ctx, tag, True)
            if hit is None and self._closed:
                raise TransportError(
                    f"transport closed while polling recv(source={source}, "
                    f"ctx={ctx}, tag={tag})")
            return hit

    def peek_nowait(self, source: int, ctx, tag: int
                    ) -> Optional[Tuple[int, int, Optional[int]]]:
        """Non-blocking, non-consuming scan: (src, tag, nbytes) of the
        oldest match, or None (MPI_Iprobe substrate)."""
        with self._lock:
            hit = self._scan_locked(source, ctx, tag, False)
            if hit is None and self._closed:
                raise TransportError(
                    f"transport closed while probing (source={source}, "
                    f"ctx={ctx}, tag={tag})")
            return (None if hit is None
                    else (hit[1], hit[2], payload_nbytes(hit[0])))

    def peek(self, source: int, ctx, tag: int,
             timeout: Optional[float] = None) -> Tuple[int, int, Optional[int]]:
        """Like match() but WITHOUT consuming (MPI_Probe)."""
        p, s, t = self._blocking_scan(source, ctx, tag, False, timeout,
                                      "probe")
        return s, t, payload_nbytes(p)

    def drain(self) -> List[Tuple[int, Any, int]]:
        """Return and clear all pending (src, ctx, tag) — the finalize
        'unexpected message' check."""
        with self._lock:
            items = [i[:3] for i in self._items]
            self._items.clear()
            return items


class Transport(ABC):
    """Moves payloads between world ranks; owns a Mailbox for incoming
    traffic and the device received tensors are placed on."""

    # True only for transports that deliver payloads BY REFERENCE (the
    # local transport with copy_payloads=False): the collective engine
    # then snapshots the working-buffer views it sends, since it folds
    # into that buffer in place while a view may still be in flight.
    aliases_payloads = False

    # Preferred pipeline-segment size of the segmented collective engine
    # for this transport's data plane, used when the
    # ``collective_segment_bytes`` cvar is 0 (= auto).
    coll_segment_hint = 256 << 10

    # The registry of posted receives (recvpool.PostedRecvRegistry) of a
    # transport whose reader can land a frame's body directly in a posted
    # receive's destination (the socket transport); None elsewhere.
    recv_registry = None

    def __init__(self, world_rank: int, world_size: int, device=None) -> None:
        from ..gpu.runner import resolve_device

        self.world_rank = world_rank
        self.world_size = world_size
        # None is the card, as for every entry point: no CPU fallback
        self.device = resolve_device(device)
        self.mailbox = Mailbox()

    @abstractmethod
    def send(self, dest: int, ctx, tag: int, payload: Any) -> None:
        """Buffered (non-blocking w.r.t. the receiver) send to world rank
        ``dest``; FIFO per (self, dest) channel.  ``ctx`` is any hashable
        communicator-context id."""

    def recv(self, source: int, ctx, tag: int,
             timeout: Optional[float] = None) -> Tuple[Any, int, int]:
        return self.mailbox.match(source, ctx, tag, timeout=timeout)

    def poll(self, source: int, ctx, tag: int) -> Optional[Tuple[Any, int, int]]:
        return self.mailbox.poll(source, ctx, tag)

    def peek(self, source: int, ctx, tag: int,
             timeout: Optional[float] = None) -> Tuple[int, int, Optional[int]]:
        return self.mailbox.peek(source, ctx, tag, timeout=timeout)

    def peek_nowait(self, source: int, ctx, tag: int
                    ) -> Optional[Tuple[int, int, Optional[int]]]:
        return self.mailbox.peek_nowait(source, ctx, tag)

    def close(self) -> None:
        self.mailbox.close()
