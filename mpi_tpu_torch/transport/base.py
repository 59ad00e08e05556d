"""Transport plugin boundary and the shared message-matching engine — the
port's own copy of ``mpi_tpu/transport/base.py``: ``ANY_SOURCE`` /
``ANY_TAG``, ``TransportError`` / ``RecvTimeout``, ``payload_nbytes``
(:36), ``Mailbox`` (:47) with the progress engine's doorbell
(``deliveries``, ``nudge``, ``wait_activity``, :59-87) and the verifier's
vector-clock ``stamp`` and ``clock`` with the wildcard-race check in the
consume scan (:47-131), and ``Transport`` (:234) with ``verify_clock``
(:282-288)
(:234) with its ``aliases_payloads`` (:252), ``coll_segment_hint``
(:261), the membership ``epoch`` / ``min_peer_epoch`` (:295-305), the
survivor-transition hook ``membership_invalidate`` (:340) and
``progress_park`` (:350).

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
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    """Thread-safe matching queue of (src, ctx, tag, payload, stamp)
    messages.  ``stamp`` is the sender's vector-clock stamp under verify
    and None otherwise (``verify/vclock.py``).

    A match names its context exactly, so the queue is kept per context
    (in arrival order within each): a receive scans only its own
    context's messages.  Thousands of nonblocking collectives in flight,
    each on a context of its own, then cost a short scan per match
    instead of one over every pending message of the rank."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # ctx -> [(src, ctx, tag, payload, arrival, stamp), ...]
        self._by_ctx: Dict[Any, List[Tuple[int, Any, int, Any, int, Any]]] = {}
        self._closed = False
        # lifetime delivery count: the progress engine's doorbell
        self.deliveries = 0
        # contexts that received messages since the progress engine last
        # looked (take_dirty): a pass visits only their communicators
        self._dirty: set = set()
        # receiver-side vector clock, attached by verify.enable(): the
        # consume scan merges each consumed stamp and runs the wildcard
        # race check against the pending alternates it sees under this
        # lock.  None outside verify mode (one test per consume).
        self.clock = None

    def deliver(self, src: int, ctx, tag: int, payload: Any,
                stamp: Any = None) -> None:
        with self._cv:
            self.deliveries += 1
            self._by_ctx.setdefault(ctx, []).append(
                (src, ctx, tag, payload, self.deliveries, stamp))
            self._dirty.add(ctx)
            self._cv.notify_all()

    def take_dirty(self) -> set:
        """The contexts that received messages since the last call."""
        with self._lock:
            dirty, self._dirty = self._dirty, set()
            return dirty

    def _pending_locked(self, limit: Optional[int] = None
                        ) -> List[Tuple[int, Any, int]]:
        """(src, ctx, tag) of the pending messages in arrival order."""
        items = sorted((i for q in self._by_ctx.values() for i in q),
                       key=lambda i: i[4])
        return [i[:3] for i in items[:limit]]

    def nudge(self) -> None:
        """Wake every waiter without delivering anything (the progress
        engine's stop path pops its parked thread out of
        ``wait_activity``)."""
        with self._cv:
            self._cv.notify_all()

    def wait_activity(self, seen: int, timeout: float) -> int:
        """Park until the delivery count moves past ``seen`` (or timeout);
        returns the current count.  Raises TransportError once closed, so
        a parked engine exits instead of spinning."""
        with self._cv:
            if self.deliveries == seen and not self._closed:
                self._cv.wait(timeout)
            if self._closed:
                raise TransportError("transport closed while parked")
            return self.deliveries

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
        queue = self._by_ctx.get(ctx)
        if not queue:
            return None
        for i, item in enumerate(queue):
            if self._matches(item, source, ctx, tag):
                if consume:
                    queue.pop(i)
                    if not queue:
                        del self._by_ctx[ctx]
                    stamp = item[5]
                    if self.clock is not None and stamp is not None:
                        # verify: merge the consumed stamp; for a USER
                        # wildcard receive every other pending message
                        # this scan could have matched is a race
                        # candidate (internal negative tags never race)
                        wild = (source == ANY_SOURCE
                                and (tag >= 0 or tag == ANY_TAG))
                        alts = ([(it[0], it[5]) for it in queue
                                 if self._matches(it, ANY_SOURCE, ctx, tag)
                                 and it[0] != item[0] and it[5] is not None]
                                if wild else ())
                        self.clock.note_consume(item[0], item[2], stamp,
                                                alts, wild)
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
                            f"{self._pending_locked(16)}")
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

    def count_matching(self, source: int, ctx, tag: int) -> int:
        """Number of queued messages matching (source, ctx, tag) now: the
        steering registry's activation BACKLOG (a user channel's first
        posted buffer seeds its pairing lag with it,
        ``recvpool.note_post_user``)."""
        with self._lock:
            return sum(1 for item in self._by_ctx.get(ctx, ())
                       if self._matches(item, source, ctx, tag))

    def pending_summary(self) -> List[Tuple[int, Any, int]]:
        with self._lock:
            return self._pending_locked(16)

    def drain(self) -> List[Tuple[int, Any, int]]:
        """Return and clear all pending (src, ctx, tag) — the finalize
        'unexpected message' check."""
        with self._lock:
            items = self._pending_locked()
            self._by_ctx.clear()
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

    # Verify-mode vector clock (verify/vclock.py), attached by
    # verify.enable() together with mailbox.clock.  Send paths test exactly
    # ``verify_clock is None`` and under verify either wrap the wire ctx
    # (socket framing) or pass tick_send()'s stamp to mailbox.deliver
    # (same-process deliveries).
    verify_clock = None

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
        # Elastic-membership generation (membership.py): the monotone
        # epoch this process believes its world is in, bumped by shrink()
        # and survivor_transition(), stamped into the socket hello.
        self.epoch = 0
        # world rank -> least endpoint epoch acceptable when (re)connecting
        # to it: the transition epoch of a REPLACED slot
        self.min_peer_epoch: Dict[int, int] = {}

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

    def membership_invalidate(self, dead: Sequence[int]) -> None:
        """Epoch-transition hook (``membership.survivor_transition``):
        drop every cached endpoint to the given world ranks so the next
        send re-handshakes.  Base: nothing is cached per peer."""

    def progress_park(self, timeout: float) -> bool:
        """Progress-engine park (``progress.py``): block until a delivery
        or ``timeout``; True iff anything arrived.  Parks on the Mailbox
        condition, which every delivery (socket reader threads,
        local-world peer sends) rings.  Raises TransportError once the
        transport closes, the engine's exit signal."""
        seen = self.mailbox.deliveries
        return self.mailbox.wait_activity(seen, timeout) != seen

    def close(self) -> None:
        self.mailbox.close()


def bind_thread_device(device: torch.device) -> None:
    """Make ``device`` current for the calling thread before its first
    launch: every helper thread of the host layer (the progress engine,
    the fold pool, a nonblocking collective's thread) launches clones and
    folds, and a thread's current card is its own."""
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
