"""Link resilience: sequenced frames, cumulative acks, bounded replay —
the port's own copy of what ``transport/socket.py`` uses of
``mpi_tpu/resilience.py``: ``LinkState`` with its per-peer stream
generation (``peer_gen`` :261, ``purge_peer`` :478, the ``gen`` argument
of ``rx_fresh`` / ``tx_ack`` / ``rx_gate``) and ``backoff_delays`` (:131),
and what the serve layer dials with: ``retry_connect`` (:160) and its
``TRANSIENT_DIAL_ERRORS`` (:157).  The link's retry budget and the
connect retry budget are the ``link_retry_timeout_s`` and
``connect_retry_timeout_s`` cvars, seeded from ``MPI_TPU_LINK_RETRY_S``
(:85; the launcher's ``--link-retry-timeout`` reaches its ranks this
way) and ``MPI_TPU_CONNECT_RETRY_S`` (:119).

A mid-send ``OSError`` on a socket is a LINK fault (a reset, a dropped
connection) between two live processes; it is healed transparently by
reconnecting and replaying what the peer did not receive:

* every data frame to a destination carries a per-destination sequence
  number (monotone from 1, assigned in wire order under the per-dest
  send lock);
* the sender retains each in-flight frame BY REFERENCE in a bounded
  window until the receiver's cumulative ack covers it (acks piggyback
  on every frame headed the other way and a per-transport flusher sends
  standalone ones for one-way streams); ``bufpool.py`` copies a
  retained frame on write only when its bytes are about to change;
* the receiver delivers contiguously and drops replay duplicates; a gap
  is a protocol violation, raised loudly;
* the reconnect handshake answers with ``resume(last delivered seq)``,
  so the sender replays only unacked frames.

A PEER fault (a dead process) is told from a link fault by the fault
tolerance layer (``ft.WorldFT.link_suspect``): the socket transport gives
up healing a link at once when its peer is suspect, and a full window's
wait re-checks the verdict every slice.  Without fault tolerance every
fault is a link fault and only the retry budget decides.

A membership transition (``membership.survivor_transition``) purges a
replaced slot's streams: its retained replay window and seq/delivery
marks belong to the dead incarnation, and the generation bump makes every
reader still draining the old connection drop its acks and frames.
With the flight recorder on, a window stall and a purge are ``link``
events (:337, :496).
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Iterator, List, Optional, Tuple

from . import bufpool as _bufpool
from . import mpit as _mpit
from . import telemetry as _telemetry
from .transport.base import TransportError

# Reconnect budget for ONE link fault: total time the sender may spend
# re-establishing a torn connection (and the no-ack-progress bound of a
# full retained window) before the fault becomes a TransportError.
# mpit cvar: link_retry_timeout_s; env default: MPI_TPU_LINK_RETRY_S.
_RETRY_TIMEOUT_S = float(os.environ.get("MPI_TPU_LINK_RETRY_S", "4.0"))

# Retained-window ceiling per destination: sends block (in slices) once
# this many unacked bytes are outstanding, and a window that makes no ack
# progress for the retry budget is itself a link verdict.  A single frame
# larger than the window is allowed once the window is otherwise empty
# (the classic streaming-window rule).
_WINDOW_BYTES = 64 << 20

# Backoff schedule shape of the link reconnect loop:
# exponential with full jitter, capped.  Values are generous for a
# loopback box; the cap keeps a long outage polling at a human cadence.
_BACKOFF_BASE_S = 0.02
_BACKOFF_FACTOR = 2.0
_BACKOFF_CAP_S = 0.5

_WINDOW_POLL_S = 0.05  # slice of the window-full wait

# Initial-connect retry budget of control-plane clients (the serve
# worker's control dial, serve.ServerClient / connect): a refused or
# timed-out dial is retried with the backoff schedule for this long, the
# server may still be binding.  0 restores first-failure raise.
# mpit cvar: connect_retry_timeout_s; env: MPI_TPU_CONNECT_RETRY_S.
_CONNECT_RETRY_TIMEOUT_S = float(
    os.environ.get("MPI_TPU_CONNECT_RETRY_S", "10.0"))

# Idle-link keepalive cadence (cvar link_keepalive_s): cached connections
# that sent nothing for this long are probed with a header-only ack frame
# by the ack flusher, so a link torn while idle heals before the next
# send.  0 disables probing.
_KEEPALIVE_S = 1.0


def backoff_delays(base: float = _BACKOFF_BASE_S,
                   factor: float = _BACKOFF_FACTOR,
                   cap: float = _BACKOFF_CAP_S,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """Endless exponential-backoff-with-full-jitter schedule: the k-th
    delay is uniform in [0, min(cap, base * factor**k)].  Full jitter
    (AWS-style) rather than +/- fuzz: simultaneous retriers (every rank
    of a world saw the same reset) must not reconverge on the same
    retry instants."""
    rng = rng or random
    ceiling = base
    while True:
        yield rng.uniform(0.0, ceiling)
        ceiling = min(cap, ceiling * factor)


# Dial failures retry_connect waits out: a refused connect (the server is
# still binding) and a connect that timed out (a listener that absorbed
# the handshake without completing it).  Anything else propagates at once.
TRANSIENT_DIAL_ERRORS = (ConnectionRefusedError, TimeoutError)


def retry_connect(dial: Callable[[], "object"],
                  timeout_s: Optional[float] = None,
                  rng: Optional[random.Random] = None,
                  retry_on: Tuple[type, ...] = TRANSIENT_DIAL_ERRORS):
    """Run ``dial()`` (a socket factory), retrying the failures in
    ``retry_on`` with backoff and jitter for up to ``timeout_s`` (default:
    the connect_retry_timeout_s cvar); any other failure propagates at
    once."""
    budget = _CONNECT_RETRY_TIMEOUT_S if timeout_s is None else timeout_s
    deadline = time.monotonic() + budget
    delays = backoff_delays(rng=rng)
    while True:
        try:
            return dial()
        except retry_on:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise
            time.sleep(min(next(delays), remaining))


class _TxState:
    """Per-destination sender stream: next seq, the retained unacked
    frames (seq, header word, body :class:`bufpool.BufRef`), and the
    cumulative ack high-water mark received back from the peer."""

    __slots__ = ("seq", "acked", "retained", "retained_bytes",
                 "was_connected")

    def __init__(self) -> None:
        self.seq = 0          # last sequence number assigned
        self.acked = 0        # highest cumulative ack received
        self.retained: Deque[Tuple[int, int, _bufpool.BufRef]] = deque()
        self.retained_bytes = 0
        # whether a connection to this destination was ever established:
        # distinguishes a RE-connect (counted in link_reconnects) from
        # the world's initial connection setup
        self.was_connected = False


class _RxState:
    """Per-source receiver stream: the contiguous-delivery high-water
    mark and the ack bookkeeping the flusher consults."""

    __slots__ = ("delivered", "ack_sent")

    def __init__(self) -> None:
        self.delivered = 0    # highest contiguously delivered seq
        self.ack_sent = 0     # highest ack value put on the wire


class LinkState:
    """The per-transport resilience state: one tx stream per
    destination, one rx stream per source, a condition variable for the
    retained-window waiters and the ack flusher.  All methods are
    thread-safe; wire-order-sensitive ones (seq assignment, resume)
    additionally require the transport's per-dest send lock, which is
    what serializes writes to one connection anyway."""

    def __init__(self, world_size: int) -> None:
        self._tx: Dict[int, _TxState] = {}
        self._rx: Dict[int, _RxState] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # sources with delivered > ack_sent (the flusher's work list)
        self._ack_pending: set = set()
        # per-peer STREAM GENERATION, bumped by purge_peer: a reader still
        # draining a replaced slot's old connection captured the old one,
        # and its acks/frames are dropped (one stale ack applied to the
        # replacement's fresh stream would stall its window for good)
        self._gen: Dict[int, int] = {}
        self._closed = False

    # -- tiny accessors ----------------------------------------------------

    def _tx_of(self, dest: int) -> _TxState:
        st = self._tx.get(dest)
        if st is None:
            st = self._tx[dest] = _TxState()
        return st

    def _rx_of(self, src: int) -> _RxState:
        st = self._rx.get(src)
        if st is None:
            st = self._rx[src] = _RxState()
        return st

    def delivered(self, src: int) -> int:
        """Contiguous-delivery high-water mark for ``src`` — what the
        hello-ack's resume field reports to a (re)connecting peer."""
        with self._lock:
            return self._rx_of(src).delivered

    def peer_gen(self, rank: int) -> int:
        """Current stream generation of ``rank``: readers capture it at
        handshake and present it with every ack and frame."""
        with self._lock:
            return self._gen.get(rank, 0)

    def rx_fresh(self, src: int, seq: int, gen: int) -> bool:
        """True iff data frame ``(seq, gen)`` from ``src`` is the next
        in-sequence frame of the CURRENT generation — exactly the frames
        ``rx_gate`` will deliver, in delivery order.  The steering
        registry (recvpool.py) gates its arrival counting on this so
        duplicates, stale generations and gap frames never advance a
        channel's pairing index; its per-channel watermark closes the
        race of two connections presenting the same fresh frame."""
        with self._lock:
            if gen != self._gen.get(src, 0):
                return False
            st = self._rx.get(src)
            return seq == (st.delivered if st is not None else 0) + 1

    def mark_connected(self, dest: int) -> bool:
        """Record an established connection; True iff this replaced an
        EARLIER established one (i.e. a reconnect, not initial setup)."""
        with self._lock:
            st = self._tx_of(dest)
            was = st.was_connected
            st.was_connected = True
            return was

    # -- sender side -------------------------------------------------------

    def wait_window(self, dest: int, nbytes: int,
                    suspect: Callable[[int], bool],
                    closing: Callable[[], bool]) -> None:
        """Block until ``nbytes`` more retained bytes fit the window (or
        the window is empty — one oversized frame may always proceed).
        Re-checks the fault-tolerance suspect verdict every slice; the
        no-ack-progress wait is bounded by the retry budget: a peer that
        stops acking for that long IS a link verdict, promoted to
        TransportError here (ProcFailedError under fault tolerance)."""
        deadline = time.monotonic() + _RETRY_TIMEOUT_S
        with self._cv:
            while True:
                st = self._tx_of(dest)
                if (st.retained_bytes == 0
                        or st.retained_bytes + nbytes <= _WINDOW_BYTES):
                    return
                if self._closed or closing():
                    raise TransportError(
                        "transport closed while waiting for link window")
                progress_mark = st.acked
                self._cv.wait(_WINDOW_POLL_S)
                if st.acked > progress_mark:
                    deadline = time.monotonic() + _RETRY_TIMEOUT_S
                    continue
                if suspect(dest):
                    raise TransportError(
                        f"peer {dest} declared failed while its link "
                        f"window was full ({st.retained_bytes} unacked "
                        f"bytes)")
                if time.monotonic() > deadline:
                    rec = _telemetry.REC
                    if rec is not None:
                        rec.emit("link", "window_stall",
                                 attrs={"peer": dest,
                                        "retained_bytes": st.retained_bytes})
                    raise TransportError(
                        f"link to rank {dest}: no ack progress for "
                        f"{_RETRY_TIMEOUT_S}s with {st.retained_bytes} "
                        f"retained bytes (window {_WINDOW_BYTES}); "
                        f"declaring the link dead")

    def tx_retain(self, dest: int, word: int, body) -> int:
        """Assign the next sequence number for ``dest`` and retain the
        frame body — a :class:`bufpool.BufRef` (by-reference views of
        the caller's buffers) or raw ``bytes`` (wrapped into an
        immutable ref) — until acked.
        Caller holds the per-dest send lock (seq order must equal wire
        order)."""
        if not isinstance(body, _bufpool.BufRef):
            body = _bufpool.BufRef([bytes(body)], register=False)
        with self._lock:
            st = self._tx_of(dest)
            st.seq += 1
            st.retained.append((st.seq, word, body))
            st.retained_bytes += body.nbytes
            _mpit.count(link_bytes_retained=body.nbytes)
            return st.seq

    def tx_ack(self, dest: int, ack: int,
               gen: Optional[int] = None) -> None:
        """Apply a cumulative ack from ``dest`` (piggybacked or
        standalone): prune the retained prefix, wake window waiters.
        Acks are monotone; a stale value (a replayed header) is a no-op,
        and so is an ack read on a since-purged incarnation's connection
        (``gen`` mismatch)."""
        with self._cv:
            if gen is not None and gen != self._gen.get(dest, 0):
                return
            st = self._tx_of(dest)
            if ack <= st.acked:
                return
            st.acked = ack
            retained = st.retained
            while retained and retained[0][0] <= ack:
                _, _, body = retained.popleft()
                st.retained_bytes -= body.nbytes
                body.release()  # unpins the caller's buffer + ranges
            self._cv.notify_all()

    def resume(self, dest: int, last_delivered: int
               ) -> List[Tuple[int, int, _bufpool.BufRef]]:
        """Reconnect-time resume: the peer reported the last seq it
        delivered from us — treat it as an ack (frames at or below it
        arrived; replaying them would only be dropped as dups) and
        return the retained frames BEYOND it for replay, in seq order.
        Caller holds the per-dest send lock."""
        self.tx_ack(dest, last_delivered)
        with self._lock:
            return list(self._tx_of(dest).retained)

    # -- receiver side -----------------------------------------------------

    def rx_gate(self, src: int, seq: int, deliver: Callable[[], None],
                gen: Optional[int] = None) -> bool:
        """Deliver-or-drop decision for an arriving data frame, atomic
        with the delivery itself (two reader threads of one src — the
        dying connection's and its replacement's — may race here, and
        FIFO into the mailbox must follow seq order).  Returns True iff
        delivered.  A seq GAP is a protocol violation (impossible under
        TCP FIFO + resume-replay): raised loudly, never reordered
        around."""
        with self._cv:
            if gen is not None and gen != self._gen.get(src, 0):
                return False  # a purged incarnation's stream died with it
            st = self._rx_of(src)
            if seq <= st.delivered:
                return False  # replay duplicate: already delivered
            if seq != st.delivered + 1:
                raise TransportError(
                    f"sequence gap from rank {src}: got frame {seq}, "
                    f"expected {st.delivered + 1} — sequenced-link "
                    f"protocol violation")
            deliver()
            st.delivered = seq
            if st.delivered > st.ack_sent:
                self._ack_pending.add(src)
                self._cv.notify_all()
            return True

    def peek_ack(self, src: int) -> Optional[int]:
        """The ack value a standalone ACK frame to ``src`` should carry
        right now, or None when the peer already has it."""
        with self._lock:
            st = self._rx_of(src)
            return st.delivered if st.delivered > st.ack_sent else None

    def note_ack_sent(self, src: int, value: int) -> None:
        """Record ``value`` as on the wire (call AFTER the send
        succeeded — an optimistic mark on a failed send would starve
        the peer's window)."""
        with self._lock:
            st = self._rx_of(src)
            if value > st.ack_sent:
                st.ack_sent = value
            if st.ack_sent >= st.delivered:
                self._ack_pending.discard(src)

    def piggyback_ack(self, src: int) -> int:
        """Ack value to stamp into a data frame headed to ``src``.
        Deliberately does NOT mark it sent — the frame may still fail
        and be replayed with a fresher value; the flusher's standalone
        ack is simply skipped by the peer's monotone tx_ack if the
        piggyback beat it."""
        with self._lock:
            return self._rx_of(src).delivered

    def wait_ack_pending(self, timeout: float) -> List[int]:
        """Flusher park: block until some source has undelivered acks
        (or timeout); returns the pending sources (cleared lazily by
        note_ack_sent)."""
        with self._cv:
            if not self._ack_pending and not self._closed:
                self._cv.wait(timeout)
            return sorted(self._ack_pending)

    def purge_peer(self, rank: int) -> None:
        """Slot replacement (``membership_invalidate``): the old
        incarnation's streams die with it.  Its retained replay window is
        released (a rejoiner must never see a stale replay: its streams
        start at seq 1), our seq toward it and its delivery mark reset, and
        the generation bump invalidates every reader still draining its
        old connections."""
        with self._cv:
            st = self._tx.pop(rank, None)
            self._rx.pop(rank, None)
            self._ack_pending.discard(rank)
            self._gen[rank] = self._gen.get(rank, 0) + 1
            gen = self._gen[rank]
            self._cv.notify_all()
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("link", "purge", attrs={"peer": rank, "gen": gen})
        if st is not None:
            for _, _, body in st.retained:
                body.release()

    def close(self) -> None:
        # free the retained windows: the refs pin caller buffers for
        # exactly as long as a replay could still need them — which is
        # never, once closed.  Taken under the lock: a reader thread may
        # be pruning a window (tx_ack) right now.
        with self._cv:
            self._closed = True
            bodies = [body for st in self._tx.values()
                      for _, _, body in st.retained]
            for st in self._tx.values():
                st.retained.clear()
                st.retained_bytes = 0
            self._cv.notify_all()
        for body in bodies:
            body.release()
