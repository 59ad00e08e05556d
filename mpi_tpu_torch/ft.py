"""User-level fault tolerance (ULFM) — detection, revocation, recovery —
the port's own copy of ``mpi_tpu/ft.py``: ``MemoryLiveness`` (:86),
``FileLiveness`` (:102), ``WorldFT`` (:127) with its detector loop (:160)
and ``link_suspect`` (:210), ``CommFT`` (:265), ``enable`` (:318), the
agreement ``_agreement`` (:351) / ``_agreement_recv`` (:401) and
``failed_comm_ranks`` (:447).

* **Detection** — every fault-tolerant rank runs one detector thread that
  publishes its own heartbeat and watches every peer's; a peer whose
  heartbeat is stale past ``fault_detect_timeout_s`` is marked failed.
  Two liveness substrates: heartbeat FILES under the rendezvous dir for
  process worlds (a dead process stops touching its file), a shared
  in-memory beat table for the local thread world (where
  ``transport/faulty.py``'s ``kill_after_n`` simulates a death).
* **Conversion** — every blocking wait of the communicator (p2p recv and
  probe, the segmented engine's receive drains, the nonblocking
  collectives' waits) runs in short slices and re-checks the detector
  between them; a hit surfaces as ``ProcFailedError`` naming the failed
  ranks, the collective and the pipeline segment.
* **Propagation** — ``comm.revoke()`` sends a revocation on a reserved
  control tag; any rank entering or blocked inside an operation on the
  revoked communicator raises ``RevokedError``.
* **Recovery** — ``comm.shrink()`` (the survivors agree on the failed set
  and build a dense sub-communicator) and ``comm.agree()``
  (fault-tolerant AND agreement).

The agreement is a lockstep iterated all-to-all exchange of monotone
(failed-view, AND-value) pairs that ends after two consecutive clean
rounds; with crash-stop failures stable by the time it starts, all
survivors converge on identical results.  A FALSE suspicion (a live peer
stalled past the bound) can split the group, the tradeoff every
timeout-based detector has.

The detector and the agreement move only control data (stamps, small
tuples); no tensor is touched, so nothing here runs on the card.  With
the flight recorder on, each first suspicion is an ``ft suspect`` event
naming the rank and why (:203).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import mpit as _mpit
from . import telemetry as _telemetry
from .errors import RevokedError
from .transport.base import ANY_SOURCE, RecvTimeout, TransportError

# Reserved control tags (negative: user wildcards never match them;
# distinct from the communicator's collective/barrier/shift tags).
TAG_REVOKE = -6
TAG_SHRINK = -7
TAG_AGREE = -8

# Detection bound: a peer whose heartbeat is stale this long is declared
# failed (cvar fault_detect_timeout_s).
_DETECT_TIMEOUT_S = 5.0
# How often each rank publishes its heartbeat and scans its peers'
# (cvar fault_heartbeat_interval_s).
_HEARTBEAT_S = 0.25
# Slice of every fault-tolerant blocking wait: the latency between a
# detector hit or an arriving revocation and the blocked wait noticing.
POLL_S = 0.05


class MemoryLiveness:
    """Shared beat table of one in-process world (local rank threads)."""

    def __init__(self, size: int) -> None:
        self._beats = [0] * size
        self._lock = threading.Lock()

    def beat(self, rank: int) -> None:
        with self._lock:
            self._beats[rank] += 1

    def stamp(self, rank: int) -> Optional[int]:
        with self._lock:
            return self._beats[rank]


class FileLiveness:
    """Heartbeat files ``hb.<rank>`` under the rendezvous dir: a rank
    touches its own file every interval; the stamp is the file's mtime."""

    def __init__(self, rdv_dir: str, rank: int) -> None:
        self._rdv = rdv_dir
        self._path = os.path.join(rdv_dir, f"hb.{rank}")
        with open(self._path, "w") as f:
            f.write("alive")

    def beat(self, rank: int) -> None:
        try:
            os.utime(self._path, None)
        except OSError:
            pass  # rendezvous dir tearing down: the world is exiting

    def stamp(self, rank: int) -> Optional[int]:
        try:
            return os.stat(os.path.join(self._rdv, f"hb.{rank}")).st_mtime_ns
        except OSError:
            return None  # not yet published (or swept): treated as stale


class WorldFT:
    """Per-process failure-detection state: the detector thread, the
    failed set (WORLD ranks) and the liveness substrate, shared by every
    communicator derived from one transport."""

    def __init__(self, transport, liveness, detect_timeout_s: float,
                 heartbeat_s: float) -> None:
        self._t = transport
        self._liveness = liveness
        self.detect_timeout_s = float(detect_timeout_s)
        self.heartbeat_s = float(heartbeat_s)
        self.failed: set = set()  # world ranks
        # world ranks whose failure some communicator acknowledged with
        # failure_ack: membership's re-admission gate
        self.acked_world: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # peer -> (last stamp seen, local monotonic time it changed)
        now = time.monotonic()
        self._last: Dict[int, Tuple[Optional[int], float]] = {
            p: (None, now) for p in range(transport.world_size)
            if p != transport.world_rank}
        liveness.beat(transport.world_rank)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"mpi-tpu-torch-ft-detector-{transport.world_rank}")
        self._thread.start()

    def _loop(self) -> None:
        last_tick = time.monotonic()
        while not self._stop.is_set():
            # a kill-injected rank (FaultyTransport.killed) is dead to the
            # world: it stops beating AND stops accusing others
            if getattr(self._t, "killed", False):
                return
            self._liveness.beat(self._t.world_rank)
            now = time.monotonic()
            if now - last_tick > max(self.detect_timeout_s / 2,
                                     3.0 * self.heartbeat_s):
                # WE were descheduled: staleness measured across our own
                # stall is no evidence (we stopped beating too), so every
                # unchanged peer's window restarts; a dead peer is still
                # caught one window later
                self._last = {p: (s, now) for p, (s, _) in self._last.items()}
            last_tick = now
            for peer, (stamp, changed) in list(self._last.items()):
                if peer in self.failed:
                    continue
                cur = self._liveness.stamp(peer)
                if cur is not None and cur != stamp:
                    self._last[peer] = (cur, now)
                elif now - changed > self.detect_timeout_s:
                    self.observe(peer, f"heartbeat stale for {now - changed:.1f}s")
            self._stop.wait(self.heartbeat_s)

    def observe(self, world_rank: int, why: str) -> None:
        """Mark a world rank failed (a detector hit, or transport evidence
        such as a failed send); counts the detection pvar once."""
        with self._lock:
            if world_rank in self.failed:
                return
            self.failed.add(world_rank)
        _mpit.count(proc_failed=1)
        rec = _telemetry.REC
        if rec is not None:
            # WHEN did this rank first suspect whom, and why
            rec.emit("ft", "suspect",
                     attrs={"rank": world_rank, "why": why[:120]})

    def link_suspect(self, peer: int) -> bool:
        """PEER-fault verdict for the socket link layer: True when ``peer``
        is in the failed set OR its heartbeat is stale past the bound right
        now (the direct read covers the window before the detector
        ticks).  A stamp that moved since the detector looked is an
        immediate not-suspect verdict."""
        with self._lock:
            if peer in self.failed:
                return True
        last = self._last.get(peer)
        if last is None:
            return False  # self, or an unknown rank: no liveness claim
        stamp, changed = last
        try:
            cur = self._liveness.stamp(peer)
        except Exception:  # pragma: no cover - substrate tearing down
            return False
        if cur is not None and cur != stamp:
            return False
        return time.monotonic() - changed > self.detect_timeout_s

    def failed_snapshot(self) -> set:
        """A consistent copy of the failed set (an unlocked copy racing
        the detector's add can raise mid-iteration)."""
        with self._lock:
            return set(self.failed)

    def ack_world(self, world_ranks) -> None:
        with self._lock:
            self.acked_world |= set(world_ranks)

    def reset_rank(self, world_rank: int) -> None:
        """Re-admit a replaced slot (membership's epoch transition): clear
        its failed/acked state and restart its detection window, so the
        rejoined incarnation gets a full bound before it can be suspected
        again."""
        with self._lock:
            self.failed.discard(world_rank)
            self.acked_world.discard(world_rank)
        if world_rank != self._t.world_rank:
            self._last[world_rank] = (None, time.monotonic())

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)


class CommFT:
    """Per-communicator fault-tolerance state: the revocation flag, the
    acknowledged failures (comm ranks) and agreement epochs.
    Nonblocking-collective clones share their parent's instance (a revoke
    must unblock a collective in flight); split/dup/shrink children get a
    fresh one (revocation does not propagate across communicator
    creation)."""

    def __init__(self, world: WorldFT, home_ctx) -> None:
        self.world = world
        self.home_ctx = home_ctx
        self.revoked = False
        self.acked: set = set()
        self._epochs: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._last_revoke_poll = 0.0

    def next_epoch(self, tag: int) -> int:
        with self._lock:
            self._epochs[tag] = self._epochs.get(tag, 0) + 1
            return self._epochs[tag]

    def current_epoch(self, tag: int) -> int:
        with self._lock:
            return self._epochs.get(tag, 0)

    def check(self, comm) -> None:
        """Entry/slice check of every fault-tolerant operation: raise if
        this communicator is revoked, applying a queued revocation first
        (the one delivery point of TAG_REVOKE, counted in
        ``revokes_delivered``).  The mailbox scan is rate-limited to the
        POLL_S cadence: it runs on every send."""
        if not self.revoked:
            now = time.monotonic()
            if now - self._last_revoke_poll >= POLL_S:
                self._last_revoke_poll = now
                try:
                    hit = comm._t.poll(ANY_SOURCE, self.home_ctx, TAG_REVOKE)
                except TransportError:
                    hit = None  # closed mailbox: the wait path reports it
                if hit is not None:
                    self.revoked = True
                    _mpit.count(revokes=1)
        if self.revoked:
            raise RevokedError(
                f"communicator (ctx={comm._ctx}) has been revoked")


def enable(comm, liveness=None, rdv_dir: Optional[str] = None,
           detect_timeout_s: Optional[float] = None,
           heartbeat_s: Optional[float] = None):
    """Enable ULFM fault tolerance on a P2P communicator (idempotent per
    transport; the detector thread is shared).  Process worlds default to
    heartbeat files under the rendezvous dir (``rdv_dir`` or the
    launcher's ``MPI_TPU_RDV``); the local thread world passes the shared
    :class:`MemoryLiveness` (``run_local`` does)."""
    if getattr(comm, "_ft", None) is not None:
        return comm
    world = getattr(comm._t, "_ft_world", None)
    if world is None:
        if liveness is None:
            rdv = rdv_dir or os.environ.get("MPI_TPU_RDV")
            if rdv is None:
                raise ValueError(
                    "fault tolerance needs a liveness substrate: pass "
                    "liveness= (in-process worlds) or rdv_dir= / set "
                    "MPI_TPU_RDV (process worlds)")
            liveness = FileLiveness(rdv, comm._t.world_rank)
        world = WorldFT(
            comm._t, liveness,
            _DETECT_TIMEOUT_S if detect_timeout_s is None else detect_timeout_s,
            _HEARTBEAT_S if heartbeat_s is None else heartbeat_s)
        comm._t._ft_world = world
    comm._ft = CommFT(world, comm._ctx)
    return comm


# -- fault-tolerant agreement (the shrink/agree engine) ----------------------


def _agreement(comm, tag: int, value: bool) -> Tuple[int, bool]:
    """Lockstep iterated exchange among the ranks of ``comm`` not yet
    believed dead: each round every participant sends its (view, value)
    to every other and collects one message from each, OR-ing views
    (comm-rank bitmasks) and AND-ing values.  A peer that times out past
    the bound, is detector-flagged or fails a send joins the view.  Ends
    after two consecutive clean rounds; returns (view, AND).

    Runs on the RAW transport, below the revocation check: shrink and
    agree must work on a revoked communicator."""
    ft = comm._ft
    p, r = comm.size, comm.rank
    epoch = ft.next_epoch(tag)
    view = 0
    for cr in comm.get_failed():
        view |= 1 << cr
    value = bool(value)
    clean = 0
    rnd = 0
    while clean < 2:
        rnd += 1
        sent_view, sent_value = view, value
        live = [q for q in range(p) if q != r and not (view >> q) & 1]
        for q in live:
            try:
                comm._t.send(comm._group[q], comm._ctx, tag,
                             (epoch, rnd, view, value))
            except (TransportError, ValueError) as e:
                view |= 1 << q
                ft.world.observe(comm._group[q],
                                 f"send failed during agreement: {e}")
        all_equal = True
        for q in live:
            got = _agreement_recv(comm, q, tag, epoch, rnd)
            if got is None:
                view |= 1 << q
                all_equal = False
                continue
            pview, pval = got
            view |= pview
            value = value and pval
            if pview != sent_view or pval != sent_value:
                all_equal = False
        clean = clean + 1 if (view == sent_view and all_equal) else 0
    return view, value


def _agreement_recv(comm, peer: int, tag: int, epoch: int,
                    rnd: int) -> Optional[Tuple[int, bool]]:
    """One agreement message from comm rank ``peer``: a sliced wait that
    gives up (None: the peer joins the view) when the detector flags the
    peer or the bounded deadline passes.  Stale epochs (a dead rank's
    leftovers) are discarded; a FUTURE epoch means the agreements were
    not issued in the same order on every rank, and raises."""
    ft = comm._ft
    peer_world = comm._group[peer]
    deadline = time.monotonic() + max(3.0 * ft.world.detect_timeout_s, 2.0)
    while True:
        # message first, suspicion second: a message that already arrived
        # from a falsely suspected peer must never be dropped
        try:
            payload, _, _ = comm._t.recv(peer_world, comm._ctx, tag,
                                         timeout=POLL_S)
        except RecvTimeout:
            if peer_world in ft.world.failed:
                return None
            if time.monotonic() > deadline:
                # overdue joins THIS agreement's view only: a protocol
                # timeout is weak evidence, kept out of the world's
                # failed set
                return None
            continue
        except TransportError:
            return None  # transport torn down: the peer is unreachable
        got_epoch, got_rnd, pview, pval = payload
        if got_epoch < epoch:
            continue  # stale leftover
        if got_epoch > epoch:
            raise RuntimeError(
                f"agreement epoch skew from rank {peer}: got {got_epoch}, "
                f"expected {epoch} (agreements must be issued in the same "
                f"order on every rank)")
        if got_rnd != rnd:
            continue
        return int(pview), bool(pval)


def failed_comm_ranks(comm) -> List[int]:
    """Comm ranks of ``comm`` currently believed dead (sorted)."""
    ft = getattr(comm, "_ft", None)
    if ft is None:
        return []
    failed_world = ft.world.failed_snapshot() & set(comm._group)
    return sorted(comm._group.index(w) for w in failed_world)
