"""MPI-4 previews: persistent collectives and partitioned communication.

The port's own copy of ``mpi_tpu/mpi4.py`` (:1-571), with tensor payloads
on their device.  Where the reference's ``pready`` copies an ndarray
partition on an aliasing transport, the port clones a tensor partition on
its device (``communicator.snapshot_payload``); on the card that clone is
a copy queued on the world's default stream, the host layer's one stream
(``communicator._on_default_stream``): a ``pready`` issued under a side
stream first makes the default stream wait on it, and afterwards the
caller's stream waits on the default one, so a refill of the buffer
right after ``pready`` on the caller's stream lands after the snapshot.
Producer threads may call ``pready`` concurrently; a new thread starts on
the default stream.

Beyond the MPI-3.0 conformance line (api.MPI_Get_version), two MPI-4
features whose shapes fit this framework naturally:

* **Persistent collectives** (MPI_Bcast_init & co. [S: MPI-4 ch.6.11]):
  plan a collective once, ``start()`` it many times.  Each handle owns
  ONE isolated child context (the same deterministic counter scheme as
  nonblocking collectives), so repeated starts can never cross-match —
  and, per MPI, every rank must create and start its persistent
  collectives in the same order.  Buffer CONTENT is read at start time
  (the handle holds references, like send_init).

* **Partitioned point-to-point** (MPI_Psend_init / Precv_init / Pready /
  Parrived [S: MPI-4 ch.4]): one logical message whose partitions are
  contributed (e.g. by different producer threads) and consumed
  independently.  Each matched psend/precv pair gets its own context
  derived from a per-(peer, tag) counter maintained symmetrically on
  both sides — MPI's in-order matching of partitioned inits, spelled as
  context isolation, so concurrent pairs on one (peer, tag) can never
  interleave.  Partitions travel as individual internal messages
  ``(index, payload)``; ``pready(i)`` reads partition ``i`` at call
  time and ships it; ``parrived(i)`` polls without blocking.

* **Sessions** (MPI_Session_init / pset discovery /
  MPI_Group_from_session_pset / MPI_Comm_create_from_group [S: MPI-4
  ch.11]): the modern init story — a library acquires its OWN runtime
  handle, discovers process sets by name, builds a group from a pset,
  and derives a communicator from the group without ever touching
  MPI_Init or MPI_COMM_WORLD.  Here the runtime instance is the
  launcher-provided transport (the same discovery MPI_Init uses);
  sessions share it but derive every communicator on a
  session-namespaced context keyed by the MPI-mandated
  ``(group members, stringtag)`` pair, so session traffic can never
  cross-match world traffic — context isolation IS the session
  boundary, the same scheme nonblocking/persistent collectives use.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

from .communicator import (Communicator, P2PCommunicator, Request,
                           _caller_waits, _on_default_stream, _ThreadRequest,
                           snapshot_payload)

__all__ = [
    "PersistentCollective", "persistent_collective",
    "PsendRequest", "PrecvRequest", "psend_init", "precv_init",
    "Session", "session_init",
]

_TAG_PART = -41  # partitioned traffic (negative: invisible to wildcards)


def _require_p2p(comm, what: str) -> P2PCommunicator:
    if not isinstance(comm, P2PCommunicator):
        raise NotImplementedError(
            f"{what} is a process-backend feature; on the SPMD backend a "
            "collective inside the rank vmap is already a plan (one "
            "program for every rank) — just call it")
    return comm


class PersistentCollective(Request):
    """A planned collective: ``start()`` runs one round on the handle's
    private context; ``wait()``/``test()`` complete the current round."""

    def __init__(self, comm: P2PCommunicator, method: str,
                 args: tuple, kwargs: dict):
        self._comm = comm._nbc_comm()  # one private context for all rounds
        self._method = method
        self._args, self._kwargs = args, kwargs
        self._req: Optional[Request] = None

    def start(self) -> "PersistentCollective":
        if self._req is not None and not self._req.test()[0]:
            raise RuntimeError(
                "start() while the previous round of this persistent "
                "collective is still in flight (wait() it first)")
        fn = getattr(self._comm, self._method)
        dev = self._comm.device
        with _on_default_stream(dev):
            self._req = _ThreadRequest(
                lambda: fn(*self._args, **self._kwargs), dev)
        return self

    def wait(self) -> Any:
        if self._req is None:
            raise RuntimeError("wait() before start() on a persistent "
                               "collective")
        return self._req.wait()

    def test(self) -> Tuple[bool, Any]:
        if self._req is None:
            return False, None
        return self._req.test()


def persistent_collective(comm: Communicator, method: str, *args: Any,
                          **kwargs: Any):
    """Generic MPI_*_init for collectives: ``method`` is the Communicator
    method name ('bcast', 'allreduce', 'reduce', 'allgather', 'alltoall',
    'barrier', ...).  The plannable kinds (allreduce/bcast/alltoall/
    reduce_scatter) return the engine-owned handle (``nbc.py``): compiled
    schedule, hoisted child context + tuned-table
    resolution + verifier signature, zero-thread ``start()`` re-fires on
    progress-engine worlds; everything else keeps the generic
    one-thread-per-round handle with identical start/wait discipline."""
    c = _require_p2p(comm, "persistent collectives")
    if not callable(getattr(c, method, None)):
        raise ValueError(f"unknown collective method {method!r}")
    from . import nbc as _nbc

    if method in _nbc.PERSISTENT_KINDS:
        return _nbc.persistent_init(c, method, *args, **kwargs)
    return PersistentCollective(c, method, args, kwargs)


# -- partitioned point-to-point ---------------------------------------------


def _pair_ctx_comm(comm: P2PCommunicator, peer: int, tag: int,
                   side_counter: str) -> P2PCommunicator:
    """A private context for ONE matched psend/precv pair.  Both sides
    advance a per-(peer, tag) counter at init time, so the k-th
    psend_init(dest, tag) matches the k-th precv_init(source, tag) —
    MPI's in-order matching, enforced structurally."""
    with comm._lock:
        table = comm.__dict__.setdefault(side_counter, {})
        k = table.get((peer, tag), 0)
        table[(peer, tag)] = k + 1
    return P2PCommunicator(comm._t, comm._group,
                           (comm._ctx, "part", tag, k),
                           recv_timeout=comm.recv_timeout)


class PsendRequest:
    """Sender side of a partitioned send (MPI_Psend_init)."""

    def __init__(self, comm: P2PCommunicator, buf: Any, partitions: int,
                 dest: int, tag: int):
        if partitions < 1:
            raise ValueError(f"partitions must be >= 1, got {partitions}")
        self._c = _pair_ctx_comm(comm, dest, tag, "_psend_counters")
        self._buf = buf
        self._n = int(partitions)
        self._dest = dest
        self._active = False
        self._ready: set = set()
        self._lock = threading.Lock()

    def start(self) -> "PsendRequest":
        with self._lock:
            if self._active:
                raise RuntimeError("start() on an active partitioned send "
                                   "(wait() the previous round first)")
            self._active = True
            self._ready = set()
        return self

    def pready(self, i: int) -> None:
        """Mark partition ``i`` ready: its CURRENT content ships now.
        Thread-safe — different producer threads may ready different
        partitions (the MPI-4 use case)."""
        with self._lock:
            if not self._active:
                raise RuntimeError("pready() outside an active round "
                                   "(call start() first)")
            if not (0 <= i < self._n):
                raise ValueError(f"partition {i} out of range "
                                 f"(0..{self._n - 1})")
            if i in self._ready:
                raise RuntimeError(f"partition {i} already marked ready "
                                   "this round")
            # send INSIDE the lock: marking ready and enqueueing must be
            # atomic, or a racing test()/start() could begin the next
            # round and enqueue ITS sends first, and FIFO would then hand
            # the receiver a next-round payload inside this round.
            # Snapshot rules shared with PersistentRequest.start
            # (communicator.snapshot_payload); on the card the snapshot is
            # queued on the default stream and the caller's stream waits
            # on it before any refill
            dev = self._c.device
            with _on_default_stream(dev):
                part = snapshot_payload(self._c._t, self._buf[i])
                self._c._send_internal((int(i), part), self._dest, _TAG_PART)
            _caller_waits(dev)
            self._ready.add(i)

    def pready_range(self, lo: int, hi: int) -> None:
        """MPI_Pready_range marks ``lo``..``hi`` INCLUSIVE [S: MPI-4]."""
        for i in range(lo, hi + 1):
            self.pready(i)

    def wait(self) -> None:
        """Complete the round; every partition must have been readied
        (a silent partial send would deadlock the receiver)."""
        with self._lock:
            if not self._active:
                raise RuntimeError("wait() outside an active round")
            missing = [i for i in range(self._n) if i not in self._ready]
            if missing:
                raise RuntimeError(
                    f"wait() with partitions never marked ready: "
                    f"{missing[:8]}{'...' if len(missing) > 8 else ''} — "
                    "the receiver would block forever")
            self._active = False  # sends are buffered: complete on enqueue

    def test(self) -> Tuple[bool, Any]:
        """MPI semantics: an inactive request tests True; a completed
        test DEACTIVATES the round (like wait), so start() may follow."""
        with self._lock:
            if not self._active:
                return True, None
            if len(self._ready) == self._n:
                self._active = False
                return True, None
            return False, None


class PrecvRequest:
    """Receiver side (MPI_Precv_init): partitions complete independently;
    ``parrived(i)`` polls, ``wait()`` assembles the full message."""

    def __init__(self, comm: P2PCommunicator, partitions: int,
                 source: int, tag: int):
        if partitions < 1:
            raise ValueError(f"partitions must be >= 1, got {partitions}")
        self._c = _pair_ctx_comm(comm, source, tag, "_precv_counters")
        self._n = int(partitions)
        self._source = source
        self._got: Dict[int, Any] = {}
        self._active = False
        self._result: Optional[List[Any]] = None
        self._lock = threading.Lock()  # consumer threads poll concurrently

    def start(self) -> "PrecvRequest":
        with self._lock:
            if self._active:
                raise RuntimeError("start() on an active partitioned recv")
            self._active = True
            self._got = {}
            self._result = None
        return self

    def _drain_nowait_locked(self) -> None:
        # caller holds self._lock.  Bounded to THIS round's partition
        # count: an unbounded (or un-serialized, with concurrent
        # consumer threads) drain would steal the sender's next-round
        # messages, corrupting this round and deadlocking the next
        # (the receiver's next round would then deadlock)
        while len(self._got) < self._n:
            hit = self._c._t.poll(self._c._world(self._source),
                                  self._c._ctx, _TAG_PART)
            if hit is None:
                return
            (i, part), _, _ = hit
            self._got[i] = part

    def parrived(self, i: int) -> bool:
        """MPI_Parrived: has partition ``i`` landed? (non-blocking;
        thread-safe — consumer threads may poll concurrently)"""
        if not (0 <= i < self._n):
            raise ValueError(f"partition {i} out of range (0..{self._n - 1})")
        with self._lock:
            if not self._active:
                raise RuntimeError("parrived() outside an active round")
            self._drain_nowait_locked()
            return i in self._got

    def partition(self, i: int) -> Any:
        """Partition ``i``'s payload (must have arrived)."""
        if not self.parrived(i):
            raise RuntimeError(f"partition {i} has not arrived yet")
        with self._lock:
            return self._got[i]

    def wait(self) -> List[Any]:
        """Block until every partition landed; returns them in partition
        order (stacked by the caller if desired).  After a successful
        test() completed the round, wait() returns the same result."""
        import time

        with self._lock:
            if not self._active:
                if self._result is not None:
                    return self._result
                raise RuntimeError("wait() outside an active round")
        # poll under the lock rather than blocking in transport recv: a
        # concurrent parrived() could consume the last missing message
        # and leave a blocking recv stuck waiting for (and then
        # stealing) a NEXT-round message
        timeout = self._c.recv_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                self._drain_nowait_locked()
                if len(self._got) >= self._n:
                    return self._finish_locked()
                missing = [i for i in range(self._n) if i not in self._got]
            if deadline is not None and time.monotonic() > deadline:
                from .transport.base import RecvTimeout

                raise RecvTimeout(
                    f"partitioned recv: partitions {missing[:8]} from rank "
                    f"{self._source} never arrived within {timeout}s")
            time.sleep(0.0005)

    def _finish_locked(self) -> List[Any]:
        # caller holds self._lock
        self._active = False
        self._result = [self._got[i] for i in range(self._n)]
        return self._result

    def test(self) -> Tuple[bool, Any]:
        """Inactive tests True; completion DEACTIVATES the round and
        caches the assembled result for a subsequent wait()."""
        with self._lock:
            if not self._active:
                return True, self._result
            self._drain_nowait_locked()
            if len(self._got) == self._n:
                return True, self._finish_locked()
            return False, None


# -- sessions (MPI-4 ch.11) ---------------------------------------------------

# generation counters for comm_create_from_group contexts, keyed by
# (calling world rank, world_ranks, stringtag) — module-global (NOT
# per-Session: context isolation must hold across sessions) but
# rank-scoped via the key, so thread-backed ranks sharing one process
# count independently (see Session.comm_create_from_group).
#
# All three tables are guarded by _CFG_LOCK (a bare get-then-set races
# under MPI_THREAD_MULTIPLE: two threads could claim the same generation
# and silently cross-match traffic).  _CFG_IN_FLIGHT
# holds keys whose creation is between generation claim and communicator
# wiring: a second creation with an identical key inside that window is
# the "concurrent calls with an identical (group, stringtag) pair" case
# MPI-4 §11.6 declares erroneous, and it now raises instead of handing
# out a generation whose cross-rank ordering is undefined.  _CFG_LIVE
# refcounts, per key, the sessions that created under it; a key's
# generation counter is pruned when the LAST such session finalizes
# (its communicators must already be out of use per MPI-4, so restarting
# at generation 0 cannot collide with live traffic — while any sharing
# session is still live the counter survives).
_CFG_GENERATIONS: Dict[Tuple, int] = {}
_CFG_IN_FLIGHT: set = set()
_CFG_LIVE: Dict[Tuple, int] = {}
_CFG_LOCK = threading.Lock()


def _cfg_prune(keys) -> None:
    """Drop one session's refcount on each of ``keys``; forget generation
    counters whose last holder is gone (session-finalize prune)."""
    with _CFG_LOCK:
        for key in keys:
            n = _CFG_LIVE.get(key, 0) - 1
            if n <= 0:
                _CFG_LIVE.pop(key, None)
                _CFG_GENERATIONS.pop(key, None)
            else:
                _CFG_LIVE[key] = n


def _cfg_prune_all() -> None:
    """World-finalize prune of counters no LIVE session still holds.

    Finalizing the process world must not clear keys of unfinalized
    sessions on OTHER worlds (run_local thread worlds take any
    base_comm) — restarting their counters at generation 0 could
    collide with a still-open communicator's context.  Sessions that
    were garbage-collected without finalize() drop out of the weak
    registry, so exactly the leaked keys get swept here."""
    with _CFG_LOCK:
        held = set()
        for sess in list(_LIVE_SESSIONS):
            if not sess._finalized:
                held.update(sess._cfg_keys)
        for key in [k for k in _CFG_GENERATIONS if k not in held]:
            _CFG_GENERATIONS.pop(key, None)
            _CFG_LIVE.pop(key, None)
        _CFG_IN_FLIGHT.difference_update(
            k for k in list(_CFG_IN_FLIGHT) if k not in held)


_LIVE_SESSIONS: "weakref.WeakSet" = weakref.WeakSet()


class Session:
    """An MPI-4 session: a private handle to the runtime.

    Construct via :func:`session_init`.  The world process model and the
    sessions model coexist (MPI-4 §11.4): both tap the same underlying
    transport, but a session never touches the COMM_WORLD singleton and
    all communicators it derives live on session-namespaced contexts.

    ``base_comm`` injects the runtime access explicitly (how the local
    thread backend's per-rank sessions are built — and how tests drive
    multi-rank sessions); by default the launcher-provided environment
    is discovered exactly as ``MPI_Init`` would.
    """

    #: the two predefined process sets every session exposes (MPI-4
    #: §11.9.2; additional runtime-defined psets would list after these)
    _PSETS = ("mpi://WORLD", "mpi://SELF")

    def __init__(self, info: Optional[dict] = None, errhandler=None,
                 base_comm: Optional[P2PCommunicator] = None):
        if base_comm is None:
            from . import init

            base_comm = init()
        self._base = _require_p2p(base_comm, "sessions")
        self._info = dict(info or {})
        self._errhandler = errhandler
        self._finalized = False
        # comm_create_from_group keys this session holds live (with
        # multiplicity) — released at finalize, see _cfg_prune
        self._cfg_keys: List[Tuple] = []
        _LIVE_SESSIONS.add(self)

    # -- pset discovery ----------------------------------------------------

    def get_num_psets(self, info: Optional[dict] = None) -> int:
        """MPI_Session_get_num_psets."""
        self._check_live()
        return len(self._PSETS)

    def get_nth_pset(self, n: int, info: Optional[dict] = None) -> str:
        """MPI_Session_get_nth_pset."""
        self._check_live()
        if not (0 <= n < len(self._PSETS)):
            raise ValueError(
                f"pset index {n} out of range (0..{len(self._PSETS) - 1})")
        return self._PSETS[n]

    def get_info(self) -> dict:
        """MPI_Session_get_info (hints echoed back; advisory)."""
        self._check_live()
        return dict(self._info)

    # -- group / communicator derivation -----------------------------------

    def group_from_pset(self, pset_name: str):
        """MPI_Group_from_session_pset: the ordered member set of the
        named pset, as a Group of runtime (world) ranks."""
        self._check_live()
        from .group import Group

        if pset_name == "mpi://WORLD":
            return Group(range(self._base.size))
        if pset_name == "mpi://SELF":
            return Group([self._base.rank])
        raise ValueError(
            f"unknown process set {pset_name!r}; this session has "
            f"{list(self._PSETS)}")

    def comm_create_from_group(self, group, stringtag: str = "",
                               info: Optional[dict] = None,
                               errhandler=None) -> P2PCommunicator:
        """MPI_Comm_create_from_group: a communicator over ``group``
        (runtime ranks, in group order) — collective over the GROUP
        MEMBERS only, no parent communicator involved.  Matching follows
        MPI-4: concurrent calls are disambiguated by the
        ``(group members, stringtag)`` pair; every member must pass the
        same group and stringtag, and CONCURRENT calls with an
        identical pair are erroneous.

        SEQUENTIAL calls with the same pair are legal and must yield
        ISOLATED communicators (a static context would cross-match their
        traffic, e.g. a stale unmatched isend on the
        first comm received by the second).  A per-RANK generation
        counter keyed by (calling world rank, world_ranks, stringtag)
        is mixed into the context: every member participates in every
        creation with this key, creations with one key are ordered
        (they are collectives over the same members, and concurrent
        identical pairs are erroneous per MPI-4), so each member's Nth
        call counts N on its own key — the contexts agree across
        members with no extra traffic, and repeated creations get
        distinct contexts.  The calling rank must be part of the KEY
        but not the context: on the threaded local backend all ranks
        share one process, so a process-global counter would advance
        once per MEMBER and disagree across ranks."""
        self._check_live()
        ranks = tuple(int(r) for r in group.ranks)
        if self._base.rank not in ranks:
            raise ValueError(
                f"calling rank {self._base.rank} is not in the group "
                f"{list(ranks)} (comm_create_from_group is collective "
                f"over the group members themselves)")
        # group ranks are BASE-comm-local (what group_from_pset hands
        # out); the transport speaks world ranks — translate, so a base
        # comm that is itself a split/reordered view of the world still
        # derives a correctly-wired communicator.  The
        # context must also be spelled in world ranks: it has to be
        # byte-identical across member processes whose local numbering
        # may differ.
        world_ranks = tuple(self._base._world(r) for r in ranks)
        key = (self._base._t.world_rank, world_ranks, str(stringtag))
        with _CFG_LOCK:
            if key in _CFG_IN_FLIGHT:
                raise RuntimeError(
                    f"concurrent MPI_Comm_create_from_group calls with an "
                    f"identical (group={list(ranks)}, "
                    f"stringtag={str(stringtag)!r}) pair on rank "
                    f"{self._base.rank} — erroneous per MPI-4 §11.6: "
                    f"identical concurrent creations cannot be matched "
                    f"across members (disambiguate with distinct "
                    f"stringtags, or order the calls)")
            _CFG_IN_FLIGHT.add(key)
            gen = _CFG_GENERATIONS.get(key, 0)
            _CFG_GENERATIONS[key] = gen + 1
            _CFG_LIVE[key] = _CFG_LIVE.get(key, 0) + 1
            self._cfg_keys.append(key)
        try:
            return P2PCommunicator(
                self._base._t, world_ranks,
                context=("sess", world_ranks, str(stringtag), gen),
                recv_timeout=self._base.recv_timeout)
        finally:
            with _CFG_LOCK:
                _CFG_IN_FLIGHT.discard(key)

    # -- lifecycle ---------------------------------------------------------

    def finalize(self) -> None:
        """MPI_Session_finalize: the session handle becomes unusable.
        Communicators derived from it must already be out of use (MPI
        erroneous otherwise); the shared runtime transport is NOT closed
        — it belongs to the process (world model finalize / launcher
        teardown owns it).  Generation counters this session held are
        released (and forgotten once no live session shares them), so
        long-running processes that churn sessions don't grow the
        module-global table without bound."""
        if not self._finalized:
            self._finalized = True
            keys, self._cfg_keys = self._cfg_keys, []
            _cfg_prune(keys)

    @property
    def finalized(self) -> bool:
        return self._finalized

    def _check_live(self) -> None:
        if self._finalized:
            raise RuntimeError("operation on a finalized MPI session")

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.finalize()


def session_init(info: Optional[dict] = None, errhandler=None,
                 base_comm: Optional[P2PCommunicator] = None) -> Session:
    """MPI_Session_init (see :class:`Session`)."""
    return Session(info, errhandler, base_comm)


def psend_init(comm: Communicator, buf: Any, partitions: int, dest: int,
               tag: int = 0) -> PsendRequest:
    """MPI_Psend_init: ``buf[i]`` is partition ``i`` (any indexable —
    a [partitions, ...] array or a list)."""
    return PsendRequest(_require_p2p(comm, "partitioned communication"),
                        buf, partitions, dest, tag)


def precv_init(comm: Communicator, partitions: int, source: int,
               tag: int = 0) -> PrecvRequest:
    return PrecvRequest(_require_p2p(comm, "partitioned communication"),
                        partitions, source, tag)
