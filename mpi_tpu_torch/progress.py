"""Dedicated progress engine — background completion for nonblocking
operations — the port's own copy of ``mpi_tpu/progress.py``:
``resolve_mode`` (:100), ``enable`` (:113) and ``ProgressEngine`` (:127).

Without it, a nonblocking operation progresses only while some caller
thread polls or waits: a posted ``irecv`` never completes until somebody
calls ``wait``/``test``, and the segmented engine's send window advances
only inside the blocking call.  ``progress="thread"`` starts ONE daemon
thread per world (attached to the transport) that

* parks on the transport's doorbell (``Transport.progress_park``, the
  shared Mailbox condition: socket reader threads and local-world peer
  sends ring it) instead of spinning;
* completes the posted ``_RecvRequest``s of the communicators with
  receives posted under the engine's completion lock (the one lock that
  serializes engine-side and caller-side completion), so ``req._done``
  flips without the caller.  A pass visits only the communicators that
  posted since the last pass and those whose context received messages
  since then (``Mailbox.take_dirty``): each nonblocking collective has a
  communicator of its own, and a thousand of them in flight must not
  make every pass a thousand long (the reference scans every registered
  communicator and, in each, the whole mailbox);
* runs each completed receive's ``_on_complete`` callback — the
  segmented engine's send-window credit (``communicator._SegSender``) and
  the nonblocking collectives' state machines (``nbc.py``) — outside the
  lock;
* is the runtime verifier's blocking waiter for pure-polling drain loops
  (:262, :337, :453): a rank spinning on ``test()`` never enters a
  blocking wait, so the engine observes the sustained empty polls,
  publishes an OR-set entry over the pending sources on the rank's
  behalf, runs the wait-for analysis, and parks the resulting
  ``DeadlockError`` where the polling paths re-raise it.  The pending
  set is, most exact first, the poll scope ``api.MPI_Waitany`` installs
  (``enter_poll_scope`` / ``exit_poll_scope``, :203, :214), the polled
  state machine's, or the union over the tracked requests.

The engine thread binds its world's device before its first launch (a
completion may refill a user buffer; a callback sends, which clones on
the card) and launches on the device's default stream, the host layer's
one stream: host order stays launch order.

Off (``progress="none"``, the default) the whole feature is one
``_progress is None`` attribute test per operation and the
``progress_*`` pvars stay 0.

Enable: ``MPI_TPU_PROGRESS=thread`` (read by ``mpi_tpu_torch.init``),
``run(..., backend="local", progress="thread")``, the launcher's
``--progress thread``, or the ``progress`` cvar.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

from . import mpit as _mpit
from .transport.base import ANY_SOURCE, TransportError, bind_thread_device

# Accepted modes of the ``progress`` cvar / MPI_TPU_PROGRESS /
# run(progress=...) / launcher --progress.
MODES = ("none", "thread")

# Process-wide default mode (cvar ``progress``).
_DEFAULT_MODE = "none"

# Longest idle park between passes: bounds how stale the engine's view of
# newly posted requests can be even if the doorbell never rings.
_PARK_SLICE_S = 0.25

# A pure-polling episode is live while the newest empty poll is at most
# this old: a caller that stopped polling stops being published within
# one slice (an opportunistic poll between real work is no blocked rank).
_POLL_FRESH_S = 1.0


def resolve_mode(explicit: Optional[str] = None) -> str:
    """The mode a new world runs: the explicit argument beats
    MPI_TPU_PROGRESS beats the ``progress`` cvar."""
    mode = explicit or os.environ.get("MPI_TPU_PROGRESS") or _DEFAULT_MODE
    if mode not in MODES:
        raise ValueError(
            f"unknown progress mode {mode!r}; accepted: {list(MODES)}")
    return mode


def enable(comm):
    """Attach the per-world progress engine to ``comm`` (idempotent per
    transport: one engine, one thread, shared by every communicator
    derived from the transport; children created later pick it up at
    construction)."""
    eng = getattr(comm._t, "_progress_engine", None)
    if eng is None:
        eng = ProgressEngine(comm._t)
        comm._t._progress_engine = eng
    comm._progress = eng
    eng.register(comm)
    return comm


class ProgressEngine:
    """One background progress thread per world (per Transport).

    ``self.cv`` serializes ALL request completion: the engine's pass and
    the callers' ``try_complete`` both hold it around the
    poll-and-complete step, so a message is never consumed twice and a
    request never completed by two threads.  Completion callbacks run
    OUTSIDE the lock: a callback may block in a send."""

    def __init__(self, transport) -> None:
        self.t = transport
        self.cv = threading.Condition(threading.RLock())
        # communicators with posted receives by context (ctx -> {id:
        # comm}), and those that posted since the last pass; under a small
        # lock of their own, so posting never waits behind a pass
        self._active: Dict[object, Dict[int, object]] = {}
        self._fresh: Dict[int, object] = {}
        self._active_lock = threading.Lock()
        self._stop = threading.Event()
        # sticky verifier verdict of a stalled-poll analysis, re-raised by
        # the polling completion paths (a deadlock is permanent)
        self.pending_error: Optional[BaseException] = None
        # pure-polling episode state; _poll_req is the state-machine
        # collective the freshest empty poll was for (weakly held)
        self._last_empty_poll = 0.0
        self._poll_req: Optional["weakref.ref"] = None
        # the request list of the MPI_Waitany / Waitsome call polling now
        self._poll_scope: Optional[tuple] = None
        self._episode_start: Optional[float] = None
        self._episode_block = 0
        self._published = False
        self.thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"mpi-tpu-torch-progress-{transport.world_rank}")
        self.thread.start()

    def register(self, comm) -> None:
        """Note a communicator with posted receives for the next pass.
        Called after each post (the request is in its queue by then, so a
        pass that finds the queues empty and drops the communicator
        cannot lose it)."""
        with self._active_lock:
            self._active.setdefault(comm._ctx, {})[id(comm)] = comm
            self._fresh[id(comm)] = comm

    def note_empty_poll(self, req=None) -> None:
        """A nonblocking completion path came up empty: the evidence a
        pure-polling drain loop exists.  ``req`` (a state-machine
        collective, ``nbc.py``) names which call is polled, so its exact
        pending OR-set is published instead of the union over every
        tracked request."""
        self._last_empty_poll = time.monotonic()
        self._poll_req = None if req is None else weakref.ref(req)

    def enter_poll_scope(self, requests):
        """Scope stalled-poll publication to ONE drain call's request set
        (``MPI_Waitany`` / ``Waitsome``): while it is installed, a
        published 'waitany-poll' entry's OR-set is these requests'
        pending sources only, not the union over every tracked request.
        Returns the previous scope, for nested drains to restore."""
        prev = self._poll_scope
        self._poll_scope = tuple(requests)
        return prev

    def exit_poll_scope(self, prev) -> None:
        self._poll_scope = prev

    def check_error(self) -> None:
        if self.pending_error is not None:
            raise self.pending_error

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the engine and its fold pool and join their threads
        (bounded): at interpreter exit no helper thread may still be
        inside a torch call."""
        self._stop.set()
        with self.cv:
            self.cv.notify_all()
        # the nonblocking-collective fold pool (nbc.py) is engine-owned:
        # its workers die with the engine
        pool = getattr(self.t, "_nbc_fold_pool", None)
        if pool is not None:
            self.t._nbc_fold_pool = None
            pool.stop(timeout)
        try:
            self.t.mailbox.nudge()  # pop the thread out of its park
        except Exception:  # noqa: BLE001 - teardown best effort
            pass
        if self.thread is not threading.current_thread():
            self.thread.join(timeout)

    def try_complete(self, req) -> List:
        """Caller-side completion attempt for ``req``'s queue: complete
        posted requests head-first (posted-order matching) while the
        transport has matching traffic.  Caller holds ``self.cv``.
        Returns the callbacks to run after releasing it."""
        cbs: List = []
        q = req._queue
        while not req._done and q:
            head = q[0]
            hit = head._poll_once()
            if hit is None:
                break
            head._complete(hit[0])
            self._note_complete(head, cbs)
        return cbs

    @staticmethod
    def _note_complete(req, cbs: List) -> None:
        vw = getattr(req._comm._t, "_verify_world", None)
        if vw is not None:
            # a background completion is real progress: a published
            # 'blocked' or 'polling' entry retracts promptly
            vw.note_progress()
        if req._on_complete is not None:
            cbs.append(req._on_complete)

    def _complete_pass(self) -> Tuple[List, int]:
        """One pass over the posted queues of the communicators that
        posted since the last pass or whose context received messages;
        returns (callbacks, completed count)."""
        cbs: List = []
        done = 0
        idle = []
        dirty = self.t.mailbox.take_dirty()
        with self._active_lock:
            visit = dict(self._fresh)
            self._fresh.clear()
            for ctx in dirty:
                visit.update(self._active.get(ctx, ()))
        comms = list(visit.values())
        with self.cv:
            for comm in comms:
                with comm._lock:
                    queues = [q for q in comm._irecv_queues.values() if q]
                if not queues:
                    idle.append(comm)
                for q in queues:
                    while q:
                        head = q[0]
                        hit = head._poll_once()
                        if hit is None:
                            break
                        head._complete(hit[0])
                        self._note_complete(head, cbs)
                        done += 1
            if done:
                self.cv.notify_all()
        if idle:
            with self._active_lock:
                for comm in idle:
                    # re-checked under the lock a post's register takes
                    if not any(comm._irecv_queues.values()):
                        same = self._active.get(comm._ctx, {})
                        same.pop(id(comm), None)
                        if not same:
                            self._active.pop(comm._ctx, None)
        return cbs, done

    def _loop(self) -> None:
        bind_thread_device(self.t.device)
        while not self._stop.is_set():
            try:
                cbs, done = self._complete_pass()
            except TransportError:
                return  # transport closed under us: the world is exiting
            _mpit.count(progress_wakeups=1, progress_completions=done)
            for cb in cbs:
                # credit-window sends and state-machine kicks; their
                # failures are recorded where the caller re-raises them
                cb()
            if done:
                continue  # drained something: look again at once
            self._maybe_publish_stalled(time.monotonic())
            if self._stop.is_set():
                return
            try:
                if not self.t.progress_park(_PARK_SLICE_S):
                    _mpit.count(progress_idle_parks=1)
            except TransportError:
                return

    # -- verifier publication on behalf of pure-polling drain loops --------

    def _pending_tracked(self) -> List[Tuple[object, object]]:
        """(comm, request) of every posted, incomplete USER-level request
        (those with a verifier record): the wait set of a polling drain
        loop.  Only communicators with posted receives can hold one.
        Caller holds ``self.cv``."""
        with self._active_lock:
            comms = [c for same in self._active.values()
                     for c in same.values()]
        out = []
        for comm in comms:
            with comm._lock:
                queues = [q for q in comm._irecv_queues.values() if q]
            for q in queues:
                for req in list(q):
                    if req._vinfo is not None:
                        out.append((comm, req))
        return out

    def _maybe_publish_stalled(self, now: float) -> None:
        vw = getattr(self.t, "_verify_world", None)
        if vw is None or self.pending_error is not None:
            return
        if vw.active_waiters > 0:
            # a REAL blocking wait owns the rank's board entry: two
            # publishers alternating entries would flap the stamps
            self._end_episode(vw)
            return
        if now - self._last_empty_poll > _POLL_FRESH_S:
            # nobody is polling (computing, or gave up): an idle posted
            # irecv proves nothing about being stuck
            self._end_episode(vw)
            return
        # pending-set evidence, most exact first: the installed poll scope
        # (MPI_Waitany's own request list), the freshest poll's own state
        # machine, the union over the tracked posted requests
        sm = None
        scope_info = None
        scope = self._poll_scope
        if scope is not None:
            with self.cv:  # serialize the _done reads with completion
                live = [r for r in scope
                        if not getattr(r, "_retired", False)
                        and not getattr(r, "_done", False)
                        and getattr(r, "_error", None) is None]
                scope_targets = set()
                for r in live:
                    if hasattr(r, "_pending_world_srcs"):
                        scope_targets.update(r._pending_world_srcs())
                    elif hasattr(r, "_source"):
                        c = r._comm
                        if r._source == ANY_SOURCE:
                            scope_targets.update(
                                w for w in c._group if w != c._t.world_rank)
                        else:
                            scope_targets.add(c._world(r._source))
            if not scope_targets:
                self._end_episode(vw)
                return
            scope_info = (live, scope_targets)
        if scope_info is None:
            ref = self._poll_req
            if ref is not None:
                cand = ref()
                if (cand is not None and not cand._done
                        and cand._error is None):
                    sm = cand
                else:
                    self._poll_req = None
            if sm is not None:
                with self.cv:  # serialize the _done reads with completion
                    sm_targets = sm._pending_world_srcs()
                if not sm_targets:
                    self._end_episode(vw)
                    return
            else:
                with self.cv:
                    pending = self._pending_tracked()
                if not pending:
                    self._end_episode(vw)
                    return
        if self._episode_start is None:
            self._episode_start = now
            self._episode_block = vw.begin_block()
            return
        if now - self._episode_start < vw.stall_timeout_s:
            return
        if scope_info is not None:
            live, targets = scope_info
            anchor = next((r for r in live if hasattr(r, "_comm")), None)
            if anchor is None:
                return
            comm = anchor._comm
            tag = getattr(anchor, "_tag", -1)  # ANY_TAG when unknowable
            coll = getattr(anchor, "kind", None)
            site = "<waitany drain>"
            for r in live:
                vi = getattr(r, "_vinfo", None)
                if vi is not None and vi.site:
                    site = vi.site
                    break
        elif sm is not None:
            comm, tag, coll = sm._comm, sm._tag, sm.kind
            site = f"<nbc:{sm.kind} state machine>"
            targets = set(sm_targets)
        else:
            comm, first = pending[0]
            tag, coll = first._tag, None
            site = (first._vinfo.site if first._vinfo is not None
                    else "<polling loop>")
            targets = set()
            for c, req in pending:
                if req._source == ANY_SOURCE:
                    targets.update(w for w in c._group
                                   if w != c._t.world_rank)
                else:
                    targets.add(c._world(req._source))
        if not targets:
            return
        if vw.published and not self._published:
            # a real blocking wait owns the board entry and its cadence
            return
        from .verify import deadlock as _vdl

        self._published = True
        try:
            # OR semantics: ANY pending source progressing releases the
            # drain loop; the engine IS this rank's blocking waiter
            _vdl.check_stalled(
                vw, comm, tuple(sorted(targets)), "OR", tag,
                "waitany-poll", coll, site, self._episode_block)
        except _vdl.DeadlockError as e:
            self.pending_error = e
            with self.cv:
                self.cv.notify_all()

    def _end_episode(self, vw) -> None:
        if self._published:
            self._published = False
            vw.clear_published()
        self._episode_start = None
