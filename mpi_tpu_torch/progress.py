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
  lock.

The engine thread binds its world's device before its first launch (a
completion may refill a user buffer; a callback sends, which clones on
the card) and launches on the device's default stream, the host layer's
one stream: host order stays launch order.

Off (``progress="none"``, the default) the whole feature is one
``_progress is None`` attribute test per operation and the
``progress_*`` pvars stay 0.  The runtime verifier's stalled-poll
publication (the reference's :262, :337, :453) is not ported yet
(ROADMAP item 16.2b).

Enable: ``MPI_TPU_PROGRESS=thread`` (read by ``mpi_tpu_torch.init``),
``run(..., backend="local", progress="thread")``, the launcher's
``--progress thread``, or the ``progress`` cvar.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from . import mpit as _mpit
from .transport.base import TransportError, bind_thread_device

# Accepted modes of the ``progress`` cvar / MPI_TPU_PROGRESS /
# run(progress=...) / launcher --progress.
MODES = ("none", "thread")

# Process-wide default mode (cvar ``progress``).
_DEFAULT_MODE = "none"

# Longest idle park between passes: bounds how stale the engine's view of
# newly posted requests can be even if the doorbell never rings.
_PARK_SLICE_S = 0.25


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
            if head._on_complete is not None:
                cbs.append(head._on_complete)
        return cbs

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
                        if head._on_complete is not None:
                            cbs.append(head._on_complete)
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
            if self._stop.is_set():
                return
            try:
                if not self.t.progress_park(_PARK_SLICE_S):
                    _mpit.count(progress_idle_parks=1)
            except TransportError:
                return
