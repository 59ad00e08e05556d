"""One-sided communication (MPI RMA) — the port's own copy of
``mpi_tpu/window.py``: ``GetFuture`` (:55), ``_normalize_pairs`` (:78),
the process backends' ``P2PWindow`` (:124) with fence epochs, passive
target (lock/unlock with a per-window server thread), PSCW, the MPI-3
atomics, flush and request-based RMA, and ``DynamicWindow`` (:744).

Epoch semantics (the reference's): operations apply at the closing
``fence()`` in issue order, puts and accumulates before gets, and
``fence()`` is collective.  The SPMD window is ``gpu/window.py``.

A window's buffer is a tensor on its ``init``'s device (a non-tensor
``init`` lands on ``comm.device``): a window over a CUDA tensor keeps its
buffer on the card, and every put, accumulate and atomic applies there,
in issue order, with the accumulate folded as the reference folds it
(``op.combine``, then a store cast to the buffer's dtype).  Op payloads
travel inside the window's pickled control messages.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from . import ops as _ops
from .checker import validate_perm

Pair = Tuple[int, int]

# Internal tags (negative, never matched by a user's ANY_TAG)
_TAG_RMA = -6
_TAG_RMA_REPLY = -7
_TAG_PASSIVE = -8        # origin -> target window server
_TAG_PASSIVE_REPLY = -9  # server -> origin (lock grant / get data / acks)
_TAG_PSCW_POST = -10     # target -> origin: window posted


class GetFuture:
    """Result of ``Window.get``: defined after the closing fence."""

    def __init__(self) -> None:
        self._resolved = False
        self._value: Any = None

    def _resolve(self, value: Any) -> None:
        self._value = value
        self._resolved = True

    @property
    def value(self) -> Any:
        if not self._resolved:
            raise RuntimeError(
                "GetFuture read before the closing fence: one-sided gets "
                "complete at Window.fence() [S: MPI-2 active-target RMA]")
        return self._value

    def wait(self) -> Any:
        return self.value


def _normalize_pairs(pairs, size: int, my_rank: Optional[int] = None,
                     allow_int: bool = False) -> List[Pair]:
    """The pattern form: validate the partial permutation.  The int form
    (process backends only, ``allow_int``): this rank targets ``pairs``."""
    if isinstance(pairs, (int, np.integer)):
        if not allow_int:
            raise TypeError(
                "rank-dynamic RMA (int destination) is only available on the "
                "process backends; the SPMD backend needs the static pattern "
                "form: pairs=[(src, dst), ...]")
        dest = int(pairs)
        if not (0 <= dest < size):
            raise ValueError(f"target rank {dest} out of range for size {size}")
        return [(my_rank, dest)]
    pairs = [(int(s), int(d)) for s, d in pairs]
    validate_perm(pairs, size)
    return pairs


def _owned(init: Any, device) -> torch.Tensor:
    """A window's owned copy of ``init`` (MPI_Win_create memory): a
    tensor's clone on its own device, anything else on ``device``."""
    if isinstance(init, torch.Tensor):
        return init.detach().clone()
    return torch.as_tensor(np.array(init), device=device)


def _array_equal(a: torch.Tensor, b: Any) -> bool:
    """``np.array_equal``: same shape and equal elements."""
    b = torch.as_tensor(b, device=a.device)
    return a.shape == b.shape and bool((a == b).all())


def _store(buf: torch.Tensor, kind: str, data: torch.Tensor, loc: Any,
           op: Optional[_ops.ReduceOp]) -> None:
    """Apply one put or accumulate to ``buf`` (at ``loc`` if given, basic
    indexing): the result is cast to the buffer's dtype on its device."""
    data = torch.as_tensor(data, device=buf.device)
    if kind == "put":
        if loc is None:
            buf[...] = data
        else:
            buf[loc] = data
    elif loc is None:
        buf[...] = torch.as_tensor(op.combine(buf, data), device=buf.device)
    else:
        buf[loc] = torch.as_tensor(op.combine(buf[loc], data),
                                   device=buf.device)


class _RmaRequest:
    """Request-based RMA handle (MPI_Rput/Raccumulate): wait() completes
    the op at the target via flush (surfacing its error there).  Stamped
    with the window's per-target flush epoch at creation: a flush/
    flush_all issued AFTER the op makes later waits genuinely local
    (no redundant round-trip per drained request)."""

    def __init__(self, win: "P2PWindow", rank: int):
        self._win, self._rank = win, rank
        self._epoch = win._flush_epoch(rank)
        self._done = False

    def wait(self):
        if not self._done:
            if self._win._flush_epoch(self._rank) == self._epoch:
                self._win.flush(self._rank)
            self._done = True

    def test(self):
        # make progress like every other Request type: completing here
        # is at most one bounded flush ack, so request-set pollers
        # terminate
        self.wait()
        return True, None


class P2PWindow:
    """RMA window over a :class:`~mpi_tpu_torch.communicator.P2PCommunicator`.

    The local buffer is a tensor (copied from ``init``).  Operations
    are queued and shipped at ``fence()`` with one message per peer (FIFO
    per-pair transport ordering keeps epochs aligned without a barrier:
    each rank sends exactly one RMA message per peer per epoch, and the
    fence receives exactly one from each peer — source-specific receives,
    NOT any-source, so a fast peer's next fence can never be consumed by a
    slow peer's current one), followed by get replies.  Messages carry a
    (window id, epoch) stamp that is asserted on receipt: fences of
    different windows on one communicator must be identically ordered on
    all ranks [S: collective-call ordering], and a violation is diagnosed,
    never misdelivered.  Exiting ``fence()`` implies this rank's window has
    its final epoch value — every peer's ops were received and applied.
    """

    def __init__(self, comm, init: Any):
        self._comm = comm
        # owned copy [S: MPI_Win_create memory], on init's device
        self._buf = _owned(init, comm.device)
        self._wid = getattr(comm, "_win_counter", 0)
        comm._win_counter = self._wid + 1
        self._epoch = 0
        # queued outgoing ops: per target comm-rank, list of
        # (issue_idx, kind, payload, loc, opname)
        self._out: dict = {}
        # queued gets: (issue_idx, source_rank_or_None, loc, fill, future)
        self._gets: List[Tuple] = []
        self._issue = 0
        self._freed = False
        # per-target completed-flush counter (request-based RMA stamps)
        self._flush_epochs: dict = {}
        # passive-target server (win_create is collective [S], so the
        # context allocation below is deterministic on every rank, and
        # every rank has a live server before any origin can lock it)
        self._ensure_server()

    # -- epoch ops ---------------------------------------------------------

    @property
    def local(self) -> torch.Tensor:
        """The local window buffer (valid to read between fences)."""
        return self._buf

    def put(self, data: Any, pairs, loc: Any = None) -> None:
        """Queue a put: for each (src, dst), src's ``data`` overwrites
        dst's window (at ``loc`` if given, numpy basic-indexing)."""
        self._check_open()
        for s, d in _normalize_pairs(pairs, self._comm.size,
                                     self._comm.rank, allow_int=True):
            if s == self._comm.rank:
                self._queue(d, "put", self._data(data), loc, None)
        self._issue += 1

    def accumulate(self, data: Any, pairs, op: _ops.ReduceOp = _ops.SUM,
                   loc: Any = None) -> None:
        """Queue an accumulate: dst's window[loc] = op(window[loc], data)."""
        self._check_open()
        for s, d in _normalize_pairs(pairs, self._comm.size,
                                     self._comm.rank, allow_int=True):
            if s == self._comm.rank:
                self._queue(d, "acc", self._data(data), loc, op)
        self._issue += 1

    def get(self, pairs, fill: Any = 0, loc: Any = None) -> GetFuture:
        """Queue a get: for each (src, dst), src's window[loc] arrives at
        dst.  Returns a GetFuture (``.value`` after the closing fence, on
        every rank).  Ranks that are not a dst in the pattern resolve to
        ``fill`` (default 0, matching the SPMD backend, which must produce
        a value on every rank)."""
        self._check_open()
        fut = GetFuture()
        me = self._comm.rank
        norm = _normalize_pairs(pairs, self._comm.size, me, allow_int=True)
        srcs = [s for s, d in norm if d == me]
        if isinstance(pairs, (int, np.integer)):
            srcs = [int(pairs)]  # int form: I am the origin, reading pairs
        src = srcs[0] if srcs else None  # None: resolve to fill at fence
        self._gets.append((self._issue, src, loc, fill, fut))
        self._issue += 1
        return fut

    def fence(self) -> None:
        """Close the epoch: ship+apply all queued ops, resolve gets."""
        self._check_open()
        comm = self._comm
        me, size = comm.rank, comm.size
        # phase 1: one ops-message to every peer (possibly empty)
        for r in range(size):
            if r == me:
                continue
            ops_r = self._out.get(r, [])
            gets_r = [(idx, loc) for idx, s, loc, _f, _ in self._gets
                      if s == r]
            comm._send_internal(
                (self._wid, self._epoch, ops_r, gets_r), r, _TAG_RMA)
        # phase 2: exactly one message from EACH peer (source-specific —
        # see class docstring for why any-source would race)
        incoming: List[Tuple[int, int, str, Any, Any, Optional[str]]] = []
        get_reqs: dict = {}
        for r in range(size):
            if r == me:
                continue
            wid, epoch, ops_r, gets_r = comm._recv_internal(r, _TAG_RMA)
            if (wid, epoch) != (self._wid, self._epoch):
                raise RuntimeError(
                    f"RMA fence mismatch: rank {r} is fencing window "
                    f"{wid} epoch {epoch}, this rank window {self._wid} "
                    f"epoch {self._epoch} — fences of windows on one "
                    f"communicator must be identically ordered on all ranks")
            for idx, kind, data, loc, op in ops_r:
                incoming.append((idx, r, kind, data, loc, op))
            if gets_r:
                get_reqs[r] = gets_r
        # my own ops targeting myself
        for idx, kind, data, loc, op in self._out.get(me, []):
            incoming.append((idx, me, kind, data, loc, op))
        # apply puts/accumulates: issue order first (global in SPMD-aligned
        # programs), source rank as the tie-break — see module docstring
        for idx, src_rank, kind, data, loc, op in sorted(
                incoming, key=lambda t: (t[0], t[1])):
            self._apply(kind, data, loc, op)
        # phase 3: service get requests against the post-write window
        for r, reqs in get_reqs.items():
            comm._send_internal(
                [self._read(loc) for idx, loc in reqs], r, _TAG_RMA_REPLY)
        by_src: dict = {}
        for idx, s, loc, fill, fut in self._gets:
            by_src.setdefault(s, []).append((loc, fill, fut))
        for s, entries in by_src.items():
            if s is None:  # no source in the pattern: the boundary fill
                for loc, fill, fut in entries:
                    fut._resolve(fill)
                continue
            if s == me:
                for loc, fill, fut in entries:
                    fut._resolve(self._read(loc))
                continue
            replies = comm._recv_internal(s, _TAG_RMA_REPLY)
            for (loc, fill, fut), val in zip(entries, replies):
                fut._resolve(val)
        self._out.clear()
        self._gets.clear()
        self._issue = 0
        self._epoch += 1

    # -- passive target (MPI-2 MPI_Win_lock/unlock) [S] --------------------
    # A per-window SERVER THREAD on an isolated child context services
    # lock/put/get/accumulate/unlock requests without the target's user
    # code participating — true one-sided access, unlike the fence epochs
    # above.  Exclusive locks serialize writers; shared locks admit
    # concurrent readers (readers-writer with FIFO handoff).  Ops issued
    # inside a lock epoch are applied at the target in issue order (FIFO
    # per-pair transport ordering); ``unlock`` acks only after everything
    # sent under the lock has been applied — MPI's completion-at-unlock.
    # Self-targeted epochs bypass messaging and apply under the server's
    # mutex (deadlock-free on every transport).

    def _atomic_runnable(self, src: int) -> bool:
        """Caller holds _srv_mutex.  An atomic may run unless some OTHER
        rank holds the exclusive lock (its epoch must stay isolated);
        concurrent shared holders are fine — application is a single
        mutex-guarded step."""
        s = self._lock_state
        return s["excl"] is None or s["excl"] == src

    def _atomic_exec(self, msg) -> tuple:
        """Caller holds _srv_mutex; returns the ('ok', old)/('err', txt)
        reply — ONE implementation for the server path, the deferred
        drain, and the self-rank path."""
        try:
            if msg[0] == "fetch_op":
                _, data, op, loc = msg
                old = self._read(loc)
                self._apply("acc", data, loc, op)
            else:  # "cas"
                _, compare, new_val, loc = msg
                old = self._read(loc)
                if _array_equal(old, compare):
                    self._apply("put", new_val, loc, None)
            return ("ok", old)
        except Exception as e:  # noqa: BLE001 - surfaces at the origin
            return ("err", f"{type(e).__name__}: {e}")

    def _ensure_server(self):
        import threading

        from .communicator import P2PCommunicator

        if getattr(self, "_srv_thread", None) is not None:
            return
        # TWO isolated child contexts (deterministic: same _alloc_context
        # sequence on every rank since win_create is collective):
        # * _srv_comm — requests + lock grants.  NO recv_timeout: the
        #   server idles between requests by design, and a lock wait is
        #   unbounded by design (another rank may hold the lock
        #   arbitrarily long — a timeout there would be a false failure).
        # * _org_comm — unlock acks + get replies, BOUNDED work at a live
        #   target.  Inherits the parent's recv_timeout so a crashed
        #   target surfaces as RecvTimeout, not a hang (the framework's
        #   failure-detection contract).
        ctx = self._comm._alloc_context()
        ctx2 = self._comm._alloc_context()
        self._srv_comm = P2PCommunicator(self._comm._t, self._comm._group,
                                         ctx, recv_timeout=None)
        self._org_comm = P2PCommunicator(self._comm._t, self._comm._group,
                                         ctx2,
                                         recv_timeout=self._comm.recv_timeout)
        self._srv_mutex = threading.Lock()   # buffer + lock-state guard
        self._lock_state: dict = {"holders": set(), "excl": None,
                                  "queue": []}
        self._srv_errors: dict = {}
        self._pscw_cv = threading.Condition(self._srv_mutex)
        self._pscw_pending: set = set()      # origins my post still waits on
        self._pscw_targets = None            # my open access epoch
        t = threading.Thread(target=self._serve, daemon=True,
                             name=f"win{self._wid}-server")
        self._srv_thread = t
        t.start()

    def _serve(self) -> None:
        from .communicator import Status
        from .transport.base import ANY_SOURCE

        c = self._srv_comm
        st = Status()
        while True:
            try:
                msg = c._recv_internal(ANY_SOURCE, _TAG_PASSIVE, st)
            except Exception:  # transport closed (finalize) → done
                return
            src = st.source
            kind = msg[0]
            if kind == "stop":
                return
            # every branch is guarded: a bad op (shape mismatch, bad loc,
            # failing combiner) must NEVER kill the server — it is recorded
            # (or replied) and re-raised at the ORIGIN, and serving
            # continues (a dead server would turn one bad put into a
            # permanent hang of every later lock on this rank)
            try:
                if kind == "lock":
                    self._request_lock(
                        src, exclusive=msg[1],
                        notify=lambda r=src: c._send_internal(
                            ("granted",), r, _TAG_PASSIVE_REPLY))
                elif kind == "unlock":
                    with self._srv_mutex:
                        err = self._srv_errors.pop(src, None)
                        self._srv_release(src)
                    self._org_comm._send_internal(("unlocked", err), src,
                                                  _TAG_PASSIVE_REPLY)
                elif kind == "pscw_complete":
                    # arrives on the SAME FIFO channel as this origin's
                    # RMA ops, so every op of its epoch has been applied
                    # by the time the exposure epoch can close; the ack
                    # carries any recorded op error back to the origin
                    # (completion-at-close, like unlock)
                    with self._pscw_cv:
                        err = self._srv_errors.pop(src, None)
                        self._pscw_pending.discard(src)
                        self._pscw_cv.notify_all()
                    self._org_comm._send_internal(("pscw_done", err), src,
                                                  _TAG_PASSIVE_REPLY)
                elif kind in ("fetch_op", "cas"):
                    # MPI-3 atomic: apply + reply the OLD value in one
                    # message.  An exclusive lock held by ANOTHER rank
                    # defers it (queued; drained at lock release) so
                    # atomics cannot pierce an exclusive epoch.
                    with self._srv_mutex:
                        if self._atomic_runnable(src):
                            reply = self._atomic_exec(msg)
                        else:
                            self._lock_state.setdefault(
                                "atomics", []).append((src, msg))
                            # the origin learns the wait is application-
                            # bound (foreign exclusive lock): crash
                            # detection stays on the first reply, only
                            # the post-deferral wait is untimed.  Sent
                            # UNDER the mutex — the release-drain also
                            # sends under it, so the notice can never
                            # be overtaken by the real reply (a stale
                            # notice would poison the channel)
                            self._org_comm._send_internal(
                                ("deferred", None), src,
                                _TAG_PASSIVE_REPLY)
                            reply = None
                    if reply is not None:
                        self._org_comm._send_internal(
                            reply, src, _TAG_PASSIVE_REPLY)
                elif kind == "flush":
                    # FIFO position => all prior ops from src are applied;
                    # ack carries (and clears) any recorded error
                    with self._srv_mutex:
                        err = self._srv_errors.pop(src, None)
                    self._org_comm._send_internal(("flushed", err), src,
                                                  _TAG_PASSIVE_REPLY)
                elif kind == "get":
                    try:
                        with self._srv_mutex:
                            val = self._read(msg[1])
                        reply = ("ok", val)
                    except Exception as e:  # noqa: BLE001 - to origin
                        reply = ("err", f"{type(e).__name__}: {e}")
                    self._org_comm._send_internal(reply, src,
                                                  _TAG_PASSIVE_REPLY)
                else:  # "put" / "acc": no reply — errors surface at unlock
                    try:
                        _, data, loc, op = msg
                        with self._srv_mutex:
                            self._apply("put" if kind == "put" else "acc",
                                        data, loc, op)
                    except Exception as e:  # noqa: BLE001 - to origin
                        with self._srv_mutex:
                            self._srv_errors.setdefault(
                                src, f"{type(e).__name__}: {e}")
            except Exception:  # reply-send failure: peer gone; keep serving
                pass

    def _request_lock(self, src: int, exclusive: bool, notify) -> None:
        """Single grant path for remote AND self requesters: grant now if
        admissible, else join the FIFO queue; ``notify`` fires (under no
        lock) when granted."""
        with self._srv_mutex:
            s = self._lock_state
            ok = (s["excl"] is None and not s["holders"]) if exclusive \
                else (s["excl"] is None and not s["queue"])
            if ok:
                s["holders"].add(src)
                if exclusive:
                    s["excl"] = src
            else:
                s["queue"].append((src, exclusive, notify))
        if ok:
            notify()

    def _srv_release(self, src: int) -> None:
        # caller holds _srv_mutex
        s = self._lock_state
        s["holders"].discard(src)
        if s["excl"] == src:
            s["excl"] = None
        granted = []
        while s["queue"]:
            nxt, excl, notify = s["queue"][0]
            can = (s["excl"] is None and not s["holders"]) if excl \
                else s["excl"] is None
            if not can:
                break
            s["queue"].pop(0)
            s["holders"].add(nxt)
            if excl:
                s["excl"] = nxt
            granted.append(notify)
            if excl:
                break
        # drain atomics that the released lock was blocking (they run
        # before notify-sends, still under the caller's mutex)
        pend = s.get("atomics", [])
        if pend:
            still = []
            for a_src, a_msg in pend:
                if self._atomic_runnable(a_src):
                    self._org_comm._send_internal(
                        self._atomic_exec(a_msg), a_src, _TAG_PASSIVE_REPLY)
                else:
                    still.append((a_src, a_msg))
            s["atomics"] = still
        if getattr(self, "_pscw_cv", None) is not None:
            self._pscw_cv.notify_all()  # wake self-rank atomic waiters
        for notify in granted:
            notify()

    def lock(self, rank: int, exclusive: bool = True) -> None:
        """MPI_Win_lock [S]: open a passive-target access epoch at
        ``rank``'s window (blocks until granted).  ``exclusive=False`` is
        MPI_LOCK_SHARED."""
        self._check_open()
        self._ensure_server()
        if rank == self._comm.rank:
            # self-lock joins the SAME FIFO queue as remote requesters
            # (fair handoff; an out-of-queue spin could starve under
            # sustained remote contention)
            import threading

            granted = threading.Event()
            self._request_lock(self._comm.rank, exclusive, granted.set)
            granted.wait()
            return
        self._srv_comm._send_internal(("lock", exclusive), rank,
                                      _TAG_PASSIVE)
        reply = self._srv_comm._recv_internal(rank, _TAG_PASSIVE_REPLY)
        assert reply == ("granted",)

    def unlock(self, rank: int) -> None:
        """MPI_Win_unlock [S]: close the epoch; on return every op issued
        under the lock has been applied at the target.  An op that FAILED
        at the target (bad loc/shape/op) re-raises here, at the origin."""
        self._check_open()
        if rank == self._comm.rank:
            with self._srv_mutex:
                err = self._srv_errors.pop(self._comm.rank, None)
                self._srv_release(self._comm.rank)
            if err:
                raise RuntimeError(f"passive RMA op failed at target "
                                   f"{rank}: {err}")
            return
        self._srv_comm._send_internal(("unlock",), rank, _TAG_PASSIVE)
        reply = self._org_comm._recv_internal(rank, _TAG_PASSIVE_REPLY)
        assert reply[0] == "unlocked"
        if reply[1]:
            raise RuntimeError(
                f"passive RMA op failed at target {rank}: {reply[1]}")

    def put_at(self, rank: int, data: Any, loc: Any = None) -> None:
        """Passive put at ``rank`` (call between lock/unlock; applied in
        issue order, complete at unlock)."""
        self._check_open()
        if rank == self._comm.rank:
            with self._srv_mutex:
                try:
                    self._apply("put", self._data(data), loc, None)
                except Exception as e:  # noqa: BLE001 - surfaces at unlock
                    self._srv_errors.setdefault(
                        rank, f"{type(e).__name__}: {e}")
            return
        self._srv_comm._send_internal(("put", self._data(data), loc, None),
                                      rank, _TAG_PASSIVE)

    def accumulate_at(self, rank: int, data: Any,
                      op: _ops.ReduceOp = _ops.SUM, loc: Any = None) -> None:
        self._check_open()
        if rank == self._comm.rank:
            with self._srv_mutex:
                try:
                    self._apply("acc", self._data(data), loc, op)
                except Exception as e:  # noqa: BLE001 - surfaces at unlock
                    self._srv_errors.setdefault(
                        rank, f"{type(e).__name__}: {e}")
            return
        self._srv_comm._send_internal(("acc", self._data(data), loc, op),
                                      rank, _TAG_PASSIVE)

    def get_at(self, rank: int, loc: Any = None) -> Any:
        """Passive get from ``rank``'s window; returns the value
        immediately (a strengthening of MPI's complete-at-unlock)."""
        self._check_open()
        if rank == self._comm.rank:
            try:
                with self._srv_mutex:
                    return self._read(loc)
            except Exception as e:  # noqa: BLE001 - same contract as remote
                raise RuntimeError(f"passive RMA get failed at target "
                                   f"{rank}: {type(e).__name__}: {e}")
        self._srv_comm._send_internal(("get", loc), rank, _TAG_PASSIVE)
        tag, val = self._org_comm._recv_internal(rank, _TAG_PASSIVE_REPLY)
        if tag == "err":
            raise RuntimeError(f"passive RMA get failed at target "
                               f"{rank}: {val}")
        return val

    def sync(self) -> None:
        """MPI_Win_sync: the memory-model ordering point.  This window's
        ops are applied by the server under a mutex (no private/public
        copy split), so the call is a correct no-op — valid on ANY
        window, kept for portable MPI code."""
        self._check_open()

    # -- MPI-3 atomics + flush (passive/PSCW epochs) ------------------------

    def fetch_and_op(self, rank: int, data: Any,
                     op: _ops.ReduceOp = _ops.SUM, loc: Any = None):
        """MPI_Fetch_and_op [S: MPI-3]: atomically combine ``data`` into
        ``rank``'s window and return the PREVIOUS value — one server
        round-trip (the fetch-add every distributed counter wants)."""
        return self._atomic_origin(
            rank, ("fetch_op", self._data(data), op, loc), "fetch_and_op")

    def compare_and_swap(self, rank: int, compare: Any, new: Any,
                         loc: Any = None):
        """MPI_Compare_and_swap [S: MPI-3]: if the target location equals
        ``compare``, replace it with ``new``; returns the previous value
        either way."""
        return self._atomic_origin(
            rank, ("cas", self._data(compare), self._data(new), loc),
            "compare_and_swap")

    def _atomic_origin(self, rank: int, msg, what: str):
        self._check_open()
        self._ensure_server()
        if rank == self._comm.rank:
            with self._pscw_cv:  # the general server-state condition
                while not self._atomic_runnable(rank):
                    self._pscw_cv.wait()  # released lock notifies
                tag, val = self._atomic_exec(msg)
        else:
            self._srv_comm._send_internal(msg, rank, _TAG_PASSIVE)
            # first reply is BOUNDED by recv_timeout (a dead target must
            # surface, same contract as get/flush); a live target that
            # queued the atomic behind a foreign exclusive lock answers
            # ("deferred", ...) immediately, and only then do we wait
            # untimed — the remaining wait is application-controlled,
            # like lock()
            tag, val = self._org_comm._recv_internal(rank,
                                                     _TAG_PASSIVE_REPLY)
            if tag == "deferred":
                oc = self._org_comm
                (tag, val), _, _ = oc._t.recv(oc._world(rank), oc._ctx,
                                              _TAG_PASSIVE_REPLY,
                                              timeout=None)
        if tag == "err":  # same contract on the self path as remote
            raise RuntimeError(f"{what} failed at target {rank}: {val}")
        return val

    def flush(self, rank: int) -> None:
        """MPI_Win_flush [S: MPI-3]: complete all outstanding ops at
        ``rank`` WITHOUT closing the epoch; a recorded op error raises
        here (and is cleared) instead of waiting for unlock."""
        self._check_open()
        self._ensure_server()
        me = self._comm.rank
        if rank == me:
            with self._srv_mutex:
                err = self._srv_errors.pop(me, None)
            if err:
                raise RuntimeError(f"RMA op failed at target {rank}: {err}")
            self._bump_flush_epoch(rank)
            return
        self._srv_comm._send_internal(("flush",), rank, _TAG_PASSIVE)
        tag, err = self._org_comm._recv_internal(rank, _TAG_PASSIVE_REPLY)
        assert tag == "flushed"
        if err:
            raise RuntimeError(f"RMA op failed at target {rank}: {err}")
        self._bump_flush_epoch(rank)

    def _flush_epoch(self, rank: int) -> int:
        return self._flush_epochs.get(rank, 0)

    def _bump_flush_epoch(self, rank: int) -> None:
        self._flush_epochs[rank] = self._flush_epochs.get(rank, 0) + 1

    def lock_all(self) -> None:
        """MPI_Win_lock_all [S: MPI-3]: a SHARED lock at every rank's
        window — deadlock-free because shared grants don't exclude each
        other (rank order only matters against queued exclusives)."""
        for r in range(self._comm.size):
            self.lock(r, exclusive=False)

    def unlock_all(self) -> None:
        for r in range(self._comm.size):
            self.unlock(r)

    def flush_all(self) -> None:
        """MPI_Win_flush_all: complete outstanding ops at every target."""
        for r in range(self._comm.size):
            self.flush(r)

    # flush_local(_all): our origin side buffers nothing (ops ship
    # immediately), so local completion is trivially true — but the
    # TARGET-completion spelling is what callers usually mean; alias it.
    flush_local = flush
    flush_local_all = flush_all

    def get_accumulate(self, rank: int, data: Any,
                       op: _ops.ReduceOp = _ops.SUM, loc: Any = None):
        """MPI_Get_accumulate [S: MPI-3]: fetch the target location and
        accumulate into it, atomically — fetch_and_op generalized to
        array payloads (this implementation never restricted the payload
        to one element, so they coincide)."""
        return self.fetch_and_op(rank, data, op, loc)

    def rput(self, rank: int, data: Any, loc: Any = None):
        """MPI_Rput [S: MPI-3 request-based RMA]: returns a Request whose
        wait() flushes the target (op completion there)."""
        self.put_at(rank, data, loc)
        return _RmaRequest(self, rank)

    def raccumulate(self, rank: int, data: Any,
                    op: _ops.ReduceOp = _ops.SUM, loc: Any = None):
        self.accumulate_at(rank, data, op, loc)
        return _RmaRequest(self, rank)

    def rget(self, rank: int, loc: Any = None):
        """MPI_Rget: get_at is synchronous here, so the request is
        complete at creation and carries the value."""
        from .communicator import _CompletedRequest

        return _CompletedRequest(self.get_at(rank, loc))

    # -- generalized active target (PSCW [S: MPI_Win_post/start/
    # complete/wait]) — the third RMA synchronization mode, alongside
    # fence (active) and lock/unlock (passive).  Target side: post(group)
    # exposes the window to those origins, wait() blocks until they all
    # completed.  Origin side: start(group) opens an access epoch at
    # those targets (blocks until each posted), issue put_at/get_at/
    # accumulate_at, complete() closes it.  The completion notification
    # rides the same FIFO server channel as the epoch's ops, so a
    # target's wait() cannot return before the ops are applied.

    def post(self, group) -> None:
        """MPI_Win_post: expose my window to origin ranks ``group``
        (non-blocking)."""
        self._check_open()
        self._ensure_server()
        ranks = [int(r) for r in getattr(group, "ranks", group)]
        with self._pscw_cv:
            if self._pscw_pending:
                raise RuntimeError(
                    "MPI_Win_post while a previous exposure epoch is "
                    "still open (call win.wait() first)")
            self._pscw_pending = set(ranks)
        me = self._comm.rank
        for r in ranks:
            if r != me:
                self._org_comm._send_internal(("posted",), r,
                                              _TAG_PSCW_POST)

    def start(self, group) -> None:
        """MPI_Win_start: open an access epoch at target ranks ``group``;
        blocks until each target posted."""
        self._check_open()
        self._ensure_server()
        if self._pscw_targets is not None:
            raise RuntimeError("MPI_Win_start while a previous access "
                               "epoch is still open (call win.complete())")
        ranks = [int(r) for r in getattr(group, "ranks", group)]
        me = self._comm.rank
        oc = self._org_comm
        for t in ranks:
            if t != me:
                # UNTIMED by design, like lock(): waiting for the target
                # to reach its post() is waiting on application code, not
                # on a bounded service (recv_timeout would false-positive
                # on a slow-but-healthy peer)
                obj, _, _ = oc._t.recv(oc._world(t), oc._ctx,
                                       _TAG_PSCW_POST, timeout=None)
                assert obj == ("posted",)
        self._pscw_targets = ranks

    def complete(self) -> None:
        """MPI_Win_complete: close the access epoch; ops are applied at
        each target before its wait() returns."""
        self._check_open()
        if getattr(self, "_pscw_targets", None) is None:
            raise RuntimeError("MPI_Win_complete without MPI_Win_start")
        me = self._comm.rank
        targets, self._pscw_targets = self._pscw_targets, None
        errs = []
        for t in targets:
            if t == me:
                with self._pscw_cv:
                    err = self._srv_errors.pop(me, None)
                    self._pscw_pending.discard(me)
                    self._pscw_cv.notify_all()
                if err:
                    errs.append((me, err))
            else:
                self._srv_comm._send_internal(("pscw_complete",), t,
                                              _TAG_PASSIVE)
        for t in targets:
            if t != me:
                tag, err = self._org_comm._recv_internal(
                    t, _TAG_PASSIVE_REPLY)
                assert tag == "pscw_done"
                if err:
                    errs.append((t, err))
        if errs:
            raise RuntimeError(
                "PSCW op(s) failed at target(s): " +
                "; ".join(f"rank {t}: {e}" for t, e in errs))

    def wait(self) -> None:
        """MPI_Win_wait: close the exposure epoch — blocks until every
        posted origin called complete()."""
        self._check_open()
        if getattr(self, "_pscw_cv", None) is None:
            return  # no exposure epoch was ever opened
        import time

        deadline = (None if self._comm.recv_timeout is None
                    else time.monotonic() + self._comm.recv_timeout)
        with self._pscw_cv:
            while self._pscw_pending:
                budget = None
                if deadline is not None:
                    budget = deadline - time.monotonic()
                    if budget <= 0:
                        from .transport.base import RecvTimeout

                        raise RecvTimeout(
                            f"MPI_Win_wait: origins {sorted(self._pscw_pending)} "
                            f"never completed within {self._comm.recv_timeout}s")
                self._pscw_cv.wait(budget)

    def test(self) -> bool:
        """MPI_Win_test: nonblocking wait — True iff the exposure epoch
        is closed."""
        self._check_open()
        if getattr(self, "_pscw_cv", None) is None:
            return True
        with self._pscw_cv:
            return not self._pscw_pending

    def free(self) -> None:
        if getattr(self, "_srv_thread", None) is not None:
            try:
                self._srv_comm._send_internal(
                    ("stop",), self._comm.rank, _TAG_PASSIVE)
            except Exception:
                pass
            self._srv_thread.join(timeout=2.0)
            self._srv_thread = None
        self._freed = True

    # -- internals ---------------------------------------------------------

    def _check_open(self) -> None:
        if self._freed:
            raise RuntimeError("operation on a freed Window")

    def _data(self, data: Any) -> torch.Tensor:
        """An op's payload as a tensor: a tensor as it is, anything else
        on this window's device (numpy's dtype rules, as the reference's
        ``np.asarray``)."""
        if isinstance(data, torch.Tensor):
            return data
        return torch.as_tensor(np.asarray(data), device=self._buf.device)

    def _queue(self, target: int, kind: str, data: torch.Tensor, loc: Any,
               op: Optional[_ops.ReduceOp]) -> None:
        # the op object rides the transport with the data (built-in ops and
        # module-level user combiners pickle; lambda user ops need the
        # in-process 'local' backend)
        self._out.setdefault(target, []).append(
            (self._issue, kind, data, loc, op))

    def _read(self, loc: Any) -> torch.Tensor:
        return (self._buf if loc is None else self._buf[loc]).clone()

    def _apply(self, kind: str, data: torch.Tensor, loc: Any,
               op: Optional[_ops.ReduceOp]) -> None:
        _store(self._buf, kind, data, loc, op)


class DynamicWindow(P2PWindow):
    """MPI_Win_create_dynamic [S: MPI-3 ch.11.2.4]: a window with NO
    initial memory; regions are attached and detached at runtime.  MPI
    addresses attached regions by base pointer; the value-semantics
    spelling here addresses them by KEY — ``loc`` in every RMA op is the
    region key, or ``(key, subindex)`` for a part of a region.

    attach/detach are LOCAL calls, per MPI; an op targeting a region the
    target has not attached fails at the target and surfaces through the
    usual completion points (unlock/flush/complete)."""

    def __init__(self, comm):
        super().__init__(comm, torch.zeros(0, dtype=torch.float64,
                                           device=comm.device))
        self._regions: dict = {}

    # -- local region management -------------------------------------------

    def attach(self, key: str, array: Any) -> torch.Tensor:
        """Expose ``array`` (copied in, MPI_Win_create memory semantics)
        under ``key``; returns the live region (reads show remote
        writes after the usual synchronization).  Local call [S]."""
        region = _owned(array, self._comm.device)
        with self._srv_mutex:  # serialized against the window server
            if key in self._regions:
                raise ValueError(f"region {key!r} already attached")
            self._regions[key] = region
        return region

    def detach(self, key: str) -> torch.Tensor:
        """Withdraw the region; returns its final contents.  Local [S]."""
        with self._srv_mutex:
            if key not in self._regions:
                raise ValueError(f"region {key!r} is not attached")
            return self._regions.pop(key)

    def region(self, key: str) -> torch.Tensor:
        return self._regions[key]

    # -- storage override: loc = key | (key, subindex) ----------------------

    def _resolve(self, loc: Any):
        if loc is None:
            raise ValueError(
                "dynamic-window ops need loc=<region key> or "
                "(key, subindex) — there is no base buffer")
        if isinstance(loc, tuple) and len(loc) == 2:
            key, sub = loc
        else:
            key, sub = loc, None
        try:
            return self._regions[key], sub
        except (KeyError, TypeError):  # unknown key, or unhashable loc
            raise KeyError(f"region {key!r} is not attached at this "
                           "target") from None

    def _read(self, loc: Any) -> torch.Tensor:
        buf, sub = self._resolve(loc)
        return (buf if sub is None else buf[sub]).clone()

    def _apply(self, kind: str, data: torch.Tensor, loc: Any,
               op: Optional[_ops.ReduceOp]) -> None:
        buf, sub = self._resolve(loc)
        _store(buf, kind, data, sub, op)
