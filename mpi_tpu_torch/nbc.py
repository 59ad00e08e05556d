"""Engine-owned nonblocking collectives — schedule state machines, not
threads — plus the MPI-4 persistent collectives built on the same
compiled schedule: the port's own copy of ``mpi_tpu/nbc.py``
(``FoldPool`` :157, ``pool_for`` :190, ``_SMColl`` :203,
``_resolve_allreduce_algorithm`` :520, ``_allreduce_steps`` :545,
``_build`` :557, ``_launch`` :767, ``try_state_machine`` :782,
``PersistentColl`` :801, ``persistent_init`` :1061), with the flight
recorder's ``sm`` events (:260-430) and the runtime verifier's frozen
signature and double-buffer fence (:842-990).

With the progress engine attached (``progress="thread"``), a nonblocking
collective compiles into a per-rank step plan — ``[(sends, recvs), ...]``
span or value tables from ``schedules.py`` — and runs as a state machine
advanced by the engine's completion callbacks:

* every receive of the plan is posted up front on an isolated per-call
  context (``P2PCommunicator._nbc_comm``), with ``_on_complete`` kicking
  this machine;
* receive ACTIONS (fold with ``op.combine_into``, copy, store) apply
  strictly in plan order on a small per-world **fold pool** (cvar
  ``nbc_fold_workers``, default 2), so reductions never run on the engine
  thread;
* sends are credit-limited ``send_ahead`` steps past the last completed
  step, the blocking algorithms' dependency and window structure, so the
  wire carries the blocking algorithm's frame sequence;
* ``wait()``/``test()`` stay caller-financed fallbacks with the
  fault-tolerance slicing of ``_progress_wait_request``.

``nbc_threads_spawned`` counts every ``_ThreadRequest`` spawn and stays 0
on this path; ``nbc_state_machines`` counts compiled requests.  The thread
path remains for ``progress="none"`` worlds, ``nbc_mode="thread"``,
payloads above ``nbc_sm_max_bytes`` (the segmented blocking algorithms own
the bandwidth regime), compressed algorithms and payloads no plan can
fold.

Persistent collectives (``allreduce_init``, ``bcast_init``,
``alltoall_init``, ``reduce_scatter_init``) hoist the child context, the
algorithm resolution, the schedule and the working buffers into init;
each ``start()`` re-reads the bound buffer (a tensor refilled in place on
the card is folded afresh: no host copy is cached), re-posts the plan's
receives and fires (``persistent_starts``).  Without the engine a round
runs on one thread on the same hoisted context.

Tensors: the working buffers live on the payload's device and every fold
is an in-place torch op there.  The fold pool's workers bind the world's
device before their first launch and work on its default stream.

With the runtime verifier on, a persistent collective exchanges its
signature once at init and freezes the per-round check, and the
double-buffer contract is FENCED: a ``start()`` that would overwrite a
round result the caller still holds (the tensor itself or any view of
it, on the card as on the CPU) raises ``BufferPinnedError``.
"""

from __future__ import annotations

import gc
import os
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import coll_sm as _coll_sm
from . import mpit as _mpit
from . import ops as _ops
from . import schedules
from . import telemetry as _telemetry
from . import tuning as _tuning
from .communicator import (P2PCommunicator, Request, _CompletedRequest,
                           _FT_POLL_S, _SEG_WINDOW, _TAG_COLL, _ThreadRequest,
                           _as_tensor, _caller_waits, _flat_copy, _maybe_stack,
                           _on_default_stream, _unpost, seed_allreduce_algorithm)
from . import bufpool as _bufpool
from .errors import BufferPinnedError, ProcFailedError
from .transport.base import (ANY_SOURCE, RecvTimeout, bind_thread_device,
                             payload_nbytes)

__all__ = ["try_state_machine", "persistent_init", "PersistentColl"]

# Dispatch mode (cvar ``nbc_mode``): "auto" = state machines whenever the
# world runs the progress engine; "thread" = one _ThreadRequest per call.
MODES = ("auto", "thread")
_MODE = os.environ.get("MPI_TPU_NBC", "auto")

# Payload ceiling of the state-machine path (cvar ``nbc_sm_max_bytes``,
# 0 = no cap).  Reductions gate on the working buffer (congruent across
# the group by the reduction contract); ialltoall gates on its largest
# block, rank-locally, since both paths emit the same pairwise frame
# sequence on the same per-call context.  The value plans of bcast,
# allgather, gather, scatter and barrier are not gated: a receiver does
# not know the payload size before the frame lands.
_SM_MAX_BYTES = int(os.environ.get("MPI_TPU_NBC_SM_MAX_BYTES", str(1 << 20)))

# Fold-pool width per world (cvar ``nbc_fold_workers``; read at the pool's
# first use).
_FOLD_WORKERS = int(os.environ.get("MPI_TPU_NBC_FOLD_WORKERS", "2"))

# The initial send window is emitted on the issuing caller when it is at
# most this many bytes; larger first windows go to the fold pool.
_INLINE_FIRE_MAX = 64 << 10

# Compiled plan memo: plans are pure data, 1000 concurrent same-shape
# iallreduces compile once.  Bounded FIFO.
_PLAN_MEMO: Dict[Tuple, Tuple] = {}
_PLAN_MEMO_MAX = 256
_PLAN_LOCK = threading.Lock()


def mode() -> str:
    return _MODE


def _plan(key: Tuple, build: Callable[[], Tuple]) -> Tuple:
    with _PLAN_LOCK:
        hit = _PLAN_MEMO.get(key)
    if hit is not None:
        return hit
    steps = build()
    with _PLAN_LOCK:
        if len(_PLAN_MEMO) >= _PLAN_MEMO_MAX:
            _PLAN_MEMO.pop(next(iter(_PLAN_MEMO)))
        _PLAN_MEMO[key] = steps
    return steps


# -- the bounded fold pool ----------------------------------------------------


class FoldPool:
    """A tiny per-world worker pool that advances state machines: receive
    completions enqueue the machine (deduplicated), a worker applies its
    ready actions and posts the sends they unlock.  Created once per
    world; each worker binds ``device`` before its first launch."""

    def __init__(self, nworkers: int, device=None) -> None:
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._device = device
        self._threads = []
        for i in range(max(1, int(nworkers))):
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"mpi-tpu-torch-nbc-fold-{i}")
            t.start()
            self._threads.append(t)

    def submit(self, sm: "_SMColl") -> None:
        self._q.put(sm)

    def _run(self) -> None:
        bind_thread_device(self._device)
        while True:
            sm = self._q.get()
            if sm is None:
                return
            sm._pump()  # records its own errors on the machine

    def stop(self, timeout: float = 5.0) -> None:
        for _ in self._threads:
            self._q.put(None)
        deadline = time.monotonic() + timeout
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))


def pool_for(transport) -> FoldPool:
    pool = getattr(transport, "_nbc_fold_pool", None)
    if pool is None:
        with _PLAN_LOCK:  # two first machines racing share one pool
            pool = getattr(transport, "_nbc_fold_pool", None)
            if pool is None:
                pool = transport._nbc_fold_pool = FoldPool(
                    _FOLD_WORKERS, transport.device)
    return pool


# -- the state machine --------------------------------------------------------


class _SMColl(Request):
    """One nonblocking collective as a schedule state machine.

    State is guarded by ``self._lock``; advancement (``_pump``) is
    idempotent and runs on a fold-pool worker or the waiting caller,
    whoever gets there first.  Receive actions apply strictly in plan
    order (the blocking algorithms' fold order); sends leave in step order
    once their credit is due.  Errors (transport, fault tolerance, fold)
    are recorded and re-raised at wait()/test(), and the machine's
    remaining posted receives are un-posted."""

    __slots__ = ("kind", "_parent", "_comm", "_mode", "_steps",
                 "_send_ahead", "_work", "_svals", "_rvals", "_op",
                 "_finish", "_actions", "_srem", "_ai", "_rdt", "_nss",
                 "_done", "_error", "_result", "_lock", "_qlock",
                 "_queued", "_pool", "_t0")

    _tag = _TAG_COLL

    def __init__(self, parent: P2PCommunicator, child: P2PCommunicator,
                 kind: str, plan_mode: str, steps: Tuple, send_ahead: int,
                 work: Optional[torch.Tensor], svals: Optional[list],
                 rvals: Optional[list], op: Optional[_ops.ReduceOp],
                 finish: Callable[["_SMColl"], Any]) -> None:
        self.kind = kind
        self._parent = parent
        self._comm = child
        self._mode = plan_mode
        self._steps = steps
        self._send_ahead = max(1, send_ahead)
        self._work = work
        self._svals = svals
        self._rvals = rvals
        self._op = op
        self._finish = finish
        self._srem = [len(st[1]) for st in steps]
        # (req, step_i, spec, steer_dest): steer_dest is the work-span view
        # registered for steering (None when not a steerable store span);
        # _apply needs that same object for the delivered-by-identity test
        self._actions: List[Tuple[Any, int, Tuple, Any]] = []
        self._ai = 0
        self._rdt = 0   # recv-done-through: first step with recvs pending
        self._nss = 0   # next step whose sends are not yet emitted
        self._done = False
        self._error: Optional[BaseException] = None
        self._result: Any = None
        self._lock = threading.Lock()
        self._qlock = threading.Lock()
        self._queued = False
        self._pool = pool_for(child._t)
        # flight-recorder span anchor (0 = tracing off at issue time)
        self._t0 = time.perf_counter_ns() if _telemetry.REC is not None else 0
        child._coll_name = kind  # ProcFailedError diagnoses name the call

    def _arm(self) -> "_SMColl":
        """Post every receive of the plan in step order (per-source FIFO
        then matches the peer's step-ordered sends) with this machine's
        kick as the completion callback, atomically with the engine, then
        fire the initial send window."""
        eng = self._parent._progress
        child = self._comm
        reg = child._recv_reg
        with eng.cv:
            for step_i, (sends, recvs) in enumerate(self._steps):
                for spec in recvs:
                    req = child._irecv_internal(spec[0], _TAG_COLL)
                    # span STORES may land directly in the working buffer
                    # on a steering transport; fold spans never register
                    dest = None
                    if reg is not None and self._mode == "span" and not spec[3]:
                        dest = self._work[spec[1]:spec[2]]
                        reg.attach(req._steer_token, dest)
                    req._on_complete = self._kick
                    self._actions.append((req, step_i, spec, dest))
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("sm", "arm",
                     attrs={"kind": self.kind, "steps": len(self._steps),
                            "recvs": len(self._actions)})
        if self._first_window_bytes() <= _INLINE_FIRE_MAX:
            self._pump()
        else:
            self._pool.submit(self)
        return self

    def _first_window_bytes(self) -> int:
        total = 0
        for st in self._steps[:self._send_ahead]:
            for spec in st[0]:
                if self._mode == "span":
                    total += (spec[2] - spec[1]) * self._work.element_size()
                else:
                    v = None if spec[1] < 0 else self._svals[spec[1]]
                    total += payload_nbytes(v) or 0
        return total

    def _kick(self) -> None:
        with self._qlock:
            if self._queued:
                return
            self._queued = True
        self._pool.submit(self)

    def _pump(self) -> None:
        with self._qlock:
            self._queued = False
        with self._lock:
            if self._done or self._error is not None:
                return
            try:
                self._advance_locked()
            except BaseException as e:  # noqa: BLE001 - surfaced at wait
                self._error = e
                _unpost([r for r, _, _, _ in self._actions[self._ai:]
                         if r is not None and not r._done])
                rec = _telemetry.REC
                if rec is not None:
                    rec.emit("sm", "fail",
                             attrs={"kind": self.kind,
                                    "error": type(e).__name__})
                self._notify()

    def _advance_locked(self) -> None:
        n = len(self._steps)
        rdt0, nss0 = self._rdt, self._nss
        progressed = True
        while progressed:
            progressed = False
            while self._ai < len(self._actions):
                req, step_i, spec, dest = self._actions[self._ai]
                if not req._done:
                    break
                self._apply(spec, req._value, dest)
                self._srem[step_i] -= 1
                self._ai += 1
                progressed = True
            while self._rdt < n and self._srem[self._rdt] == 0:
                self._rdt += 1
                progressed = True
            while self._nss < n and self._nss < self._rdt + self._send_ahead:
                for spec in self._steps[self._nss][0]:
                    self._emit(spec)
                self._nss += 1
                progressed = True
        rec = _telemetry.REC
        if rec is not None and (self._rdt, self._nss) != (rdt0, nss0):
            # one step event per pump that moved the machine (the
            # recv-done-through and next-send-step watermarks)
            rec.emit("sm", "step",
                     attrs={"kind": self.kind, "rdt": self._rdt,
                            "nss": self._nss, "of": n})
        if self._rdt == n and self._nss == n and not self._done:
            self._result = self._finish(self)
            self._done = True
            if rec is not None:
                rec.emit("sm", "done",
                         dur_ns=(time.perf_counter_ns() - self._t0
                                 if self._t0 else 0),
                         attrs={"kind": self.kind, "steps": n})
            self._notify()

    def _apply(self, spec: Tuple, got: Any, dest=None) -> None:
        if self._mode == "span":
            _, lo, hi, fold = spec
            view = self._work[lo:hi] if dest is None else dest
            if fold:
                self._op.combine_into(view, got)
            elif got is not view:
                # the span may just have been SENT: retained frames
                # snapshot before the overwrite
                _bufpool.touch(view)
                view.copy_(got)
                self._comm._count_recv_store(dest)
            # else: steered into the span by the transport reader
        else:
            _, slot = spec
            if slot >= 0:
                self._rvals[slot] = got

    def _emit(self, spec: Tuple) -> None:
        child = self._comm
        if self._mode == "span":
            dst, lo, hi = spec
            child._send_internal(child._coll_payload(self._work[lo:hi]),
                                 dst, _TAG_COLL)
        else:
            dst, slot = spec
            payload = None if slot < 0 else self._svals[slot]
            child._send_internal(payload, dst, _TAG_COLL)

    def _notify(self) -> None:
        eng = self._parent._progress
        with eng.cv:
            eng.cv.notify_all()

    def _fail(self, err: BaseException) -> None:
        """Record a CALLER-detected failure (a fault-tolerance verdict, a
        receive timeout) as _pump records advancement errors."""
        with self._lock:
            if self._done or self._error is not None:
                return
            self._error = err
            _unpost([r for r, _, _, _ in self._actions[self._ai:]
                     if not r._done])
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("sm", "fail",
                     attrs={"kind": self.kind, "error": type(err).__name__})
        self._notify()

    def _pending_world_srcs(self) -> Tuple[int, ...]:
        """World ranks whose frames this machine still waits on."""
        child = self._comm
        out = set()
        for req, _, _, _ in self._actions[self._ai:]:
            if not req._done:
                out.add(child._world(req._source))
        return tuple(sorted(out))

    def _drive(self) -> None:
        """Caller-financed completion attempt: drain our posted queues
        through the engine's lock, then advance inline.  Liveness never
        depends on the engine thread or the pool."""
        eng = self._parent._progress
        cbs: List = []
        with eng.cv:
            for req, _, _, _ in self._actions[self._ai:]:
                if not req._done:
                    cbs.extend(eng.try_complete(req))
        with _on_default_stream(self._parent.device):
            for cb in cbs:
                cb()
            self._pump()

    def _finished(self) -> Any:
        _caller_waits(self._parent.device)
        return self._result

    def wait(self) -> Any:
        eng = self._parent._progress
        child = self._comm
        ft = child._ft
        timeout = child.recv_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if not self._done and self._error is None:
                self._drive()
            if self._error is not None:
                self._vnote(True)
                raise self._error
            if self._done:
                self._vnote(True)
                return self._finished()
            if ft is not None:
                ft.check(child)
                suspects = child._ft_suspects(ANY_SOURCE, _TAG_COLL)
                if suspects:
                    err: BaseException = ProcFailedError(
                        f"rank {child.rank}: peer death detected while "
                        f"waiting on nonblocking collective {self.kind!r}",
                        failed=suspects, collective=self.kind)
                    self._fail(err)
                    raise err
            if deadline is not None and time.monotonic() >= deadline:
                err = RecvTimeout(
                    f"{self.kind} state machine timed out after {timeout}s "
                    f"waiting on sources {self._pending_world_srcs()}; "
                    f"pending={child._t.mailbox.pending_summary()}")
                self._fail(err)
                raise err
            with eng.cv:
                if not self._done and self._error is None:
                    eng.cv.wait(_FT_POLL_S)

    def test(self) -> Tuple[bool, Any]:
        if not self._done and self._error is None:
            self._drive()
        if self._error is not None:
            self._vnote(True, blocking=False)
            raise self._error
        if self._done:
            self._vnote(True, blocking=False)
            return True, self._finished()
        # empty path: fault-tolerance gate + this call's poll note (the
        # engine publishes exactly the sources this machine waits on)
        self._comm._empty_poll_check(ANY_SOURCE, _TAG_COLL, req=self)
        return False, None


# -- plan construction --------------------------------------------------------


def _resolve_allreduce_algorithm(comm: P2PCommunicator, arr: torch.Tensor,
                                 algorithm: str) -> Optional[str]:
    """The algorithm a clone's blocking allreduce would run (its arena
    always declines): tuned rows first, the seed constants otherwise.
    None = not a plannable wire algorithm (compressed, or an unknown name:
    the thread path raises for those)."""
    if algorithm in ("auto", "sm", "fused"):
        pick = None
        if algorithm in ("auto", "fused") and comm.size > 1:
            pick = _tuning.pick(
                comm, "allreduce", arr.nbytes,
                ("ring", "rabenseifner", "reduce_bcast")
                + (("recursive_halving",)
                   if schedules.is_pow2(comm.size) else ())
                + _coll_sm.gate(comm))
        if pick is not None and pick != "sm":
            return pick
        return seed_allreduce_algorithm(arr.nbytes, comm.size)
    if algorithm in ("ring", "rabenseifner", "reduce_bcast"):
        return algorithm
    if algorithm == "recursive_halving" and schedules.is_pow2(comm.size):
        return algorithm
    return None


def _allreduce_steps(algorithm: str, p: int, r: int, n: int) -> Tuple:
    key = ("allreduce", algorithm, p, r, n)
    if algorithm == "reduce_bcast":
        return _plan(key, lambda: tuple(
            schedules.reduce_bcast_allreduce_steps(p, r, n)))
    offs = schedules.chunk_offsets(n, p)
    build = {"ring": schedules.ring_allreduce_steps,
             "recursive_halving": schedules.halving_allreduce_steps,
             "rabenseifner": schedules.rabenseifner_allreduce_steps}[algorithm]
    return _plan(key, lambda: tuple(build(p, r, offs)))


def _reduction_tensor(comm: P2PCommunicator, obj: Any) -> Optional[torch.Tensor]:
    """A reduction payload as a tensor, or None when it cannot be one (a
    string, an object): the thread path then raises the blocking call's
    own error at wait()."""
    try:
        return _as_tensor(obj, comm.device)
    except (TypeError, ValueError, RuntimeError):
        return None


def _build(parent: P2PCommunicator, kind: str, args: tuple,
           kwargs: dict) -> Optional[dict]:
    """Phase 1, pure: validate, resolve and compile.  Returns the build
    dict (plan, buffers, finisher) or None when this call cannot ride a
    state machine (the thread path then re-raises any user error at
    wait())."""
    p, r = parent.size, parent.rank
    if kind == "iallreduce":
        obj, = args
        op = kwargs.get("op", _ops.SUM)
        if kwargs.get("compress_key") is not None:
            return None  # top-k residual state: the blocking path owns it
        arr = _reduction_tensor(parent, obj)
        if arr is None:
            return None
        if _SM_MAX_BYTES and arr.nbytes > _SM_MAX_BYTES:
            return None  # bandwidth regime: the segmented thread path
        algorithm = _resolve_allreduce_algorithm(
            parent, arr, kwargs.get("algorithm", "auto"))
        if algorithm is None:
            return None
        if p == 1:
            return {"done": arr.detach().clone()}
        work = _flat_copy(arr)
        shape = arr.shape
        return {
            "mode": "span", "send_ahead": 1, "op": op, "work": work,
            "steps": _allreduce_steps(algorithm, p, r, work.numel()),
            "finish": lambda sm: sm._work.view(shape),
        }

    if kind == "ireduce":
        obj, = args
        op = kwargs.get("op", _ops.SUM)
        root = int(kwargs.get("root", 0))
        if not (0 <= root < p):
            return None  # the thread path raises the standard error
        arr = _reduction_tensor(parent, obj)
        if arr is None:
            return None
        if _SM_MAX_BYTES and arr.nbytes > _SM_MAX_BYTES:
            return None
        if p == 1:
            return {"done": arr.detach().clone()}
        work = _flat_copy(arr)
        shape = arr.shape
        is_root = r == root
        return {
            "mode": "span", "send_ahead": 1, "op": op, "work": work,
            "steps": _plan(("reduce", p, r, root, work.numel()), lambda: tuple(
                schedules.reduce_tree_steps(p, r, root, work.numel()))),
            "finish": lambda sm: sm._work.view(shape) if is_root else None,
        }

    if kind == "ibcast":
        obj, = args
        root = int(kwargs.get("root", 0))
        if not (0 <= root < p):
            return None
        if p == 1:
            return {"done": obj}
        vals = [obj if r == root else None]
        return {
            "mode": "value", "send_ahead": 1, "svals": vals, "rvals": vals,
            "steps": _plan(("bcast", p, r, root), lambda: tuple(
                schedules.bcast_value_steps(p, r, root))),
            "finish": lambda sm: sm._rvals[0],
        }

    if kind == "iallgather":
        obj, = args
        if p == 1:
            return {"done": [obj]}
        vals: List[Any] = [None] * p
        vals[r] = obj
        return {
            "mode": "value", "send_ahead": 1, "svals": vals, "rvals": vals,
            "steps": _plan(("allgather", p, r), lambda: tuple(
                schedules.allgather_ring_value_steps(p, r))),
            "finish": lambda sm: _maybe_stack(obj, list(sm._rvals)),
        }

    if kind == "ialltoall":
        orig, = args
        try:
            if len(orig) != p:
                return None  # the thread path raises the standard error
        except TypeError:
            return None
        objs = list(orig)
        if p == 1:
            return {"done": _maybe_stack(orig, [objs[0]])}
        if _SM_MAX_BYTES and max(
                (payload_nbytes(o) or 0) for o in objs) > _SM_MAX_BYTES:
            return None  # bandwidth regime (rank-local gate, see above)
        rvals: List[Any] = [None] * p
        rvals[r] = objs[r]
        return {
            "mode": "value", "send_ahead": _SEG_WINDOW,
            "svals": objs, "rvals": rvals,
            "steps": _plan(("alltoall", p, r), lambda: tuple(
                schedules.alltoall_value_steps(p, r))),
            # stack against the ORIGINAL payload (a [P, ...] tensor input
            # stacks, a list of unequal blocks does not): blocking parity
            "finish": lambda sm, _orig=orig: _maybe_stack(
                _orig, list(sm._rvals)),
        }

    if kind == "ireduce_scatter":
        blocks, = args
        op = kwargs.get("op", _ops.SUM)
        if kwargs.get("algorithm", "auto") not in ("auto", "ring", "fused",
                                                   "sm"):
            return None  # compressed / sm / unknown: the blocking path
        try:
            if len(blocks) != p:
                return None
        except TypeError:
            return None
        try:
            arr = parent._blocks_as_array(blocks)
        except (TypeError, ValueError, RuntimeError):
            arr = None
        if arr is None:
            return None  # heterogeneous blocks: the generic thread path
        if _SM_MAX_BYTES and arr.nbytes > _SM_MAX_BYTES:
            return None
        if p == 1:
            return {"done": _as_tensor(blocks[0], parent.device).detach().clone()}
        shape = arr.shape[1:]
        work = (_flat_copy(arr) if isinstance(blocks, torch.Tensor)
                else arr.reshape(-1))
        bn = work.numel() // p
        return {
            "mode": "span", "send_ahead": 1, "op": op, "work": work,
            "steps": _plan(("reduce_scatter", p, r, work.numel()), lambda: tuple(
                schedules.block_ring_reduce_scatter_steps(p, r, bn))),
            # one-shot: copy the owned block out so the P-times-larger
            # working buffer is not pinned by a small result
            "finish": lambda sm: sm._work[r * bn:(r + 1) * bn].view(shape).clone(),
            # persistent rounds own their buffers: the result is a view
            "span_view": lambda sm: sm._work[r * bn:(r + 1) * bn].view(shape),
        }

    if kind == "ibarrier":
        if p == 1:
            return {"done": None}
        return {
            "mode": "value", "send_ahead": 1, "svals": [], "rvals": [],
            "steps": _plan(("barrier", p, r), lambda: tuple(
                schedules.barrier_value_steps(p, r))),
            "finish": lambda sm: None,
        }

    if kind == "igather":
        obj, = args
        root = int(kwargs.get("root", 0))
        if not (0 <= root < p):
            return None
        if p == 1:
            return {"done": [obj]}
        if r == root:
            rvals = [None] * p
            rvals[r] = obj
            steps = ((tuple(), tuple((s, s) for s in range(p) if s != root)),)
            return {"mode": "value", "send_ahead": 1, "svals": rvals,
                    "rvals": rvals, "steps": steps,
                    "finish": lambda sm: list(sm._rvals)}
        vals = [obj]
        return {"mode": "value", "send_ahead": 1, "svals": vals,
                "rvals": vals, "steps": ((((root, 0),), tuple()),),
                "finish": lambda sm: None}

    if kind == "iscatter":
        objs, = args
        root = int(kwargs.get("root", 0))
        if not (0 <= root < p):
            return None
        if r == root:
            try:
                if objs is None or len(objs) != p:
                    return None  # the thread path raises the standard error
            except TypeError:
                return None
            objs = list(objs)
            if p == 1:
                return {"done": objs[0]}
            steps = ((tuple((d, d) for d in range(p) if d != root), tuple()),)
            return {"mode": "value", "send_ahead": 1, "svals": objs,
                    "rvals": objs, "steps": steps,
                    "finish": lambda sm, _root=root: sm._svals[_root]}
        vals = [None]
        return {"mode": "value", "send_ahead": 1, "svals": vals,
                "rvals": vals, "steps": ((tuple(), ((root, 0),)),),
                "finish": lambda sm: sm._rvals[0]}

    return None


def _launch(parent: P2PCommunicator, kind: str, build: dict,
            child: Optional[P2PCommunicator] = None) -> Request:
    _mpit.count(collectives=1)  # thread rounds count in the blocking call
    if "done" in build:
        return _CompletedRequest(build["done"])
    if child is None:
        child = parent._nbc_comm()
    _mpit.count(nbc_state_machines=1)
    sm = _SMColl(parent, child, kind, build["mode"], build["steps"],
                 build["send_ahead"], build.get("work"), build.get("svals"),
                 build.get("rvals"), build.get("op"), build["finish"])
    return sm._arm()


def try_state_machine(parent: P2PCommunicator, kind: str, *args: Any,
                      **kwargs: Any) -> Optional[Request]:
    """The i-collectives' state-machine attempt: a Request when this call
    compiled onto the engine, None to take the thread path.  The caller
    checked engine-on and the mode."""
    build = _build(parent, kind, args, kwargs)
    if build is None:
        return None
    return _launch(parent, kind, build)


# -- MPI-4 persistent collectives --------------------------------------------


PERSISTENT_KINDS = ("allreduce", "bcast", "alltoall", "reduce_scatter")


def _bound_tensor(obj: Any) -> Optional[torch.Tensor]:
    """The bound buffer of a persistent reduction as one tensor (blocks
    stacked), or None for ragged or object payloads."""
    if isinstance(obj, torch.Tensor):
        return obj
    try:
        return torch.stack([torch.as_tensor(b) for b in obj])
    except (TypeError, ValueError, RuntimeError):
        return None


class PersistentColl(Request):
    """A planned collective handle (MPI_Allreduce_init & co.).

    Init hoists one private child context for every round, the algorithm
    resolution, the compiled schedule and the working buffers.
    ``start()`` re-reads the bound buffer, re-posts the plan's receives on
    the same context and fires; rounds on one context never cross-match,
    since start() requires the previous round complete and every rank
    starts its persistent collectives in the same order.

    Engine-compiled allreduce and reduce_scatter rounds alternate two
    preallocated working buffers: round k's result is a view of one and
    stays valid until round k+2 starts (copy it to hold it longer).  With
    the runtime verifier on, the signature is checked once here (frozen
    per round: the argument list is bound) and the contract is fenced
    (``_fence_check``).
    """

    def __init__(self, parent: P2PCommunicator, kind: str, args: tuple,
                 kwargs: dict) -> None:
        self._parent = parent
        self._kind = kind
        self._args, self._kwargs = args, kwargs
        self._child = parent._nbc_comm()
        self._child._coll_name = kind
        self._req: Optional[Request] = None
        self._last: Any = None
        self._started = False
        self._dbl: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._round = 0
        # verify-mode fence: weakref per working buffer to the round
        # result handed out from it
        self._pinned: List[Optional["weakref.ref"]] = [None, None]
        with _on_default_stream(parent.device):
            self._build0 = _build(parent, "i" + kind, args, kwargs)
        self._geometry = self._payload_geometry()
        if (kind == "allreduce" and self._build0 is not None
                and "done" not in self._build0):
            # the geometry is bound, so is the resolution
            resolved = _resolve_allreduce_algorithm(
                parent, _as_tensor(args[0], parent.device),
                kwargs.get("algorithm", "auto"))
            if resolved is not None:
                self._kwargs = {**kwargs, "algorithm": resolved}
        if parent._verify is not None and parent.size > 1:
            payload = None
            if kind in ("allreduce", "reduce_scatter"):
                # block 0 for reduce_scatter: the blocking path's exact
                # signature geometry
                payload = _as_tensor(args[0] if kind == "allreduce"
                                     else args[0][0], parent.device)
            self._child._verify_coll(
                kind, root=kwargs.get("root"), op=kwargs.get("op"),
                payload=payload, algorithm=kwargs.get("algorithm", "auto"))
            self._child._verify_sig_frozen = True

    def _payload_geometry(self) -> Optional[Tuple]:
        if self._kind in ("allreduce", "reduce_scatter"):
            arr = (_bound_tensor(self._args[0]) if self._kind == "reduce_scatter"
                   else _reduction_tensor(self._parent, self._args[0]))
            if arr is None:
                return None  # ragged blocks: the generic rounds own them
            return (tuple(arr.shape), arr.dtype)
        return None

    @property
    def active(self) -> bool:
        return self._req is not None

    def start(self) -> "PersistentColl":
        if self._req is not None and not self._req.test()[0]:
            raise RuntimeError(
                "start() while the previous round of this persistent "
                "collective is still in flight (wait() it first)")
        _mpit.count(persistent_starts=1)
        self._started = True
        if self._geometry is not None:
            arr = (_bound_tensor(self._args[0]) if self._kind == "reduce_scatter"
                   else _reduction_tensor(self._parent, self._args[0]))
            got = None if arr is None else (tuple(arr.shape), arr.dtype)
            if got != self._geometry:
                raise ValueError(
                    f"persistent {self._kind}: bound buffer geometry changed "
                    f"since init ({self._geometry} -> {got}); MPI persistent "
                    f"collectives bind the argument list")
        with _on_default_stream(self._parent.device):
            build = self._round_build()
            if build is not None:
                self._req = _launch(self._parent, "i" + self._kind, build,
                                    child=self._child)
            else:
                fn = getattr(self._child, self._kind)
                a, kw = self._args, self._kwargs
                self._req = _ThreadRequest(lambda: fn(*a, **kw),
                                           self._parent.device)
        return self

    def _round_build(self) -> Optional[dict]:
        """Per-start plan refresh: the compiled steps reused, the bound
        buffer re-read (a start-time snapshot).  None = the thread round
        (no engine, nbc_mode thread, or an uncompilable payload)."""
        if (self._build0 is None or self._parent._progress is None
                or _MODE != "auto"):
            return None
        if (self._kind in ("allreduce", "reduce_scatter")
                and "done" not in self._build0):
            # only the working buffer's CONTENT changes per start: two
            # preallocated buffers alternate; the ownership layer is told
            # before the overwrite (retained frames of round k-2)
            if self._dbl is None:
                w = self._build0["work"]
                self._dbl = (torch.empty_like(w), torch.empty_like(w))
            i = self._round & 1
            if self._parent._verify is not None:
                self._fence_check(i)
            buf = self._dbl[i]
            self._round += 1
            _bufpool.touch(buf)
            src = (_bound_tensor(self._args[0]) if self._kind == "reduce_scatter"
                   else _as_tensor(self._args[0], self._parent.device))
            buf.copy_(src.detach().reshape(-1))
            build = {**self._build0, "work": buf}
            view = self._build0.get("span_view")
            if view is not None:
                build["finish"] = view
            return build
        # value plans and size-1 builds re-run: start() promises a
        # start-time read of the bound buffer
        return _build(self._parent, "i" + self._kind, self._args, self._kwargs)

    def _note_result(self, value: Any) -> None:
        """Verify mode: remember (weakly) which working buffer this
        round's result is a view of, so _fence_check can tell whether
        the caller still holds it when the buffer comes back around.
        A view is found by its bytes: same device, overlapping span of
        the working buffer."""
        if (self._parent._verify is None or self._dbl is None
                or not isinstance(value, torch.Tensor)):
            return
        from .verify.state import buffer_span

        dev, lo, hi = buffer_span(value)
        for i in (0, 1):
            # a value that IS the buffer cannot be told from our own ref
            if value is self._dbl[i]:
                continue
            bdev, blo, bhi = buffer_span(self._dbl[i])
            if dev == bdev and lo < bhi and blo < hi:
                self._pinned[i] = weakref.ref(value)
                return

    def _fence_check(self, i: int) -> None:
        """The double-buffer contract, fenced: if the caller still holds
        the result that buffer ``i`` backs when start() would overwrite
        it, raise BufferPinnedError instead of silently invalidating it.
        The handle's own ``_last`` is no caller pin."""
        ref = self._pinned[i]
        if ref is None:
            return
        obj = ref()
        if obj is not None and obj is not self._last:
            # a dropped reference may merely await collection
            obj = None
            gc.collect()
            obj = ref()
        if obj is None or obj is self._last:
            self._pinned[i] = None
            return
        raise BufferPinnedError(
            f"persistent {self._kind}: start() would overwrite the "
            f"round-{self._round - 2 if self._round >= 2 else 0} result "
            f"the caller still references (double-buffer grace is one "
            f"round); copy it first (result.clone())")

    def wait(self) -> Any:
        if self._req is None:
            if not self._started:
                raise RuntimeError(
                    "wait() before start() on a persistent collective")
            return self._last
        req = self._req
        value = req.wait()
        self._last, self._req = value, None
        if isinstance(req, _SMColl):
            req._result = None  # the handle is the result's only consumer
        self._note_result(value)
        return value

    def test(self) -> Tuple[bool, Any]:
        if self._req is None:
            return (True, self._last) if self._started else (False, None)
        req = self._req
        done, value = req.test()
        if done:
            self._last, self._req = value, None
            if isinstance(req, _SMColl):
                req._result = None
            self._note_result(value)
        return done, value


# positional-argument names of each persistent kind, mirroring the
# blocking methods: persistent_init turns positionals into kwargs so
# _build and the thread rounds read one form
_PERSISTENT_SIG = {
    "allreduce": ("op", "algorithm", "compress_key"),
    "bcast": ("root", "algorithm"),
    "alltoall": ("algorithm",),
    "reduce_scatter": ("op", "algorithm"),
}


def persistent_init(comm: P2PCommunicator, kind: str, payload: Any,
                    *args: Any, **kwargs: Any) -> PersistentColl:
    if kind not in PERSISTENT_KINDS:
        raise ValueError(
            f"no engine-owned persistent plan for {kind!r}; have "
            f"{list(PERSISTENT_KINDS)}")
    names = _PERSISTENT_SIG[kind]
    if len(args) > len(names):
        raise TypeError(
            f"{kind}_init takes at most {1 + len(names)} positional "
            f"arguments ({('payload',) + names}), got {1 + len(args)}")
    for name, value in zip(names, args):
        if name in kwargs:
            raise TypeError(f"{kind}_init got {name!r} twice")
        kwargs[name] = value
    return PersistentColl(comm, kind, (payload,), kwargs)
