"""Resident world server: MPI as a service over a warm worker pool — the
port's own copy of ``mpi_tpu/serve.py`` (framing :123-160,
``_admission_order`` :161, error shipping :175-200, the job payloads
:202-270, the worker :273-584, ``_Worker`` / ``_Pool`` :590-632,
``WorldServer`` :635-1912, ``WorldLease`` :1918, ``ServerClient`` :1965,
``connect`` :2123, ``main`` :2178), federation seams included.

Many small worlds churned at a high rate are the shape this serves: the
cold path (start N interpreters, import torch, bind ports, handshake
rings) costs seconds per world, so it is kept warm:

* ``WorldServer`` (``python -m mpi_tpu_torch.launcher serve``) starts
  ``pool_size`` worker processes once, each holding its live transport
  endpoints (socket connections, or shm rings and pre-mapped arenas) and
  an enabled fault detector, then leases sub-worlds to clients: an
  acquire is one control round trip that reserves idle slots, and a job
  builds its communicator locally on every leased worker from ``(slots,
  job_id)`` over the warm transport.
* ``mpi_tpu_torch.connect(addr)`` is the client: ``acquire(nranks)`` ->
  ``lease.run(fn, *args)`` -> ``release()``.  ``fn`` is pickled by
  reference (the workers import the same code) and runs as ``fn(comm,
  *args)`` on every leased worker; rank 0's return value comes back.
  Every lease completes or raises a named error: a worker death inside a
  collective reaches the client as ``ProcFailedError``
  (``MPI_ERR_PROC_FAILED``) within the detection bound, never a hang.
* Self-healing (``membership.py``): the server watches worker liveness
  (child exit and heartbeat files); a death bumps the pool's membership
  epoch, the survivors drop the corpse's endpoints
  (``survivor_transition``), and a replacement worker rejoins the world
  under the new epoch through the claim / admit / ready protocol.
* Federation (``federation.py``, ``federation_store.py``): servers given
  one namespace (``federation=``, ``launcher serve --federation``; a
  directory or a ``raft:`` spec) renew endpoint records, elect a leader
  and adopt a dead server's pool, whose orphaned workers re-register with
  the survivor (``MPI_TPU_SERVE_FED`` in their environment, within
  ``orphan_timeout_s``); ``connect`` of a namespace or a server list
  returns a :class:`~mpi_tpu_torch.federation.FederatedClient` that fails
  over.  A server on the minority side of a store partition refuses new
  leases with ``NoQuorumError`` (``MPI_TPU_SERVE_STORE_FENCE``, default
  on).

Wire protocol: length-prefixed pickle frames on a local TCP socket.  The
server alone coordinates membership, so the workers run no agreement
rounds; their fault detectors only turn blocked waits into errors.

What differs from the reference (ROADMAP "Recorded differences"):

* A worker is ``python -m mpi_tpu_torch.serve --worker`` on a device: it
  binds ``MPI_TPU_DEVICE`` (the server's ``env_extra``, the launcher's
  ``serve --device`` or the server's own environment), else card
  ``slot % device_count``; with neither a card nor ``cpu`` it raises as
  ``init()`` does, and ``WorldServer.start()`` fails with
  :class:`WorkerStartError` (never a CPU fallback).  The jobs' tensors
  live on the worker's device.
* Rank 0's return value is moved to the CPU (every tensor in it) before
  it is pickled to the server, so a client without a card can read it.
* The pool's rendezvous directory is ``mtt_serve_*`` (the reference's
  ``mpi_tpu_serve_*``) and its pooled arenas are ``/mtt_<session>_*``.
* An orphaned worker keeps its process, its CUDA context and its device
  through a takeover: a lease on the adopted pool runs on the same card
  as before.  A port server and a reference server never share a
  namespace (their workers run different packages).
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import membership
from . import mpit as _mpit
from . import telemetry as _telemetry
from .errors import (DeadlockError, EpochSkewError, NoQuorumError,
                     ProcFailedError, RejoinRefusedError, RevokedError,
                     ServerBusyError, error_class)
from .membership import ENV_DEVICE
from .transport.base import RecvTimeout, TransportError
from .transport.socket import _recv_exact

_FRAME = struct.Struct("!I")
_HOST = "127.0.0.1"
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# serve defaults; constructor and CLI arguments override them per server
_POOL_SIZE = 4
_WORLD_LEASE_TIMEOUT_S = 30.0   # acquire wait and default run bound
_REJOIN_TIMEOUT_S = 20.0        # one healing round's handshake bound
_DETECT_TIMEOUT_S = 2.0         # pool-internal fault detection bound
_HEARTBEAT_S = 0.25

# Worker pvars piggybacked on every job_done reply and pushed while idle:
# the server keeps the latest snapshot per slot and stats() and the
# metrics endpoint sum them.
_WORKER_PVARS = ("msgs_sent", "collectives_started", "link_reconnects",
                 "link_faults_masked", "coll_sm_hits",
                 "proc_failures_detected", "epoch_skews_detected",
                 "trace_events")

# Sliding window of the worlds/s gauge (per-second completion buckets).
_RATE_WINDOW_S = 60.0

# Idle-worker pvar push cadence, and the orphaned-worker budget: a worker
# whose server died polls the federation namespace this long for the
# survivor that adopted its pool before it gives up and exits.
_PVAR_PUSH_S = 1.0
_ORPHAN_TIMEOUT_S = 60.0

# Slack added to a timeout-bearing request's client-side reply bound: it
# only turns an infinite wedge (a frozen server whose connection stays
# established) into a finite ServerLostError.
_RPC_GRACE_S = 15.0

# Bounded admission queue: acquires past this many waiting requests are
# rejected at once with ServerBusyError.
_MAX_PENDING = 64

# Federation leader-lease bound (federation.py): authority self-expires at
# half this, takeover fires past it.
_FED_LEASE_TIMEOUT_S = 3.0


class ServerLostError(TransportError):
    """The control connection to the world server died mid-request (the
    server process was killed or went away).  Distinct from a
    server-shipped TransportError (a worker-side failure relayed by a
    live server); an in-flight ``lease.run`` surfaces it by name."""


class WorkerStartError(RuntimeError):
    """A pool worker exited before it joined the pool at
    ``WorldServer.start()`` — most often a worker with no device: no card
    and no ``MPI_TPU_DEVICE``.  Its traceback is on the server's
    stderr."""


# -- framing ------------------------------------------------------------------


def _send_msg(sock: socket.socket, lock: Optional[threading.Lock],
              msg: dict) -> None:
    blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    frame = _FRAME.pack(len(blob)) + blob
    if lock is None:
        sock.sendall(frame)
    else:
        with lock:
            sock.sendall(frame)


def _recv_msg(sock: socket.socket) -> Optional[dict]:
    head = _recv_exact(sock, _FRAME.size)
    if head is None:
        return None
    (n,) = _FRAME.unpack(head)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return pickle.loads(body)


# -- error shipping -----------------------------------------------------------

_ERROR_KINDS = {
    "ProcFailedError": ProcFailedError,
    "RevokedError": RevokedError,
    "DeadlockError": DeadlockError,
    "EpochSkewError": EpochSkewError,
    "RejoinRefusedError": RejoinRefusedError,
    "RecvTimeout": RecvTimeout,
    "TransportError": TransportError,
    "ServerBusyError": ServerBusyError,
    "ServerLostError": ServerLostError,
    "NoQuorumError": NoQuorumError,
}


def _admission_order(waiters: List[dict], grants: Dict[str, int]
                     ) -> List[dict]:
    """Scheduling order of the waiting acquires: strict priority first,
    then fair share (fewest leases already granted to the waiter's client
    identity), then FIFO.  The grant loop walks this order and admits the
    first waiter the idle capacity can satisfy (work-conserving: an
    unsatisfiable large request keeps its place, bounded by the lease
    timeout, and does not idle the pool)."""
    return sorted(waiters, key=lambda w: (-w["priority"],
                                          grants.get(w["client"], 0),
                                          w["seq"]))


def _pack_error(exc: BaseException) -> dict:
    return {"kind": type(exc).__name__, "code": error_class(exc),
            "msg": str(exc),
            "failed": list(getattr(exc, "failed", ()) or ()),
            "collective": getattr(exc, "collective", None)}


def _raise_error(err: dict) -> None:
    """Re-raise a shipped worker or server error on the client under its
    own name: ``except ProcFailedError`` works across the wire."""
    kind = err.get("kind", "RuntimeError")
    msg = err.get("msg", "remote failure")
    if kind == "LeaseTimeout":
        raise TimeoutError(msg)
    cls = _ERROR_KINDS.get(kind)
    if cls is ProcFailedError:
        raise ProcFailedError(msg, failed=err.get("failed", ()),
                              collective=err.get("collective"))
    if cls is not None:
        raise cls(msg)
    raise RuntimeError(f"{kind}: {msg}")


def _to_cpu(obj: Any) -> Any:
    """``obj`` with every tensor in it (through tuples, lists and dicts)
    moved to the CPU: what a worker ships back is readable anywhere."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_cpu(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


# -- built-in jobs ------------------------------------------------------------


def job_allreduce(comm, n: int = 1024) -> float:
    """The demo lease payload: an allreduce of ``n`` float32 values of
    ``rank + 1`` on the worker's device.  Returns sum(1..P), so the client
    can check that the world really ran."""
    import torch

    out = comm.allreduce(torch.full((int(n),), comm.rank + 1.0,
                                    dtype=torch.float32, device=comm.device))
    return float(out[0])


def job_kill_rank(comm, victim: int = 1, n: int = 4096) -> float:
    """Chaos payload: lease rank ``victim`` dies without cleanup inside the
    leased world (after the barrier, so every rank has entered the job)
    while the others run a ring allreduce on it.  The survivors surface
    ProcFailedError; the client sees MPI_ERR_PROC_FAILED."""
    import torch

    comm.barrier()
    if comm.rank == victim:
        os._exit(137)
    out = comm.allreduce(torch.ones(int(n), dtype=torch.float32,
                                    device=comm.device), algorithm="ring")
    return float(out[0])


def job_sleep(comm, seconds: float = 0.1) -> int:
    comm.barrier()
    time.sleep(float(seconds))
    return comm.rank


def job_allreduce_arena(comm, n: int = 1024) -> tuple:
    """Arena lease payload: one auto-routed allreduce, returning ``(value,
    coll_sm_hits delta, live arena names)`` from lease rank 0, so the
    client can check that the lease rode the pooled arena (hits > 0 on a
    shm pool; 0 on a socket pool, which has no arena)."""
    import torch

    from . import coll_sm as _coll_sm

    before = _mpit.pvar_read("coll_sm_hits")
    out = comm.allreduce(torch.full((int(n),), comm.rank + 1.0,
                                    dtype=torch.float32, device=comm.device))
    hits = _mpit.pvar_read("coll_sm_hits") - before
    return (float(out[0]), int(hits), sorted(_coll_sm.live_arenas()))


def job_allreduce_link_chaos(comm, n: int = 1024, resets: int = 2) -> float:
    """Link-chaos lease payload: each leased rank hard-resets its cached
    connection to the next rank ``resets`` times while running ring
    allreduces, so the lease rides healed links (no ProcFailedError, no
    wrong result).  Returns the last allreduce's value.  On a transport
    without connection links (shm) the injector is absent and this is
    ``job_allreduce``."""
    import torch

    inject = getattr(comm._t, "_inject_link_reset", None)
    comm.barrier()
    out = None
    for i in range(int(resets) + 1):
        if inject is not None and i < int(resets) and comm.size > 1:
            inject(comm._group[(comm.rank + 1) % comm.size])
        out = comm.allreduce(
            torch.full((int(n),), comm.rank + 1.0, dtype=torch.float32,
                       device=comm.device), algorithm="ring")
    return float(out[0])


# -- the worker process -------------------------------------------------------


def _worker_main() -> int:
    """Body of one pool worker (``python -m mpi_tpu_torch.serve
    --worker``): bring the world transport up on the worker's device (a
    fresh pool member through ``init()``, or a replacement rejoining under
    ``MPI_TPU_SERVE_REJOIN=epoch:slot``), then serve jobs from the control
    connection.  A control reader thread applies membership transitions at
    once (even mid-job), while the main thread runs one job at a time.

    Under a federation namespace (``MPI_TPU_SERVE_FED``) the worker
    survives its server: on control-channel EOF it polls the namespace
    for the survivor that adopted its pool and re-registers there,
    keeping its warm transport, arenas, fault detector and device.
    Without a namespace a worker whose server goes away exits (non-zero,
    with a line on stderr): there is nothing to fail over to."""
    import atexit
    import faulthandler
    import signal as _signal

    import torch

    from . import _rank_device
    from . import coll_sm as _coll_sm
    from . import ft as _ft
    from . import init as _init
    from .communicator import P2PCommunicator
    from .gpu import primitives

    # the server sends SIGUSR2 to a worker whose job blew the lease
    # timeout, so its stacks land on the inherited stderr
    faulthandler.register(_signal.SIGUSR2, all_threads=True, chain=True)

    detect = os.environ.get("MPI_TPU_SERVE_DETECT_S")
    if detect:
        _mpit.cvar_write("fault_detect_timeout_s", float(detect))
    hb = os.environ.get("MPI_TPU_SERVE_HEARTBEAT_S")
    if hb:
        _mpit.cvar_write("fault_heartbeat_interval_s", float(hb))
    rdv = os.environ["MPI_TPU_RDV"]
    backend = os.environ.get("MPI_TPU_BACKEND", "socket")
    rejoin_spec = os.environ.get("MPI_TPU_SERVE_REJOIN")
    if rejoin_spec:
        epoch, slot = (int(x) for x in rejoin_spec.split(":"))
        rj_timeout = float(os.environ.get(
            "MPI_TPU_SERVE_REJOIN_TIMEOUT_S", 0) or 0) or None
        # raises before any claim without a device (never a fallback)
        dev = _rank_device(slot)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # init() enables tracing from the environment; the rejoin path
        # builds its transport directly, so mirror it before the handshake
        _telemetry.enable_from_env(rank=slot)
        t, _ann = membership.rejoin_transport(
            rdv, slot=slot, epoch=epoch, backend=backend,
            timeout=rj_timeout, device=dev)
        primitives.bind_host_rank(t.world_rank, dev, process=True)
        home = P2PCommunicator(t, range(t.world_size), ("epoch", epoch))
        home._mark_generation()
        _ft.enable(home, rdv_dir=rdv)
        # stop the detector and close the transport before the
        # interpreter finalizes (a helper thread inside a torch call there
        # aborts the process), as init() does
        atexit.register(home.close_transport)
        # readiness after ft.enable: the heartbeat file must be fresh
        # before the survivors are told to re-admit this slot
        membership.publish_ready(rdv, epoch, t.world_rank)
        _mpit.count(rejoins=1)
    else:
        # a fresh pool member: the detector starts after the start
        # barrier, as init() starts it under MPI_TPU_FT (the server sets
        # no MPI_TPU_FT)
        home = _init()
        t = home._t
        membership.await_incarnations(rdv, t.world_size)
        _ft.enable(home, rdv_dir=rdv)
    world_ft = t._ft_world
    slot = t.world_rank

    pool_id = (os.environ.get("MPI_TPU_SERVE_POOL")
               or os.path.basename(rdv.rstrip("/")))
    fed_ns = os.environ.get("MPI_TPU_SERVE_FED") or None
    orphan_timeout = float(os.environ.get(
        "MPI_TPU_SERVE_ORPHAN_TIMEOUT_S", str(_ORPHAN_TIMEOUT_S)))
    ctrl_addr = os.environ["MPI_TPU_SERVE_CTRL"]
    dead_addr: Optional[str] = None
    orphan_deadline: Optional[float] = None
    rc = 0
    while True:
        outcome = _worker_serve_one(ctrl_addr, t, world_ft, slot, pool_id)
        if outcome == "shutdown":
            break
        if fed_ns is None:
            # loudly: a dial failure while the server lives would
            # otherwise crash-loop heal and respawn without a line of
            # diagnosis
            sys.stderr.write(
                f"mpi_tpu_torch.serve: worker slot {slot} (pool {pool_id}) "
                f"control channel {outcome} (server {ctrl_addr}); no "
                f"federation namespace to fail over to - exiting\n")
            rc = 1
            break
        # the pool outlives its server: resolve the survivor that adopted
        # it and re-register there, everything warm staying warm.  Only an
        # established registration dying ("lost") excludes its address
        # and renews the orphan budget; a failed dial ("unreachable") must
        # not, since the current owner may be live but briefly swamped
        from . import federation as _federation

        now = time.monotonic()
        if outcome == "lost":
            dead_addr = ctrl_addr
            orphan_deadline = now + orphan_timeout
        elif orphan_deadline is None:
            orphan_deadline = now + orphan_timeout
        remaining = orphan_deadline - now
        new_ctrl = _federation.wait_pool_owner(
            fed_ns, pool_id, not_ctrl=dead_addr,
            timeout=remaining) if remaining > 0 else None
        if new_ctrl is None:
            sys.stderr.write(
                f"mpi_tpu_torch.serve: worker slot {slot} (pool {pool_id}) "
                f"orphaned: no reachable pool owner within "
                f"{orphan_timeout}s - exiting\n")
            break
        ctrl_addr = new_ctrl
    # orderly pool shutdown: a worker set that never leased again after
    # its last job has nobody else to unlink its pooled arena
    _coll_sm.retire_pooled(t)
    return rc


def _worker_serve_one(ctrl_addr: str, t, world_ft, slot: int,
                      pool_id: str) -> str:
    """One control-connection lifetime of a pool worker: dial, hello,
    serve jobs until an orderly ``shutdown`` op (-> "shutdown"), the
    established registration dying (-> "lost"), or a failed dial or
    hello (-> "unreachable")."""
    import queue

    from . import ft as _ft
    from .communicator import P2PCommunicator
    from .resilience import retry_connect

    host, port = ctrl_addr.rsplit(":", 1)
    try:
        ctrl = retry_connect(
            lambda: socket.create_connection((host, int(port)),
                                             timeout=10.0),
            timeout_s=10.0)
    except OSError:
        return "unreachable"
    ctrl.settimeout(None)
    ctrl.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    send_lock = threading.Lock()
    try:
        _send_msg(ctrl, send_lock, {
            "op": "hello", "slot": slot, "pool": pool_id,
            "pid": os.getpid(),
            "incarnation": membership.incarnation(), "epoch": t.epoch})
    except OSError:
        ctrl.close()
        return "unreachable"

    jobs: "queue.Queue[Optional[dict]]" = queue.Queue()
    shutdown = threading.Event()  # orderly stop against connection death
    gone = threading.Event()      # this connection is finished

    def reader() -> None:
        while True:
            try:
                msg = _recv_msg(ctrl)
            except OSError:
                msg = None
            if msg is None or msg.get("op") == "shutdown":
                if msg is not None:
                    shutdown.set()
                gone.set()
                jobs.put(None)
                return
            op = msg.get("op")
            if op == "job":
                jobs.put(msg)
            elif op == "transition":
                # observe() first: a job thread wedged in a ring-full send
                # to the corpse leaves through the suspect check, releasing
                # the per-destination send lock survivor_transition's
                # invalidate needs (the reverse order deadlocks this reader
                # against that sender for a whole detection bound).  Our
                # own slot is never observed failed.
                dead = [d for d in msg["dead"] if d != slot]
                for d in dead:
                    world_ft.observe(d, "server-declared dead "
                                        "(pool transition)")
                # even mid-job: the corpse's endpoints must go now
                membership.survivor_transition(t, msg["epoch"], dead)
                try:
                    _send_msg(ctrl, send_lock,
                              {"op": "transition_ack", "slot": slot,
                               "epoch": msg["epoch"]})
                except OSError:
                    pass  # the EOF path delivers the verdict next round
            elif op == "rejoined":
                world_ft.reset_rank(msg["slot"])
                t.min_peer_epoch[int(msg["slot"])] = int(msg["epoch"])

    threading.Thread(target=reader, daemon=True,
                     name=f"serve-ctrl-{slot}").start()

    fed_ns = os.environ.get("MPI_TPU_SERVE_FED") or None

    def pvar_push() -> None:
        # the snapshot also rides job_done; pushing it at a fixed cadence
        # lets stats() see idle and wedged workers too
        while not gone.wait(_PVAR_PUSH_S):
            try:
                _send_msg(ctrl, send_lock, {
                    "op": "pvars", "slot": slot,
                    "pvars": {n: _mpit.pvar_read(n)
                              for n in _WORKER_PVARS}})
            except OSError:
                return
            if fed_ns is None:
                continue
            # the frozen-master escape: a SIGSTOP'd server keeps this
            # connection established, so EOF alone never frees us.  If the
            # namespace names a live owner other than the server we serve,
            # our master was deposed while frozen: defect by closing the
            # connection, which drops us into the re-resolve.  Read here,
            # never on the job thread, so a running job is not held up
            from . import federation as _federation

            rec = _federation.read_pool_owner(fed_ns, pool_id)
            if rec is not None and rec.get("ctrl") \
                    and rec["ctrl"] != ctrl_addr:
                srv = _federation.read_server_record(
                    fed_ns, str(rec.get("owner")))
                if srv is None or _federation.record_live(srv):
                    sys.stderr.write(
                        f"mpi_tpu_torch.serve: worker slot {slot} (pool "
                        f"{pool_id}): ownership moved to "
                        f"{rec.get('owner')} while our master "
                        f"{ctrl_addr} held the connection - defecting\n")
                    gone.set()
                    try:
                        # shutdown first: a bare close() does not wake the
                        # reader blocked in recv()
                        ctrl.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        ctrl.close()
                    except OSError:
                        pass
                    return

    threading.Thread(target=pvar_push, daemon=True,
                     name=f"serve-pvars-{slot}").start()

    while True:
        msg = jobs.get()
        if msg is None:
            break
        job_id, slots = msg["job_id"], list(msg["slots"])
        rec = _telemetry.REC
        t_job = time.perf_counter_ns() if rec is not None else 0
        try:
            fn = pickle.loads(msg["fn"])
            args = pickle.loads(msg["args"])
            comm = P2PCommunicator(t, slots, ("lease", job_id))
            comm._ft = _ft.CommFT(world_ft, ("lease", job_id))
            # the arena through the pooled path: one epoch-stamped arena
            # per worker set, reused across leases.  The epoch is the
            # server's stamp shipped with the job, so every leased worker
            # keys the same segment even if a transition broadcast races
            # the dispatch
            comm._coll_sm_pool_ctx = ("lease-pool",
                                      int(msg.get("epoch", 0)))
            result = fn(comm, *args)
            reply = {"op": "job_done", "job_id": job_id, "slot": slot,
                     "ok": True}
            if comm.rank == 0:
                reply["result"] = pickle.dumps(
                    _to_cpu(result), protocol=pickle.HIGHEST_PROTOCOL)
        except BaseException as e:  # noqa: BLE001 - shipped to the client
            reply = {"op": "job_done", "job_id": job_id, "slot": slot,
                     "ok": False, "error": _pack_error(e)}
        if rec is not None:
            rec.emit("lease", "job",
                     dur_ns=time.perf_counter_ns() - t_job,
                     attrs={"job_id": job_id, "slots": slots,
                            "ok": reply["ok"],
                            "error": (reply.get("error") or {}).get(
                                "kind")})
        # the latest-per-slot pvar snapshot stats() sums
        reply["pvars"] = {n: _mpit.pvar_read(n) for n in _WORKER_PVARS}
        try:
            _send_msg(ctrl, send_lock, reply)
        except OSError:
            # the server went away mid-reply: the lease died with it
            gone.set()
            try:
                ctrl.close()
            except OSError:
                pass
            return "lost"
    try:
        ctrl.close()
    except OSError:
        pass
    return "shutdown" if shutdown.is_set() else "lost"


# -- the server ---------------------------------------------------------------


class _Worker:
    __slots__ = ("slot", "pool", "proc", "pid", "conn", "send_lock",
                 "state", "incarnation", "epoch", "lease_id",
                 "spawned_at")

    def __init__(self, slot: int, pool: str) -> None:
        self.slot = slot
        self.pool = pool
        self.proc: Optional[subprocess.Popen] = None
        # an adopted worker was never our child: no Popen handle, its
        # hello's pid and its heartbeat file carry its liveness
        self.pid: Optional[int] = None
        self.conn: Optional[socket.socket] = None
        self.send_lock = threading.Lock()
        self.state = "starting"  # starting|idle|leased|dead
        self.incarnation: Optional[str] = None
        self.epoch = 0
        self.lease_id: Optional[int] = None
        self.spawned_at = time.monotonic()


class _Pool:
    """One warm worker pool: a transport world over one rendezvous dir.  A
    server's home pool is started by ``start()``; an adopted pool arrives
    as metadata through :meth:`WorldServer.adopt_pool`, and worker-level
    healing runs the same announce / claim / admit protocol against its
    rendezvous dir."""

    __slots__ = ("pool_id", "rdv", "backend", "size", "epoch", "home",
                 "adopted_at", "owned_since")

    def __init__(self, pool_id: str, rdv: str, backend: str, size: int,
                 home: bool, epoch: int = 0) -> None:
        self.pool_id = pool_id
        self.rdv = rdv
        self.backend = backend
        self.size = int(size)
        self.epoch = int(epoch)
        self.home = home
        self.adopted_at = None if home else time.monotonic()
        self.owned_since = time.time()


class WorldServer:
    """The resident daemon: a pool of warm workers, leased as worlds.

    Use as a context manager (tests, in-process programs) or through
    ``python -m mpi_tpu_torch.launcher serve``.  ``addr`` is the
    ``host:port`` clients pass to :func:`connect`; ``env_extra`` is added
    to every worker's environment (``{"MPI_TPU_DEVICE": "cpu"}`` puts the
    workers on the CPU).  ``federation`` joins a namespace (a directory,
    ``raft:<idx>@host:port,...`` or a store) as ``server_id``, with the
    leader-lease bound ``fed_lease_timeout_s``; ``orphan_timeout_s`` is
    how long this server's workers look for a new owner if it dies."""

    def __init__(self, pool_size: int = _POOL_SIZE, backend: str = "socket",
                 host: str = _HOST, port: int = 0,
                 detect_timeout_s: float = _DETECT_TIMEOUT_S,
                 heartbeat_s: float = _HEARTBEAT_S,
                 world_lease_timeout_s: float = _WORLD_LEASE_TIMEOUT_S,
                 rejoin_timeout_s: float = _REJOIN_TIMEOUT_S,
                 env_extra: Optional[dict] = None,
                 metrics_port: Optional[int] = None,
                 federation: Optional[str] = None,
                 server_id: Optional[str] = None,
                 fed_lease_timeout_s: float = _FED_LEASE_TIMEOUT_S,
                 max_pending: int = _MAX_PENDING,
                 orphan_timeout_s: float = _ORPHAN_TIMEOUT_S) -> None:
        if pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if backend == "shm":
            from .native import ensure_built

            ensure_built()  # build once, not pool_size racing workers
        self.pool_size = pool_size
        self.backend = backend
        self.detect_timeout_s = float(detect_timeout_s)
        self.heartbeat_s = float(heartbeat_s)
        self.world_lease_timeout_s = float(world_lease_timeout_s)
        self.rejoin_timeout_s = float(rejoin_timeout_s)
        self.max_pending = int(max_pending)
        self.orphan_timeout_s = float(orphan_timeout_s)
        self._env_extra = dict(env_extra or {})
        self.rdv = membership.new_rendezvous_dir(prefix="mtt_serve_")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(pool_size + 16)
        self.addr = "%s:%d" % self._listener.getsockname()[:2]
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closing = False
        self._stopped = threading.Event()  # set when stop() has finished
        # pools: the home pool is this server's own worker world; adopted
        # pools arrive through adopt_pool.  Workers, healing and pvars are
        # keyed (pool_id, slot) throughout.
        self._home = os.path.basename(self.rdv.rstrip("/"))
        self._pools: Dict[str, _Pool] = {
            self._home: _Pool(self._home, self.rdv, backend, pool_size,
                              home=True)}
        self._relinquished_home_epoch = 0
        self._workers: Dict[Tuple[str, int], _Worker] = {}
        self._leases: Dict[int, dict] = {}
        self._jobs: Dict[int, dict] = {}
        self._healing: Dict[Tuple[str, int], dict] = {}
        self._seq = 0
        # admission control: the bounded waiter queue and the fair-share
        # ledger (leases granted per client identity)
        self._waiters: List[dict] = []
        self._client_grants: Dict[str, int] = {}
        self.stats_counters = {"leases_granted": 0, "leases_denied": 0,
                               "jobs_ok": 0, "jobs_failed": 0,
                               "heals_completed": 0, "workers_lost": 0,
                               "busy_rejected": 0,
                               "no_quorum_rejected": 0,
                               "orphans_reregistered": 0,
                               "pools_adopted": 0,
                               "pools_relinquished": 0}
        self._threads: List[threading.Thread] = []
        # federation membership: the namespace spec and identity; the
        # member thread starts in start()
        self._fed_ns = federation
        self.server_id = server_id or ("srv-" + uuid.uuid4().hex[:8])
        self._fed_lease_timeout_s = float(fed_lease_timeout_s)
        self._fed = None
        # refuse new leases while the namespace store has no quorum (the
        # minority side of a partition); "0" turns the fence off to show
        # the failure mode it closes
        self._store_fence = os.environ.get(
            "MPI_TPU_SERVE_STORE_FENCE", "1") != "0"
        # observability: the uptime anchor of the worlds/s gauge,
        # per-second completed-job buckets (a sliding window bounded by
        # its length whatever the rate), the latest per-slot worker pvar
        # snapshot, and the optional Prometheus endpoint (metrics_port; 0
        # binds an ephemeral port, see metrics_addr)
        self._t0 = time.monotonic()
        self._ok_buckets: Dict[int, int] = {}
        self._worker_pvars: Dict[Tuple[str, int], dict] = {}
        self._metrics_port = metrics_port
        self._metrics_httpd = None
        self.metrics_addr: Optional[str] = None
        self._host = host

    # -- lifecycle ---------------------------------------------------------

    @property
    def epoch(self) -> int:
        """The home pool's membership epoch; per-pool epochs are in
        ``stats()["pools"]``."""
        pool = self._pools.get(self._home)
        return pool.epoch if pool is not None \
            else self._relinquished_home_epoch

    def start(self, wait_ready: bool = True,
              timeout: float = 120.0) -> "WorldServer":
        # the lease-acquire histogram is a process-global pvar: start this
        # server's document clean, so sequential in-process servers do not
        # report a predecessor's tail as their own p99
        _mpit.pvar_hist_reset("lease_acquire_s")
        for slot in range(self.pool_size):
            key = (self._home, slot)
            self._workers[key] = _Worker(slot, self._home)
            self._spawn_worker(key)
        for name, target in (("accept", self._accept_loop),
                             ("monitor", self._monitor_loop)):
            th = threading.Thread(target=target, daemon=True,
                                  name=f"serve-{name}")
            th.start()
            self._threads.append(th)
        if self._metrics_port is not None:
            self._start_metrics(self._metrics_port)
        if self._fed_ns is not None:
            # join the namespace: endpoint record, leader lease, pool
            # ownership, takeover duties
            from . import federation as _federation

            self._fed = _federation.FederationMember(
                self, self._fed_ns, server_id=self.server_id,
                lease_timeout_s=self._fed_lease_timeout_s).start()
        if wait_ready:
            self._wait_ready(timeout)
        return self

    def _wait_ready(self, timeout: float) -> None:
        """Wait until no worker is starting.  A worker that exited before
        its hello (no device, a broken environment) fails the start with
        :class:`WorkerStartError` at once: healing it would only respawn
        the same failure until the bound."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if self._closing:
                    raise RuntimeError("server stopped during start")
                failed = sorted(
                    (s, w.proc.returncode)
                    for (_, s), w in self._workers.items()
                    if w.incarnation is None and w.proc is not None
                    and w.proc.poll() is not None)
                if failed or not any(w.state == "starting"
                                     for w in self._workers.values()):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"worker pool not ready within {timeout}s: "
                        + str({s: w.state for s, w
                               in self._workers.items()}))
                self._cond.wait(min(0.25, remaining))
        if failed:
            self.stop()
            dev = self._env_extra.get(ENV_DEVICE) \
                or os.environ.get(ENV_DEVICE)
            raise WorkerStartError(
                f"pool workers exited before joining the pool (slot, exit "
                f"code): {failed}; their tracebacks are on this process's "
                f"stderr.  A worker runs on {ENV_DEVICE} ({dev!r}) or else "
                f"on card slot % device_count; without a card pass "
                f"env_extra={{'{ENV_DEVICE}': 'cpu'}} (launcher serve "
                f"--device cpu)")

    def __enter__(self) -> "WorldServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        """Stop the workers and tear the pools down.  A second caller waits
        for the first one's teardown: ``main`` returns (and the process
        exits) only after the rendezvous dirs and segments are gone, also
        when a client's ``shutdown`` started the stop on another thread."""
        with self._cond:
            first = not self._closing
            self._closing = True
            # every mutable read snapshotted here: the monitor thread may
            # be mid-heal, mutating conns and self._healing
            conns = [(w.conn, w.send_lock)
                     for w in self._workers.values()
                     if w.conn is not None]
            procs = [w.proc for w in self._workers.values()
                     if w.proc is not None]
            procs += [h["proc"] for h in self._healing.values()
                      if h.get("proc") is not None]
            # adopted workers are not our children: the shutdown op asks
            # them to stop, their pids are the last-resort handle
            adopted_pids = [w.pid for w in self._workers.values()
                            if w.proc is None and w.pid]
            pools = list(self._pools.values())
            self._cond.notify_all()
        if not first:
            self._stopped.wait(30.0)
            return
        try:
            self._teardown(conns, procs, adopted_pids, pools)
        finally:
            self._stopped.set()

    def _teardown(self, conns, procs, adopted_pids, pools) -> None:
        if self._fed is not None:
            # leave the namespace first: the records retract before the
            # pools die, so no leader assigns a takeover of a pool whose
            # workers are about to receive shutdown
            self._fed.stop()
        for conn, lk in conns:
            try:
                _send_msg(conn, lk, {"op": "shutdown"})
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        httpd = self._metrics_httpd
        if httpd is not None:
            self._metrics_httpd = None
            try:
                httpd.shutdown()
                httpd.server_close()
            except OSError:  # pragma: no cover - teardown race
                pass
        deadline = time.monotonic() + 5.0
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(2.0)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass
        # adopted workers received the shutdown op; sweep any that did not
        # exit (two masters of one pool must never coexist with the
        # rendezvous dirs about to vanish)
        deadline = time.monotonic() + 3.0
        for pid in adopted_pids:
            while membership._pid_alive(pid) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            if membership._pid_alive(pid):
                try:
                    os.kill(pid, 9)
                except OSError:
                    pass
        for pool in pools:
            membership.cleanup_rendezvous(pool.rdv)

    # -- metrics endpoint --------------------------------------------------

    def _start_metrics(self, port: int) -> None:
        """Serve ``GET /metrics`` (Prometheus text, rendered by
        ``telemetry/metrics.py`` from the ``stats()`` document clients
        read) on a side HTTP port; port 0 binds an ephemeral one
        (``metrics_addr``).  The handler only reads (stats() takes the
        server lock briefly): a scrape never wedges the monitor."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from .telemetry import metrics as _metrics

        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - http.server API
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = _metrics.prometheus_text(
                        server.stats()).encode()
                except Exception as e:  # noqa: BLE001 - shipped as 500
                    self.send_error(500, type(e).__name__)
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # noqa: D102
                pass  # scrapes are not server-log events

        httpd = ThreadingHTTPServer((self._host, int(port)), Handler)
        httpd.daemon_threads = True
        self._metrics_httpd = httpd
        self.metrics_addr = "%s:%d" % httpd.server_address[:2]
        th = threading.Thread(target=httpd.serve_forever,
                              daemon=True, name="serve-metrics")
        th.start()
        self._threads.append(th)

    # -- worker processes --------------------------------------------------

    def _worker_env(self, key: Tuple[str, int],
                    rejoin_epoch: Optional[int] = None) -> dict:
        pool_id, slot = key
        pool = self._pools[pool_id]
        env = dict(os.environ)
        # the workers import the package this server runs from
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        env.update({
            "MPI_TPU_RANK": str(slot),
            "MPI_TPU_SIZE": str(pool.size),
            "MPI_TPU_RDV": pool.rdv,
            "MPI_TPU_BACKEND": pool.backend,
            "MPI_TPU_SERVE_CTRL": self.addr,
            "MPI_TPU_SERVE_POOL": pool_id,
            "MPI_TPU_SERVE_DETECT_S": str(self.detect_timeout_s),
            "MPI_TPU_SERVE_HEARTBEAT_S": str(self.heartbeat_s),
            "MPI_TPU_SERVE_ORPHAN_TIMEOUT_S": str(self.orphan_timeout_s),
        })
        # the worker starts its own fault detector (see _worker_main)
        env.pop("MPI_TPU_FT", None)
        env.pop("MPI_TPU_SERVE_FED", None)
        if self._fed_ns is not None:
            # the client spec: a raft:<idx>@... member spec must not reach
            # the workers, which resolve pool owners over the store's RPC
            # port and never embed a node
            from . import federation_store as _fstore

            env["MPI_TPU_SERVE_FED"] = _fstore.client_spec(self._fed_ns)
        env.pop("MPI_TPU_SERVE_REJOIN", None)
        if rejoin_epoch is not None:
            env["MPI_TPU_SERVE_REJOIN"] = f"{rejoin_epoch}:{slot}"
            env["MPI_TPU_SERVE_REJOIN_TIMEOUT_S"] = \
                str(self.rejoin_timeout_s)
        env.update(self._env_extra)
        return env

    def _spawn_worker(self, key: Tuple[str, int],
                      rejoin_epoch: Optional[int] = None
                      ) -> subprocess.Popen:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mpi_tpu_torch.serve", "--worker"],
            env=self._worker_env(key, rejoin_epoch))
        if rejoin_epoch is None:
            self._workers[key].proc = proc
            self._workers[key].spawned_at = time.monotonic()
        return proc

    # -- accept / connection handling --------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True, name="serve-conn").start()

    def _conn_loop(self, conn: socket.socket) -> None:
        first = _recv_msg(conn)
        if first is None:
            conn.close()
            return
        if first.get("op") == "hello":
            self._worker_loop(conn, first)
        else:
            self._client_loop(conn, first)

    # -- worker side -------------------------------------------------------

    def _worker_loop(self, conn: socket.socket, hello: dict) -> None:
        slot = int(hello["slot"])
        pool_id = str(hello.get("pool") or self._home)
        key = (pool_id, slot)
        with self._cond:
            w = self._workers.get(key)
            pool = self._pools.get(pool_id)
            if w is None or pool is None:
                # an unknown slot, or a pool relinquished in the hello race
                conn.close()
                return
            if w.conn is not None and w.state in ("idle", "leased") \
                    and hello.get("incarnation") != w.incarnation:
                # the slot is live under another incarnation: two
                # incarnations of one slot must never coexist
                conn.close()
                return
            heal = self._healing.pop(key, None)
            if heal is not None:
                w.proc = heal["proc"]
                self.stats_counters["heals_completed"] += 1
            elif w.proc is None and not pool.home:
                # an orphan of an adopted pool registering: warm, leasable
                # the moment this hello lands
                self.stats_counters["orphans_reregistered"] += 1
            w.conn = conn
            w.pid = hello.get("pid")
            w.incarnation = hello.get("incarnation")
            w.epoch = int(hello.get("epoch", 0))
            w.lease_id = None
            # an adopted pool learns its epoch from its workers
            pool.epoch = max(pool.epoch, w.epoch)
            # (conn, lock) pairs snapshotted under the lock (see
            # _begin_heal)
            peers = [(p.conn, p.send_lock)
                     for p in self._workers.values()
                     if p is not w and p.pool == pool_id
                     and p.conn is not None
                     and p.state not in ("dead",)]
            behind = w.epoch < pool.epoch
            catchup = {"op": "transition", "epoch": pool.epoch,
                       # never the hello-ing worker's own slot (its state
                       # is still 'dead' here): a worker observing itself
                       # failed would poison every later lease's FT
                       "dead": [p.slot for p in self._workers.values()
                                if p is not w and p.pool == pool_id
                                and (p.state == "dead"
                                     or (pool_id, p.slot)
                                     in self._healing)]}
        if behind:
            # another death's transition went out while this worker was
            # still rejoining: resync it now, or its first send to an
            # up-epoch survivor raises EpochSkewError for good
            try:
                _send_msg(conn, w.send_lock, catchup)
            except OSError:
                pass  # the EOF path marks it dead next
        if heal is not None:
            # tell the survivors the slot is live again before it becomes
            # leasable: a job to a peer rides the same FIFO connection as
            # this 'rejoined', so every peer clears its detector's failed
            # entry before it can run a lease with the healed slot
            for conn_p, lk_p in peers:
                try:
                    _send_msg(conn_p, lk_p,
                              {"op": "rejoined", "slot": slot,
                               "epoch": w.epoch})
                except OSError:
                    pass
        with self._cond:
            w.state = "idle"
            self._cond.notify_all()
        while True:
            msg = _recv_msg(conn)
            if msg is None:
                new_owner = self._pool_moved(pool_id)
                if new_owner is not None:
                    # the worker defected to the server that took its pool
                    # over while this one was frozen: hand the pool over,
                    # never kill a process that now serves the new owner
                    self.relinquish_pool(pool_id, new_owner)
                    return
                with self._cond:
                    if not self._closing \
                            and self._workers.get(key) is w \
                            and w.conn is conn and w.state != "dead":
                        self._mark_dead_locked(w, "control channel EOF")
                    self._cond.notify_all()
                return
            op = msg.get("op")
            if op == "job_done":
                self._job_done(key, msg)
            elif op == "pvars":
                # the idle push; existence-guarded so a push in flight does
                # not resurrect a key relinquish_pool just dropped
                with self._cond:
                    if key in self._workers:
                        self._worker_pvars[key] = msg.get("pvars") or {}
            # transition_acks are informational: healing does not wait on
            # them (a wedged worker must not stall the pool's healing)

    def _job_done(self, key: Tuple[str, int], msg: dict) -> None:
        slot = key[1]
        with self._cond:
            pvars = msg.get("pvars")
            if pvars and key in self._workers:
                self._worker_pvars[key] = pvars
            job = self._jobs.get(msg["job_id"])
            if job is None:
                return
            job["pending"].discard(slot)
            if msg.get("ok"):
                if "result" in msg:
                    job["result"] = msg["result"]
            else:
                job["errors"].append(msg.get("error", {}))
            if not job["pending"]:
                job["event"].set()
            self._cond.notify_all()

    def _mark_dead_locked(self, w: _Worker, why: str) -> None:
        """State transition of a lost worker (the caller holds the lock):
        bump the pool's epoch and fail its job in flight; the monitor loop
        heals the slot on its next tick."""
        if w.state == "dead":
            return
        pool = self._pools.get(w.pool)
        w.state = "dead"
        w.conn = None
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("lease", "worker_dead",
                     attrs={"slot": w.slot, "pool": w.pool, "why": why,
                            "epoch": (pool.epoch + 1 if pool is not None
                                      else -1)})
        if w.proc is not None and w.proc.poll() is None:
            # declared dead while the process lives (a heartbeat-stale
            # wedge): kill it, two live incarnations of one slot must
            # never coexist
            try:
                w.proc.kill()
            except OSError:
                pass
        elif w.proc is None and w.pid:
            # an adopted worker (no Popen handle): the same rule, by pid
            try:
                os.kill(w.pid, 9)
            except OSError:
                pass
        self.stats_counters["workers_lost"] += 1
        if pool is not None:
            pool.epoch += 1
        for job in self._jobs.values():
            if job.get("pool") == w.pool and w.slot in job["pending"]:
                job["pending"].discard(w.slot)
                job["errors"].append({
                    "kind": "ProcFailedError",
                    "code": error_class(ProcFailedError("")),
                    "msg": f"leased worker slot {w.slot} died ({why})",
                    "failed": [w.slot], "collective": None})
                if not job["pending"]:
                    job["event"].set()

    # -- monitoring / healing ----------------------------------------------

    def _hb_stale(self, pool: _Pool, slot: int, now: float) -> bool:
        age = membership.heartbeat_age(pool.rdv, slot, now)
        if age is None:
            return False  # not yet published: process liveness covers it
        return age > 3.0 * self.detect_timeout_s

    def _adopt_grace_s(self) -> float:
        """How long an adopted pool's slot may stay 'starting' before its
        heartbeat decides whether it is a corpse to heal."""
        return max(5.0, 3.0 * self.detect_timeout_s)

    def _monitor_loop(self) -> None:
        while not self._closing:
            time.sleep(self.heartbeat_s)
            if self._closing:
                return
            try:
                self._monitor_tick()
            except Exception as e:  # noqa: BLE001 - the pool's lifeline
                if self._closing:
                    return  # shutdown raced a heal (rdv dir removed)
                # a monitor crash must never silently end healing: a line
                # naming what failed and the pool's state, then tick on
                import traceback

                with self._lock:
                    epoch, healing = self.epoch, sorted(self._healing)
                sys.stderr.write(
                    f"mpi_tpu_torch.serve: monitor tick failed "
                    f"({type(e).__name__}: {str(e)[:200]}; epoch "
                    f"{epoch}, healing slots {healing}) - healing "
                    f"continues:\n{traceback.format_exc()}")
                rec = _telemetry.REC
                if rec is not None:
                    rec.emit("serve", "monitor_error",
                             attrs={"error": type(e).__name__,
                                    "epoch": epoch,
                                    "healing": healing})

    def _monitor_tick(self) -> None:
        now_wall = time.time()
        with self._cond:
            for key, w in self._workers.items():
                if w.state == "dead" or key in self._healing:
                    continue
                pool = self._pools.get(w.pool)
                if pool is None:
                    continue  # relinquish race: workers go next tick
                lost = (w.proc is not None
                        and w.proc.poll() is not None)
                if not lost and w.proc is None and w.pid \
                        and w.state != "starting":
                    # adopted worker: no Popen handle, pid liveness
                    lost = not membership._pid_alive(w.pid)
                if not lost and w.state != "starting":
                    lost = self._hb_stale(pool, w.slot, now_wall)
                if not lost and w.state == "starting" \
                        and pool.adopted_at is not None:
                    # an adopted slot whose orphan never registered: past
                    # the grace, its heartbeat file decides
                    if time.monotonic() - pool.adopted_at \
                            > self._adopt_grace_s():
                        age = membership.heartbeat_age(pool.rdv, w.slot,
                                                       now_wall)
                        lost = (age is None
                                or age > 3.0 * self.detect_timeout_s)
                if lost:
                    self._mark_dead_locked(
                        w, "process exited"
                        if w.proc is not None
                        and w.proc.poll() is not None
                        else "heartbeat stale")
            # heal every dead slot without a healing round in flight:
            # deaths are marked here and by the connection EOF path, and
            # both must converge on a replacement
            dead_now = [w for key, w in self._workers.items()
                        if w.state == "dead" and key not in self._healing]
            if dead_now:
                self._cond.notify_all()
        if dead_now:
            self._begin_heal(dead_now)
        self._drive_healing()

    def _begin_heal(self, dead: List[_Worker]) -> None:
        """One healing round per affected pool: tell that pool's
        survivors, announce the vacancies on its rendezvous dir, spawn
        replacements that rejoin under the pool's bumped epoch."""
        by_pool: Dict[str, List[_Worker]] = {}
        for w in dead:
            by_pool.setdefault(w.pool, []).append(w)
        for pool_id, ws in by_pool.items():
            dead_slots = [w.slot for w in ws]
            with self._lock:
                pool = self._pools.get(pool_id)
                if pool is None:
                    continue  # relinquished mid-round: the new owner heals
                epoch = pool.epoch
                # (conn, lock) pairs under the lock: a concurrent death
                # nulls worker.conn, and a re-read outside the lock would
                # hand None to sendall (killing the monitor thread)
                live = [(p.conn, p.send_lock)
                        for p in self._workers.values()
                        if p.pool == pool_id
                        and p.state not in ("dead", "starting")
                        and p.conn is not None]
            for conn, lk in live:
                try:
                    _send_msg(conn, lk,
                              {"op": "transition", "epoch": epoch,
                               "dead": dead_slots})
                except OSError:
                    pass  # its own death is noticed next tick
            slots_meta = {
                s: {"ousted": membership.read_incarnation(pool.rdv, s),
                    # the server is the membership authority: it observed
                    # the death and decided to replace.  The refusal gate
                    # still stops an uninvited ousted incarnation (it
                    # presents the ousted id; the replacement a fresh one)
                    "acked": False}
                for s in dead_slots}
            membership.announce_rejoin(pool.rdv, epoch, slots_meta,
                                       pool.size, pool.backend)
            with self._lock:
                if self._closing:
                    return  # a stop() racing this heal owns every process
                if pool_id not in self._pools:
                    continue  # relinquished while announcing
                for w in ws:
                    key = (pool_id, w.slot)
                    proc = self._spawn_worker(key, rejoin_epoch=epoch)
                    self._healing[key] = {
                        "epoch": epoch, "proc": proc,
                        "since": time.monotonic(), "meta": slots_meta}

    def _drive_healing(self) -> None:
        """Per-tick healing duties: validate claims and admit replacements
        (the announcer's role), and respawn a replacement that died during
        its own rejoin handshake (the announcement stays valid)."""
        with self._lock:
            healing = dict(self._healing)
        for key, h in healing.items():
            pool_id, slot = key
            pool = self._pools.get(pool_id)
            if pool is None:
                # relinquished mid-heal: reap our half-started replacement
                with self._lock:
                    self._healing.pop(key, None)
                try:
                    h["proc"].kill()
                except OSError:
                    pass
                continue
            membership.process_claims(pool.rdv, h["epoch"],
                                      {slot: h["meta"][slot]})
            proc = h["proc"]
            if proc.poll() is not None:
                with self._lock:
                    if self._closing or key not in self._healing:
                        continue
                    h["proc"] = self._spawn_worker(
                        key, rejoin_epoch=h["epoch"])
                    h["since"] = time.monotonic()
                    self._healing[key] = h
            elif time.monotonic() - h["since"] > self.rejoin_timeout_s:
                # alive but wedged in its handshake past the bound: kill
                # it; the next tick respawns.  Re-check under the lock
                # that this round is still healing (its hello may have
                # landed since the snapshot)
                with self._lock:
                    still = (not self._closing
                             and self._healing.get(key) is h)
                if still:
                    try:
                        proc.kill()
                    except OSError:
                        pass

    # -- pool bookkeeping for a federation ---------------------------------

    def owned_pool_records(self) -> Dict[str, dict]:
        """Metadata of every pool this server serves (what a federation
        member publishes as ownership records)."""
        with self._lock:
            return {pid: {"rdv": p.rdv, "backend": p.backend,
                          "size": p.size, "epoch": p.epoch,
                          "since": p.owned_since}
                    for pid, p in self._pools.items()}

    def fed_summary(self) -> dict:
        """The light per-server summary of a federation endpoint record."""
        now = time.monotonic()
        with self._lock:
            states = [w.state for w in self._workers.values()]
            return {"pools": len(self._pools),
                    "workers": len(states),
                    "idle": states.count("idle"),
                    "leases_active": len(self._leases),
                    "waiting": len(self._waiters),
                    "worlds_per_s": self._worlds_per_s_locked(now),
                    "backend": self.backend}

    def adopt_pool(self, pool_id: str, rec: dict, term: int = 0) -> bool:
        """Take over a dead server's pool: register its metadata and one
        'starting' worker entry per slot.  Its live workers register over
        the control channel; a slot whose worker never shows is healed
        through the announce / claim / admit path against the adopted
        rendezvous dir after the adoption grace."""
        with self._cond:
            if self._closing or pool_id in self._pools:
                return False
            pool = _Pool(pool_id, rec["rdv"],
                         rec.get("backend", "socket"), int(rec["size"]),
                         home=False, epoch=int(rec.get("epoch", 0)))
            self._pools[pool_id] = pool
            for s in range(pool.size):
                self._workers[(pool_id, s)] = _Worker(s, pool_id)
            self.stats_counters["pools_adopted"] += 1
            self._cond.notify_all()
        rec_t = _telemetry.REC
        if rec_t is not None:
            rec_t.emit("serve", "pool_adopted",
                       attrs={"pool": pool_id, "size": pool.size,
                              "epoch": pool.epoch, "term": term})
        sys.stderr.write(
            f"mpi_tpu_torch.serve: server {self.server_id} adopted pool "
            f"{pool_id} ({pool.size} slots, epoch {pool.epoch}, "
            f"term {term})\n")
        return True

    def relinquish_pool(self, pool_id: str,
                        new_owner: Optional[str] = None) -> None:
        """Stop serving a pool another server now owns: closing the worker
        control connections is the handover, and every lease in flight on
        the pool fails with a named error, never a hang."""
        with self._cond:
            pool = self._pools.pop(pool_id, None)
            if pool is None:
                return
            if pool.home:
                self._relinquished_home_epoch = pool.epoch
            conns = []
            for key in [k for k in self._workers if k[0] == pool_id]:
                w = self._workers.pop(key)
                if w.conn is not None:
                    conns.append(w.conn)
                self._worker_pvars.pop(key, None)
            heal_procs = [self._healing.pop(k)["proc"]
                          for k in list(self._healing)
                          if k[0] == pool_id]
            for job in self._jobs.values():
                if job.get("pool") == pool_id and job["pending"]:
                    job["pending"].clear()
                    job["errors"].append({
                        "kind": "TransportError",
                        "msg": f"pool {pool_id} taken over by server "
                               f"{new_owner} (ownership moved "
                               f"mid-lease; re-acquire)",
                        "failed": [], "collective": None})
                    job["event"].set()
            for lease_id in [lid for lid, lease in self._leases.items()
                             if lease.get("pool") == pool_id]:
                self._leases.pop(lease_id)
            # queued acquires no remaining pool can satisfy fail over now
            cap = max((p.size for p in self._pools.values()),
                      default=0)
            for waiter in self._waiters:
                if waiter["nranks"] > cap:
                    waiter["lost"] = True
            self.stats_counters["pools_relinquished"] += 1
            self._cond.notify_all()
        for c in conns:
            try:
                # shutdown first: the worker's reader blocked in recv() is
                # not woken by a bare close()
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for p in heal_procs:
            try:
                p.kill()  # the new owner heals its own pool
            except OSError:
                pass
        rec_t = _telemetry.REC
        if rec_t is not None:
            rec_t.emit("serve", "pool_relinquished",
                       attrs={"pool": pool_id, "to": new_owner})
        sys.stderr.write(
            f"mpi_tpu_torch.serve: server {self.server_id} relinquished "
            f"pool {pool_id} to {new_owner}\n")

    def _pool_moved(self, pool_id: str) -> Optional[str]:
        """The server the namespace names as ``pool_id``'s owner when it
        took the pool over after this server began owning it (the
        condition on which the federation member relinquishes), else
        None; always None standalone."""
        if self._fed is None:
            return None
        from . import federation as _federation

        rec = _federation.read_pool_owner(self._fed.store, pool_id)
        with self._lock:
            pool = self._pools.get(pool_id)
            since = None if pool is None else pool.owned_since
        if rec is None or since is None \
                or rec.get("owner") == self.server_id \
                or float(rec.get("since", 0)) < since:
            return None
        return rec.get("owner")

    def is_leader(self) -> bool:
        """Whether this server holds valid federation leader authority
        (never, standalone)."""
        return self._fed is not None and self._fed.is_leader()

    # -- client side -------------------------------------------------------

    def _client_loop(self, conn: socket.socket, first: dict) -> None:
        lock = threading.Lock()
        owned: List[int] = []  # lease ids owned by this connection
        msg: Optional[dict] = first
        try:
            while msg is not None:
                try:
                    reply = self._client_op(msg, owned)
                except Exception as e:  # noqa: BLE001 - shipped back
                    reply = {"error": _pack_error(e)}
                try:
                    _send_msg(conn, lock, reply)
                except OSError:
                    break
                if msg.get("op") == "shutdown":
                    threading.Thread(target=self.stop,
                                     daemon=True).start()
                    break
                msg = _recv_msg(conn)
        finally:
            for lease_id in list(owned):
                self._release(lease_id)
            conn.close()

    def _client_op(self, msg: dict, owned: List[int]) -> dict:
        op = msg.get("op")
        if op == "acquire":
            return self._acquire(msg, owned)
        if op == "run":
            return self._run_job(msg)
        if op == "release":
            self._release(int(msg["lease_id"]))
            if int(msg["lease_id"]) in owned:
                owned.remove(int(msg["lease_id"]))
            return {"ok": True}
        if op == "stats":
            return {"ok": True, "stats": self.stats()}
        if op == "shutdown":
            return {"ok": True}
        return {"error": {"kind": "ValueError",
                          "msg": f"unknown op {op!r}"}}

    def _pick_idle_locked(self, nranks: int
                          ) -> Optional[Tuple[str, List[int]]]:
        """A pool with ``nranks`` idle slots (a lease never spans pools,
        they are different transport worlds), best fit: the pool with the
        fewest idle slots that still satisfies (home as the tiebreak), so
        a later full-size request keeps an unfragmented pool."""
        best = None
        for pool_id, pool in self._pools.items():
            idle = sorted(s for (pid, s), w in self._workers.items()
                          if pid == pool_id and w.state == "idle")
            if len(idle) >= nranks:
                score = (len(idle), 0 if pool.home else 1, pool_id)
                if best is None or score < best[0]:
                    best = (score, pool_id, idle[:nranks])
        return None if best is None else (best[1], best[2])

    def _try_grant_locked(self, waiter: dict
                          ) -> Optional[Tuple[str, List[int]]]:
        """Grant ``waiter`` iff it is the first waiter in admission order
        that the current idle capacity can satisfy."""
        for w in _admission_order(self._waiters, self._client_grants):
            pick = self._pick_idle_locked(w["nranks"])
            if pick is None:
                continue
            return pick if w is waiter else None
        return None

    def _acquire(self, msg: dict, owned: List[int]) -> dict:
        nranks = int(msg["nranks"])
        timeout = float(msg.get("timeout") or self.world_lease_timeout_s)
        client_id = str(msg.get("client") or "anon")
        priority = int(msg.get("priority") or 0)
        t_req = time.monotonic()
        deadline = t_req + timeout
        with self._cond:
            if self._fed is not None and self._store_fence \
                    and not self._fed.healthy():
                # the admission fence: this server is on the minority side
                # of a namespace-store partition (or the store group has no
                # leader).  A lease here could double-serve a pool the
                # majority is about to reassign, so refuse by name; a
                # federated client fails over to a majority-side server.
                # Leases in flight run on: only new authority is refused
                self.stats_counters["leases_denied"] += 1
                self.stats_counters["no_quorum_rejected"] += 1
                raise NoQuorumError(
                    f"server {self.server_id} has no namespace-store "
                    f"quorum (minority side of a partition): refusing "
                    f"new leases - fail over to a majority-side server")
            cap = max((p.size for p in self._pools.values()), default=0)
            if cap == 0:
                # every pool relinquished: this endpoint serves no lease
                raise ServerLostError(
                    "server owns no pools (relinquished after a "
                    "takeover): fail over to a live owner")
            if nranks < 1 or nranks > cap:
                raise ValueError(
                    f"nranks must be in [1, {cap}] for this pool")
            was_full = len(self._waiters) >= self.max_pending
            self._seq += 1
            waiter = {"client": client_id, "priority": priority,
                      "nranks": nranks, "seq": self._seq}
            self._waiters.append(waiter)
            # work-conserving door: an arrival the current idle capacity
            # can satisfy (net of better-ranked waiters) is granted at
            # once and never occupies a queue slot
            grant = self._try_grant_locked(waiter)
            if grant is None and was_full:
                # the bounded queue with a priority-aware door: an arrival
                # that outranks the worst waiter (the admission order)
                # bumps it, otherwise it is rejected with a named
                # ServerBusyError; either way the depth stays bounded
                self._waiters.remove(waiter)
                order = _admission_order(self._waiters,
                                         self._client_grants)
                worst = order[-1] if order else None
                cand_key = (-priority,
                            self._client_grants.get(client_id, 0),
                            waiter["seq"])
                worst_key = None if worst is None else (
                    -worst["priority"],
                    self._client_grants.get(worst["client"], 0),
                    worst["seq"])
                self.stats_counters["leases_denied"] += 1
                self.stats_counters["busy_rejected"] += 1
                if worst is None or worst_key <= cand_key:
                    raise ServerBusyError(
                        f"admission queue full ({self.max_pending} "
                        f"waiting acquires, capacity "
                        f"{sum(p.size for p in self._pools.values())} "
                        f"workers): back off or fail over")
                worst["bumped"] = True
                self._waiters.remove(worst)
                self._waiters.append(waiter)
                self._cond.notify_all()
            try:
                while grant is None:
                    if self._closing:
                        raise RuntimeError("server shutting down")
                    if waiter.get("lost"):
                        raise ServerLostError(
                            "the pool(s) that could have served this "
                            "acquire were relinquished to another "
                            "server: fail over to the new owner")
                    if waiter.get("bumped"):
                        raise ServerBusyError(
                            f"bumped from the full admission queue by "
                            f"a higher-ranked acquire "
                            f"({self.max_pending} waiting): back off "
                            f"or fail over")
                    grant = self._try_grant_locked(waiter)
                    if grant is not None:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        idle = sum(1 for w in self._workers.values()
                                   if w.state == "idle")
                        self.stats_counters["leases_denied"] += 1
                        return {"error": {
                            "kind": "LeaseTimeout",
                            "msg": f"no {nranks} idle workers within "
                                   f"{timeout}s (pool {self.pool_size}, "
                                   f"idle {idle}, waiting "
                                   f"{len(self._waiters)})"}}
                    self._cond.wait(min(0.25, remaining))
            finally:
                if waiter in self._waiters:
                    self._waiters.remove(waiter)
            pool_id, slots = grant
            self._seq += 1
            lease_id = self._seq
            for s in slots:
                self._workers[(pool_id, s)].state = "leased"
                self._workers[(pool_id, s)].lease_id = lease_id
            epoch = self._pools[pool_id].epoch
            self._leases[lease_id] = {"slots": slots, "epoch": epoch,
                                      "pool": pool_id}
            self.stats_counters["leases_granted"] += 1
            # the fair-share ledger, bounded: an unbounded dict of client
            # ids leaks under connect() churn, so the baseline resets
            self._client_grants[client_id] = \
                self._client_grants.get(client_id, 0) + 1
            if len(self._client_grants) > 4096:
                self._client_grants.clear()
        # always on: one histogram add beside a control round trip
        _mpit.hist_record("lease_acquire_s", time.monotonic() - t_req)
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("lease", "grant",
                     attrs={"lease_id": lease_id, "slots": slots,
                            "pool": pool_id, "epoch": epoch})
        owned.append(lease_id)
        return {"ok": True, "lease_id": lease_id, "slots": slots,
                "epoch": epoch, "pool": pool_id}

    def _run_job(self, msg: dict) -> dict:
        lease_id = int(msg["lease_id"])
        timeout = float(msg.get("timeout") or self.world_lease_timeout_s)
        with self._cond:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise ValueError(f"unknown lease {lease_id}")
            pool_id = lease.get("pool", self._home)
            slots = list(lease["slots"])
            dead = [s for s in slots
                    if self._workers[(pool_id, s)].state != "leased"
                    or self._workers[(pool_id, s)].lease_id != lease_id]
            self._seq += 1
            job_id = self._seq
            job = {"pending": set(slots) - set(dead), "errors": [],
                   "result": None, "event": threading.Event(),
                   "pool": pool_id}
            if dead:
                job["errors"].append({
                    "kind": "ProcFailedError",
                    "code": error_class(ProcFailedError("")),
                    "msg": f"leased worker slot(s) {dead} died before "
                           f"the job started",
                    "failed": dead, "collective": None})
            self._jobs[job_id] = job
            targets = [(self._workers[(pool_id, s)].conn,
                        self._workers[(pool_id, s)].send_lock)
                       for s in job["pending"]]
        if not job["pending"]:
            job["event"].set()
        for conn, lk in targets:
            try:
                _send_msg(conn, lk, {
                    "op": "job", "job_id": job_id, "slots": slots,
                    # the lease's epoch stamp keys the pooled arena the
                    # same on every leased worker
                    "epoch": lease.get("epoch", 0),
                    "fn": msg["fn"], "args": msg["args"]})
            except OSError:
                pass  # the monitor notices its death and synthesizes it
        ok = job["event"].wait(timeout)
        with self._cond:
            self._jobs.pop(job_id, None)
            stuck = sorted(job["pending"])
            # pin the process objects (and, for adopted workers, the
            # hello pid) under the lock: a concurrent heal could install a
            # healthy replacement under the same slot
            stuck_procs = [(s, self._workers[(pool_id, s)].proc,
                            self._workers[(pool_id, s)].pid)
                           for s in stuck
                           if (pool_id, s) in self._workers]
        if not ok:
            # dump the unresponsive workers' stacks to their stderr
            # (faulthandler on SIGUSR2), then quarantine them by killing:
            # a worker past the lease timeout is still wedged in the old
            # job, and back in the idle pool it would poison every later
            # lease; killed, it takes the healing path
            import signal as _signal

            for s, proc, pid in stuck_procs:
                target = None
                if proc is not None and proc.poll() is None:
                    target = proc.pid
                elif proc is None and pid \
                        and membership._pid_alive(pid):
                    target = pid
                if target is not None:
                    try:
                        os.kill(target, _signal.SIGUSR2)
                        time.sleep(0.1)  # let the dump reach stderr
                        os.kill(target, _signal.SIGKILL)
                    except OSError:
                        pass
            # and declare them dead now, not when the monitor next sees
            # the process gone: a torch worker's exit takes long enough
            # that the release below would hand the killed slot back to
            # the idle pool, and stats() would report a whole pool with
            # nothing lost and nothing healing
            with self._cond:
                for s, proc, pid in stuck_procs:
                    w = self._workers.get((pool_id, s))
                    if w is not None and w.proc is proc and w.pid == pid:
                        self._mark_dead_locked(
                            w, "killed past the lease timeout")
            sys.stderr.write(
                f"mpi_tpu_torch.serve: job {job_id} on lease {lease_id} "
                f"blew the {timeout}s lease timeout; quarantined "
                f"worker slots {stuck}\n")
            # what the slots that did answer raised is often why the
            # others wait: say it
            raised = "".join(
                f"; slot(s) {e.get('failed') or '?'} raised "
                f"{e.get('kind')}: {str(e.get('msg', ''))[:200]}"
                for e in job["errors"])
            return {"error": {
                "kind": "LeaseTimeout",
                "msg": f"job on lease {lease_id} did not complete "
                       f"within {timeout}s (unresponsive worker "
                       f"slots {stuck}: stacks dumped to the server "
                       f"log, workers killed for pool healing{raised})"}}
        if job["errors"]:
            self.stats_counters["jobs_failed"] += 1
            # the most diagnosable error wins: a named one over a generic
            errs = sorted(
                job["errors"],
                key=lambda e: 0 if e.get("kind") in _ERROR_KINDS else 1)
            sys.stderr.write(
                f"mpi_tpu_torch.serve: job {job_id} on lease {lease_id} "
                f"failed: {errs[0].get('kind')}: "
                f"{str(errs[0].get('msg', ''))[:200]} "
                f"(failed slots {errs[0].get('failed')})\n")
            return {"error": errs[0]}
        with self._cond:
            self.stats_counters["jobs_ok"] += 1
            sec = int(time.monotonic())
            self._ok_buckets[sec] = self._ok_buckets.get(sec, 0) + 1
            for k in [k for k in self._ok_buckets
                      if sec - k > _RATE_WINDOW_S]:
                del self._ok_buckets[k]
        return {"ok": True, "result": job["result"]}

    def _release(self, lease_id: int) -> None:
        with self._cond:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return
            pool_id = lease.get("pool", self._home)
            for s in lease["slots"]:
                w = self._workers.get((pool_id, s))
                if w is not None and w.state == "leased" \
                        and w.lease_id == lease_id:
                    w.state = "idle"
                    w.lease_id = None
            self._cond.notify_all()

    def _worlds_per_s_locked(self, now: float) -> float:
        # completed jobs over the sliding window, bounded by the uptime so
        # a young server reads its true rate
        window = min(_RATE_WINDOW_S, max(1e-9, now - self._t0))
        recent = sum(c for sec, c in self._ok_buckets.items()
                     if now - sec <= _RATE_WINDOW_S)
        return round(recent / window, 3)

    def stats(self) -> dict:
        now = time.monotonic()
        with self._lock:
            # "workers" and "epoch" describe the home pool; "idle" counts
            # every pool (a lease can land on any); "pools" has the detail
            states = {s: w.state for (pid, s), w in self._workers.items()
                      if pid == self._home}
            pools = {
                pid: {"home": p.home, "epoch": p.epoch, "size": p.size,
                      "workers": {s: w.state
                                  for (wp, s), w
                                  in self._workers.items()
                                  if wp == pid}}
                for pid, p in self._pools.items()}
            agg: Dict[str, int] = {}
            for snap in self._worker_pvars.values():
                for k, v in snap.items():
                    agg[k] = agg.get(k, 0) + int(v)
            out = {
                "addr": self.addr, "backend": self.backend,
                "pool_size": self.pool_size, "epoch": self.epoch,
                "workers": states,
                "idle": sum(1 for w in self._workers.values()
                            if w.state == "idle"),
                "healing": [f"{pid}:{s}"
                            for pid, s in sorted(self._healing)],
                "leases_active": len(self._leases),
                "uptime_s": round(now - self._t0, 3),
                "worlds_per_s": self._worlds_per_s_locked(now),
                "worker_pvars": agg,
                "metrics_addr": self.metrics_addr,
                "pools": pools,
                "waiting": len(self._waiters),
                "max_pending": self.max_pending,
                "server_id": self.server_id,
                **self.stats_counters,
            }
        # None, not False: a standalone server must not scrape as a
        # non-leader federation member (and it has no "federation" key)
        out["is_leader"] = (self.is_leader() if self._fed is not None
                            else None)
        if self._fed_ns is not None:
            # the namespace roll-up (store reads, outside the server lock)
            # through the member's own store handle: a raft member serves
            # its local applied state instead of dialing itself
            from . import federation as _federation

            out["federation"] = _federation.federation_stats(
                self._fed.store if self._fed is not None
                else self._fed_ns)
            if self._fed is not None:
                out["store_healthy"] = self._fed.healthy()
        # lease-acquire quantiles from the histogram pvar (log-bucket
        # estimates, mpit.hist_quantile documents the error bound)
        for q, label in ((0.5, "p50"), (0.99, "p99")):
            est = _mpit.hist_quantile("lease_acquire_s", q)
            out[f"lease_acquire_{label}_ms"] = (
                None if est is None else round(est * 1e3, 3))
        return out


# -- the client ---------------------------------------------------------------


class WorldLease:
    """A leased world: run jobs on it, release it when done."""

    def __init__(self, client: "ServerClient", lease_id: int,
                 slots: List[int], epoch: int,
                 pool: Optional[str] = None) -> None:
        self._client = client
        self.lease_id = lease_id
        self.slots = list(slots)
        self.epoch = int(epoch)
        self.pool = pool  # which pool served it
        self._released = False

    @property
    def size(self) -> int:
        return len(self.slots)

    def run(self, fn, *args: Any, timeout: Optional[float] = None) -> Any:
        """Execute ``fn(comm, *args)`` on every leased worker (``fn`` is
        pickled by reference: the workers must be able to import it);
        returns lease rank 0's return value, its tensors on the CPU.
        Raises the worker-side error by name (ProcFailedError and the
        others) on any failure."""
        reply = self._client._request({
            "op": "run", "lease_id": self.lease_id,
            "fn": pickle.dumps(fn, protocol=pickle.HIGHEST_PROTOCOL),
            "args": pickle.dumps(args, protocol=pickle.HIGHEST_PROTOCOL),
            "timeout": timeout})
        blob = reply.get("result")
        return pickle.loads(blob) if blob is not None else None

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._client._request({"op": "release",
                                   "lease_id": self.lease_id})

    def __enter__(self) -> "WorldLease":
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.release()
        except (TransportError, OSError):
            pass  # the server is gone and the lease with it (a release
            # failure must never mask the body's own exception)


class ServerClient:
    """Client handle to a resident world server (see :func:`connect`).

    The first connect retries the transient dial failures (a refused
    connect and a connect timeout, ``resilience.TRANSIENT_DIAL_ERRORS``)
    with backoff and jitter for up to the ``connect_retry_timeout_s``
    cvar: a server still binding looks exactly like a refused connection.
    A connection that dies mid-request raises :class:`ServerLostError`."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 priority: int = 0, client_id: Optional[str] = None,
                 dial_retry_s: Optional[float] = None) -> None:
        from .resilience import retry_connect

        self._sock = retry_connect(
            lambda: socket.create_connection((host, port),
                                             timeout=timeout),
            timeout_s=dial_retry_s)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()  # one request/response in flight
        # the fair-share identity and default priority: the server orders
        # waiting acquires by (priority, grants per client, FIFO)
        self._id = client_id or uuid.uuid4().hex
        self.priority = int(priority)

    def _request(self, msg: dict) -> dict:
        # a timeout-bearing op bounds the reply wait: the server enforces
        # msg["timeout"] itself, so a live server's reply lands within it
        # plus slack, and a frozen server (connection established, no
        # reply, no EOF) surfaces as ServerLostError.  Ops without a
        # timeout (stats, release) keep the blocking read.
        t = msg.get("timeout")
        with self._lock:
            try:
                self._sock.settimeout(float(t) + _RPC_GRACE_S
                                      if t else None)
                _send_msg(self._sock, None, msg)
                reply = _recv_msg(self._sock)
            except OSError as e:
                raise ServerLostError(
                    f"world server connection lost mid-request: "
                    f"{type(e).__name__}: {e}") from e
            finally:
                try:
                    self._sock.settimeout(None)
                except OSError:
                    pass  # the socket is dead already: the raise rules
        if reply is None:
            raise ServerLostError("world server closed the connection")
        if "error" in reply:
            _raise_error(reply["error"])
        return reply

    def acquire(self, nranks: int, timeout: Optional[float] = None,
                priority: Optional[int] = None) -> WorldLease:
        """Lease ``nranks`` warm workers as a world in one round trip (the
        server reserves idle slots; no process start, no handshake).
        Raises TimeoutError when the pool cannot supply them in time and
        ServerBusyError when the admission queue is at its bound."""
        reply = self._request({
            "op": "acquire", "nranks": int(nranks), "timeout": timeout,
            "client": self._id,
            "priority": self.priority if priority is None
            else int(priority)})
        return WorldLease(self, reply["lease_id"], reply["slots"],
                          reply["epoch"], pool=reply.get("pool"))

    def run(self, fn, *args: Any, nranks: int = 2,
            timeout: Optional[float] = None) -> Any:
        """acquire + run + release in one call."""
        lease = self.acquire(nranks, timeout=timeout)
        try:
            return lease.run(fn, *args, timeout=timeout)
        finally:
            try:
                lease.release()
            except (TransportError, OSError):
                pass  # the server is gone: never mask run()'s own error

    def stats(self) -> dict:
        return self._request({"op": "stats"})["stats"]

    def shutdown(self) -> None:
        """Ask the server process to stop."""
        try:
            self._request({"op": "shutdown"})
        except (TransportError, OSError):
            pass

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _parse_hostport(text: str) -> Optional[Tuple[str, int]]:
    host, _, port = text.rpartition(":")
    if not host:
        return None
    try:
        return host, int(port)
    except ValueError:
        return None


def _resolve_addr_file(path: str) -> Tuple[str, int]:
    """Resolve a ``serve --addr-file`` path to (host, port), retrying a
    missing or partially written file with backoff for up to the
    ``connect_retry_timeout_s`` budget (a just-started server publishing
    its address loses that race against an eager client routinely).  A
    file that never parses within the budget raises a named
    TransportError; a budget of 0 raises at the first failure."""
    from .resilience import backoff_delays

    budget = float(_mpit.cvar_read("connect_retry_timeout_s"))
    deadline = time.monotonic() + budget
    delays = backoff_delays()
    while True:
        content = ""
        try:
            with open(path) as f:
                content = f.read().strip()
        except OSError:
            pass
        got = _parse_hostport(content) if content else None
        if got is not None:
            return got
        if time.monotonic() > deadline:
            raise TransportError(
                f"server address file {path!r} was not published as a "
                f"parseable host:port within {budget}s "
                f"(content {content[:40]!r})")
        time.sleep(min(next(delays), 0.25))


def connect(addr: Any, timeout: float = 30.0, priority: int = 0):
    """Connect to a resident world server, or a federation of them.

    ``addr`` is ``"host:port"``, a ``(host, port)`` tuple, an in-process
    :class:`WorldServer`, or the path of a file holding ``host:port`` (the
    launcher's ``serve --addr-file``; a missing or partially written file
    is retried within the ``connect_retry_timeout_s`` budget): a
    :class:`ServerClient`.  A federation namespace (a directory, a
    ``raft:`` spec) or a list of ``"host:port"`` strings: a
    :class:`~mpi_tpu_torch.federation.FederatedClient`, which resolves
    live servers and fails acquire and stats over on a server's death."""
    if isinstance(addr, WorldServer):
        addr = addr.addr
    if isinstance(addr, (tuple, list)):
        # a server list only when every element is a "host:port" string;
        # anything else keeps the single-server (host, port) meaning
        if addr and all(isinstance(a, str) and ":" in a for a in addr):
            from . import federation as _federation

            return _federation.FederatedClient(
                addrs=list(addr), timeout=timeout, priority=priority)
        host, port = addr[0], int(addr[1])
        return ServerClient(host, port, timeout=timeout,
                            priority=priority)
    text = str(addr)
    if os.path.isdir(text) or text.startswith("raft:"):
        from . import federation as _federation

        return _federation.FederatedClient(
            namespace=text, timeout=timeout, priority=priority)
    direct = None if os.path.exists(text) else _parse_hostport(text)
    if direct is not None:
        host, port = direct
    elif os.path.exists(text) or os.sep in text:
        # an existing file, or a path-shaped string that must be an
        # address file still to be published: poll it within the budget
        host, port = _resolve_addr_file(text)
    else:
        # neither host:port nor path-shaped: a typo deserves an immediate
        # diagnosis, not a silent poll of the whole budget
        raise ValueError(
            f"connect: {text!r} is neither a host:port address nor a "
            f"path to an addr file / federation namespace")
    return ServerClient(host, port, timeout=timeout, priority=priority)


# -- CLI ----------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--worker":
        return _worker_main()
    ap = argparse.ArgumentParser(
        prog="mpi_tpu_torch.launcher serve",
        description="resident world server: pool warm workers, lease "
                    "worlds to clients, self-heal under kill injection")
    ap.add_argument("--pool-size", type=int, default=_POOL_SIZE)
    ap.add_argument("--backend", choices=("socket", "shm"),
                    default="socket")
    ap.add_argument("--device", default=None,
                    help="device of every worker ('cpu', or a card such "
                         "as 'cuda:0'; MPI_TPU_DEVICE); default: card "
                         "slot %% device_count")
    ap.add_argument("--host", default=_HOST)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--addr-file", default=None,
                    help="write host:port here once listening "
                         "(clients: mpi_tpu_torch.connect(path))")
    ap.add_argument("--detect-timeout", type=float,
                    default=_DETECT_TIMEOUT_S,
                    help="pool-internal fault detection bound (s)")
    ap.add_argument("--heartbeat", type=float, default=_HEARTBEAT_S)
    ap.add_argument("--lease-timeout", type=float,
                    default=_WORLD_LEASE_TIMEOUT_S,
                    help="world_lease_timeout_s: max wait for idle "
                         "workers and default job bound")
    ap.add_argument("--rejoin-timeout", type=float,
                    default=_REJOIN_TIMEOUT_S,
                    help="rejoin_timeout_s of one healing handshake")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve GET /metrics (Prometheus text format: "
                         "worlds/s, lease p50/p99, pool epoch, per-"
                         "worker health, aggregated worker pvars) on "
                         "this HTTP port; 0 binds an ephemeral port "
                         "(printed at startup)")
    ap.add_argument("--federation", default=None, metavar="SPEC",
                    help="join a federation namespace "
                         "(mpi_tpu_torch/federation.py): a shared DIR "
                         "(FileStore: one host or NFS), or "
                         "raft:<idx>@h0:p0,h1:p1,... to embed store node "
                         "<idx> of a replicated quorum group "
                         "(mpi_tpu_torch/federation_store.py: N hosts, no "
                         "shared FS; a partitioned minority refuses "
                         "leases with NoQuorumError).  N servers share "
                         "endpoint records and a CAS leader lease; a dead "
                         "server's pool is adopted by a survivor and its "
                         "workers re-register there; clients "
                         "connect(DIR | raft:h0:p0,...) and fail over")
    ap.add_argument("--server-id", default=None,
                    help="federation identity (default: random "
                         "srv-<hex8>)")
    ap.add_argument("--fed-lease-timeout", type=float,
                    default=_FED_LEASE_TIMEOUT_S, metavar="S",
                    help="leader-lease takeover bound; authority "
                         "self-expires at half this (the split-brain "
                         "safety margin)")
    ap.add_argument("--max-pending", type=int, default=_MAX_PENDING,
                    help="bounded admission queue depth: acquires "
                         "beyond this many waiters are rejected with "
                         "ServerBusyError instead of queueing "
                         "unboundedly")
    ap.add_argument("--orphan-timeout", type=float,
                    default=_ORPHAN_TIMEOUT_S, metavar="S",
                    help="how long an orphaned worker polls the "
                         "federation namespace for its pool's new owner "
                         "before exiting")
    args = ap.parse_args(argv)
    env_extra = {} if args.device is None else {ENV_DEVICE: args.device}
    server = WorldServer(
        pool_size=args.pool_size, backend=args.backend, host=args.host,
        port=args.port, detect_timeout_s=args.detect_timeout,
        heartbeat_s=args.heartbeat,
        world_lease_timeout_s=args.lease_timeout,
        rejoin_timeout_s=args.rejoin_timeout, env_extra=env_extra,
        metrics_port=args.metrics_port,
        federation=args.federation, server_id=args.server_id,
        fed_lease_timeout_s=args.fed_lease_timeout,
        max_pending=args.max_pending,
        orphan_timeout_s=args.orphan_timeout)
    server.start()
    print(f"mpi_tpu_torch serve: listening on {server.addr} "
          f"(pool {args.pool_size} x {args.backend})", flush=True)
    if args.federation:
        print(f"mpi_tpu_torch serve: federation member {server.server_id} "
              f"in {args.federation}", flush=True)
    if server.metrics_addr:
        print(f"mpi_tpu_torch serve: metrics on "
              f"http://{server.metrics_addr}/metrics", flush=True)
    if args.addr_file:
        tmp = args.addr_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(server.addr)
        os.replace(tmp, args.addr_file)
    try:
        while not server._closing:
            time.sleep(0.25)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
