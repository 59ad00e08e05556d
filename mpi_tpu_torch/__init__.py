"""mpi_tpu_torch — the PyTorch/CUDA port of mpi_tpu's SPMD path.

MPI programs written against the communicator API run as one SPMD program
over P virtual ranks on one CUDA card: ``run(fn, *args, nranks=P)`` calls
``fn(comm, *args)`` once per rank under ``torch.vmap`` and returns the
per-rank results stacked ``[P, ...]``.  Collectives keep the reference's
``algorithm=`` names; ``"pallas_ring"`` runs the hand-written CUDA ring
kernel (``csrc/ring.cu``).  ``gpu.attention.ring_attention`` is exact ring
attention over the ranks, forward and backward on the CUDA kernels of
``csrc/attention.cu`` and ``csrc/attention_bwd.cu``.  ``comm.win_create``
gives fence-epoch RMA windows, ``datatypes`` the MPI derived datatypes,
``CartComm``/``cart_create``/``graph_create`` the process topologies,
``entry.dryrun_multichip`` one training step over a 2-D (dp, mp) layout
that runs every parallelism primitive, ``entry.lower_multichip`` /
``export_multichip`` that step traced and exported ahead of time (``aot``),
``checkpoint.save_sharded`` / ``load_sharded`` sharded state, and
``profiling`` traces and timings.

The host layer runs the same programs as real ranks that exchange
tensors through a transport, the reference's process backends:
``run(fn, backend="local", nranks=P)`` runs P rank threads (one result
per rank, in a list), ``python -m mpi_tpu_torch.launcher -n P prog.py``
runs P rank processes over TCP (``run(fn)`` there picks ``"socket"``, as
``init()`` / ``COMM_WORLD`` do), and ``backend="self"`` is a one-rank
world.  Their tensors stay on the card; ``device="cpu"`` (``--device cpu``
for the launcher) runs them on the CPU.  The host layer's nonblocking
engine and fault tolerance: ``run(..., backend="local",
progress="thread", fault_tolerance=True, transport_wrapper=...)`` (the
launcher's ``--progress thread`` and ``MPI_TPU_FT=1``), the
i-collectives and persistent collectives, ``revoke`` / ``shrink`` /
``agree`` (``ft``) and elastic membership (``membership.rejoin``,
``comm.accept_rejoin``).  The correctness and observability tooling:
``run(..., backend="local", verify=True, trace=True)`` (the launcher's
``--verify`` and ``--trace-dir``, ``MPI_TPU_VERIFY=1`` and
``MPI_TPU_TRACE`` under ``init()``) runs the runtime verifier
(``verify``: deadlocks, collective matching, request and buffer lints,
wildcard races) and the flight recorder (``telemetry``, histogram pvars
and sessions in ``mpit``, ``profiling.comm_stats``); the static linter is
``python -m mpi_tpu_torch.tools.mpilint`` and the trace merger
``python -m mpi_tpu_torch.tools.tracecat``.  The same-host data plane:
``python -m mpi_tpu_torch.launcher -n P --backend shm prog.py`` runs the
ranks over the native shared-memory rings (``transport.shm``, with
``transport.shm.run_shm`` for rank threads in one process), where the
collectives take the shared-memory arena (``coll_sm``, ``algorithm="sm"``
and ``"auto"``); ``algorithm="compressed:bf16"`` / ``":int8"`` /
``":topk"`` compress the wire (``compress``); ``run(...,
tuning_table=path)`` and ``--tuning-table`` serve ``"auto"`` from a
measured table (``tuning``, swept by ``python -m
mpi_tpu_torch.tools.tune``); ``comm.win_create`` /
``win_create_dynamic`` give one-sided windows on every host backend and
``win_allocate_shared`` a shared-memory window.  Process checkpoints:
``checkpoint.save`` / ``exists`` / ``load`` (the launcher's ``--restarts``
resumes from the last committed generation).  Hierarchical dispatch:
``HierarchicalComm`` / ``split_hierarchical`` (the arena inside a node,
the wire between nodes).  The flat MPI layer: ``from mpi_tpu_torch.api
import *`` (``MPI_Init`` ... ``MPI_Finalize``), with ``mpi4`` (sessions,
partitioned point-to-point, generic persistent collectives),
``InterComm`` / ``create_intercomm`` and ``COMM_SELF`` / ``comm_self``.
Dynamic processes: ``comm_spawn`` / ``comm_spawn_multiple`` /
``comm_get_parent``, ``open_port`` / ``comm_accept`` / ``comm_connect``
and the name service (``spawn``; children run on the card unless
``MPI_TPU_DEVICE`` says otherwise).  Parallel files: ``io.file_open``
with views, datareps, shared pointers and collective buffering (reads
return tensors on the communicator's device).  ``irecv(buf=...)`` and
``recv_init(buf=...)`` on the socket and shm backends land a matched
frame's bytes in the user's buffer itself.  The resident world server:
``python -m mpi_tpu_torch.launcher serve`` (``serve.WorldServer``) keeps
a pool of warm worker processes on the card and leases them as worlds;
``connect(addr)`` -> ``acquire(n)`` -> ``lease.run(fn, *args)``.
The top level binds every name of the reference's ``__all__`` whose
module is ported (``tests/test_torch_names.py`` holds the list of those
still to come).

The package imports torch, numpy and the standard library only; the JAX
package ``mpi_tpu`` is its reference and is never imported.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Any, Callable, Optional

import torch

from . import datatypes, ops
from .ops import (BAND, BOR, BXOR, LAND, LOR, LXOR, MAX, MIN, PROD, SUM,
                  ReduceOp)
from .gpu import primitives
from .gpu import (SpmdContextError, SpmdSemanticsError, TorchCommunicator,
                  rank_normal, rank_uniform, resolve_device, run_spmd)
from .interop import params_from_numpy, to_numpy, world_from_numpy
from .topology import (CartComm, GraphComm, cart_create, dims_create,
                       dist_graph_create_adjacent, graph_create)

from .membership import (ENV_BACKEND, ENV_DEVICE, ENV_RANK, ENV_RDV,
                         ENV_SIZE, rejoin)
from .shmwin import SharedWindow, win_allocate_shared
from .communicator import (Communicator, Message, P2PCommunicator, Request,
                           Status)
from .transport.base import ANY_SOURCE, ANY_TAG
from .transport.local import run_local
from .group import Group
from .window import GetFuture, P2PWindow
from .topology import HierarchicalComm, split_hierarchical
from .intercomm import InterComm, create_intercomm
from . import (api, checker, checkpoint, errors, ft, io, membership, mpi4,
               profiling, progress, schedules, spawn, telemetry, trace,
               verify)
from .spawn import (close_port, comm_accept, comm_connect, comm_get_parent,
                    comm_spawn, comm_spawn_multiple, lookup_name, open_port,
                    publish_name, unpublish_name)

# the port's version: the reference's (mpi_tpu/version.py) it tracks
__version__ = "0.1.0"

# the local backend's world options (transport/local.py run_local)
_LOCAL_RUN_KWARGS = ("fault_tolerance", "progress", "transport_wrapper",
                     "verify", "trace", "tuning_table")

_world = None
_world_lock = threading.Lock()


def is_initialized() -> bool:
    """MPI_Initialized: whether this process's world communicator exists
    (``mpi_tpu/__init__.py:93``)."""
    return _world is not None


def _rank_device(rank: int, device=None) -> torch.device:
    """The device of host rank ``rank``: ``device`` when given, else the
    launcher's ``MPI_TPU_DEVICE``, else card ``rank % device_count``.
    Without a card and without ``"cpu"`` it raises (never a fallback)."""
    if device is None:
        device = os.environ.get(ENV_DEVICE) or None
    if device is None and torch.cuda.is_available():
        device = f"cuda:{rank % torch.cuda.device_count()}"
    return resolve_device(device)


def init(backend: Optional[str] = None, device=None):
    """Create (or return) the world communicator — MPI_Init +
    MPI_COMM_WORLD.  Under the launcher this builds the socket (or, with
    ``--backend shm``, the shared-memory) transport from the launcher's
    environment; standalone it is a one-rank world (``"self"``)."""
    global _world
    with _world_lock:
        if _world is not None:
            return _world
        from .communicator import P2PCommunicator

        backend = backend or os.environ.get(ENV_BACKEND) or (
            "socket" if ENV_RANK in os.environ else "self")
        if backend in ("socket", "shm"):
            from . import membership, progress

            rank = int(os.environ[ENV_RANK])
            size = int(os.environ[ENV_SIZE])
            rdv = os.environ[ENV_RDV]
            dev = _rank_device(rank, device)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            t = membership.make_transport(backend, rank, size, rdv,
                                          device=dev)
            # the flight recorder (MPI_TPU_TRACE / --trace-dir), enabled
            # before the first collective so world-construction traffic is
            # on the timeline too
            from . import telemetry

            telemetry.enable_from_env(rank=rank)
            primitives.bind_host_rank(rank, dev, process=True)
            # which incarnation holds this slot: accept_rejoin refuses an
            # ousted-but-live one until its failure is acknowledged
            membership.publish_incarnation(rdv, rank)
            _world = P2PCommunicator(t, range(size))._mark_generation()
            if os.environ.get("MPI_TPU_FT", "") not in ("", "0"):
                # ULFM (ft.py): heartbeat files under the rendezvous dir
                # and a detector thread, started once every slot has
                # published its incarnation (the bounded start barrier)
                from . import ft

                membership.await_incarnations(rdv, size)
                ft.enable(_world, rdv_dir=rdv)
            if os.environ.get("MPI_TPU_VERIFY", "") not in ("", "0"):
                # the runtime verifier: pending-op files under the
                # rendezvous dir — deadlocks surface as DeadlockError,
                # divergent collectives as CollectiveMismatchError
                from . import verify

                verify.enable(_world, rdv_dir=rdv)
            if progress.resolve_mode() == "thread":
                progress.enable(_world)  # MPI_TPU_PROGRESS / --progress
            # stop the detector and the engine and close the transport
            # (joining their threads) before the interpreter finalizes,
            # also when the program never calls finalize(): a helper
            # thread inside a torch call at finalization aborts the rank
            atexit.register(_world.close_transport)
        elif backend in ("self", "local"):
            from .transport.local import LocalTransport, LocalWorld

            # called from a host rank (a rank thread), the world lives on
            # that rank's device; otherwise on the card unless told
            dev = resolve_device(device if device is not None
                                 else primitives.host_rank_device())
            from . import telemetry

            telemetry.enable_from_env(rank=0)
            primitives.bind_host_rank(0, dev, process=True)
            _world = P2PCommunicator(
                LocalTransport(LocalWorld(1, device=dev), 0), range(1))
        else:
            raise ValueError(
                f"unknown backend {backend!r} for process-world init; the "
                f"SPMD path is entered via mpi_tpu_torch.run(fn, nranks=P)")
        return _world


def finalize() -> None:
    """MPI_Finalize: synchronize, close the transport, and warn about
    unexpected pending messages.  With the verifier on the rank publishes
    'exited' and its finalize report (leaked requests, unfreed
    communicators, recorded lints) comes as a warning; with a trace dir
    the flight recorder exports this rank's trace."""
    from . import telemetry

    global _world
    with _world_lock:
        if _world is None:
            return
        _world.barrier()
        verified = _world._verify is not None
        if verified:
            _world._verify.world.mark_exited()
        rec = telemetry.REC
        if rec is not None and rec.trace_dir:
            # the orderly exit's export (atexit covers sys.exit paths;
            # same file name, atomic replace)
            rec.export_to_dir()
        pending = _world.close_transport()
        _world = None
        primitives.unbind_host_process()
    mpi4._cfg_prune_all()  # session generation counters die with the world
    import warnings

    if pending:
        warnings.warn(f"MPI_Finalize: {len(pending)} unreceived message(s): {pending[:8]}")
    if verified:
        from . import verify

        problems = verify.finalize_report()
        if problems:
            warnings.warn("MPI_Finalize: verifier report:\n  "
                          + "\n  ".join(problems))


def run(fn: Callable, *args: Any, nranks: Optional[int] = None, device=None,
        backend: Optional[str] = None, **kwargs: Any):
    """Run a portable MPI program ``fn(comm, *args, **kwargs)``.

    * no backend, outside the launcher: one SPMD program over ``nranks``
      virtual ranks on ``device`` (default: the CUDA card); returns the
      per-rank results stacked ``[P, ...]``;
    * ``backend="local"``: ``nranks`` rank threads; returns the list of
      per-rank results.  ``fault_tolerance``, ``progress``,
      ``transport_wrapper``, ``verify``, ``trace`` and ``tuning_table``
      configure the world (``transport.local.run_local``);
    * ``backend="socket"`` (the default under the launcher), ``"shm"``
      (under the launcher's ``--backend shm``) or ``"self"``: ``fn`` on
      this process's world communicator; returns its result.

    ``device`` defaults to the card for every backend and never falls back
    to the CPU on its own."""
    if backend is None:
        backend = os.environ.get(ENV_BACKEND) or (
            "socket" if ENV_RANK in os.environ else None)
    if backend in ("socket", "shm", "self"):
        for name in ("fault_tolerance", "progress", "verify", "trace",
                     "tuning_table"):
            if name in kwargs:
                raise ValueError(
                    f"run(..., {name}=) configures the local backend; a "
                    f"process world takes it from the launcher "
                    f"(MPI_TPU_FT=1, --progress thread, --verify, "
                    f"--trace-dir, --tuning-table)")
        return fn(init(backend, device), *args, **kwargs)
    if backend == "local":
        from .transport.local import run_local

        if nranks is None:
            nranks = int(os.environ.get(ENV_SIZE, "1"))
        world = {k: kwargs.pop(k) for k in _LOCAL_RUN_KWARGS if k in kwargs}
        return run_local(fn, nranks, args=args, kwargs=kwargs, device=device,
                         **world)
    if backend not in (None, "gpu"):
        raise ValueError(f"unknown backend {backend!r}")
    return run_spmd(fn, *args, nranks=nranks, device=device, **kwargs)


_self_store = threading.local()


def comm_self(device=None):
    """MPI_COMM_SELF [S]: the size-1 communicator holding only this rank
    (``mpi_tpu/__init__.py:243``), independent of any world backend; its
    collectives are identities.  Per THREAD, not per process, as the
    reference's: the local backend runs ranks as threads, and one SELF
    per process would share one mailbox across them.  Its device is
    ``device``, else the device bound to this rank (a host rank thread or
    process), else the card; without a card it raises unless the caller
    passes ``device="cpu"`` (never a fallback)."""
    comm = getattr(_self_store, "comm", None)
    if comm is None:
        from .transport.local import LocalTransport, LocalWorld

        if device is None:
            device = primitives.host_rank_device()
        dev = resolve_device(device)
        comm = P2PCommunicator(LocalTransport(LocalWorld(1, device=dev), 0),
                               range(1))
        _self_store.comm = comm
    return comm


def connect(addr, timeout: float = 30.0, priority: int = 0):
    """Connect to a resident world server (``serve.py``): returns a
    :class:`~mpi_tpu_torch.serve.ServerClient` whose ``acquire(nranks)``
    leases warm workers as a world.  ``addr`` is ``"host:port"``, a
    ``WorldServer`` or the path of a ``serve --addr-file`` file (retried
    within the ``connect_retry_timeout_s`` budget while it is missing).
    A ``serve --federation`` namespace (a directory or a ``raft:`` spec)
    or a list of ``"host:port"`` strings returns a
    :class:`~mpi_tpu_torch.federation.FederatedClient` instead, which
    resolves live servers and fails over on a server's death
    (``mpi_tpu/__init__.py:57-58``).  The serve module is imported here, not with the package: it is also
    the workers' ``-m`` entry point (``mpi_tpu/__init__.py:50``)."""
    from . import serve as _serve

    return _serve.connect(addr, timeout=timeout, priority=priority)


def __getattr__(name: str):
    if name == "COMM_WORLD":
        return init()
    if name == "COMM_SELF":
        return comm_self()
    if name == "serve":
        # lazy, as connect: mpi_tpu_torch.serve is the workers' -m entry
        import importlib

        return importlib.import_module(".serve", __name__)
    raise AttributeError(f"module 'mpi_tpu_torch' has no attribute {name!r}")


__all__ = [
    "__version__", "ops", "ReduceOp",
    "SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND", "BOR", "BXOR",
    "Communicator", "Message", "P2PCommunicator", "Request", "Status",
    "ANY_SOURCE", "ANY_TAG",
    "init", "finalize", "is_initialized", "run", "run_local",
    "schedules", "checker", "checkpoint", "ft", "membership", "profiling",
    "progress", "telemetry", "trace", "verify", "COMM_WORLD", "COMM_SELF",
    "comm_self", "mpi4", "api", "errors", "rejoin", "io", "spawn",
    "connect", "serve",
    "comm_spawn", "comm_spawn_multiple", "comm_get_parent", "open_port",
    "close_port", "comm_accept", "comm_connect", "publish_name",
    "unpublish_name", "lookup_name",
    "CartComm", "GraphComm", "HierarchicalComm", "InterComm",
    "create_intercomm", "cart_create", "graph_create", "split_hierarchical",
    "dist_graph_create_adjacent", "dims_create", "Group",
    "GetFuture", "P2PWindow", "SharedWindow", "win_allocate_shared",
    "SpmdContextError", "SpmdSemanticsError", "TorchCommunicator",
    "datatypes", "params_from_numpy", "rank_normal", "rank_uniform",
    "resolve_device", "run_spmd", "to_numpy", "world_from_numpy",
]
