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
for the launcher) runs them on the CPU.

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
from .gpu import primitives
from .gpu import (SpmdContextError, SpmdSemanticsError, TorchCommunicator,
                  rank_normal, rank_uniform, resolve_device, run_spmd)
from .interop import params_from_numpy, to_numpy, world_from_numpy
from .topology import (CartComm, GraphComm, cart_create, dims_create,
                       dist_graph_create_adjacent, graph_create)

from .membership import ENV_BACKEND, ENV_DEVICE, ENV_RANK, ENV_RDV, ENV_SIZE

# run_local keywords of the reference whose features are not ported yet
_UNPORTED_RUN_KWARGS = {"fault_tolerance": "16.2", "verify": "16.2",
                        "progress": "16.2", "trace": "16.3",
                        "tuning_table": "16.3"}

_world = None
_world_lock = threading.Lock()


def _shm_unported():
    return NotImplementedError(
        "backend 'shm' (the shared-memory ring transport) is not ported "
        "yet: ROADMAP.md item 16.4")


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
    MPI_COMM_WORLD.  Under the launcher this builds the socket transport
    from the launcher's environment; standalone it is a one-rank world
    (``"self"``)."""
    global _world
    with _world_lock:
        if _world is not None:
            return _world
        from .communicator import P2PCommunicator

        backend = backend or os.environ.get(ENV_BACKEND) or (
            "socket" if ENV_RANK in os.environ else "self")
        if backend == "socket":
            from .transport.socket import SocketTransport

            rank = int(os.environ[ENV_RANK])
            size = int(os.environ[ENV_SIZE])
            dev = _rank_device(rank, device)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            t = SocketTransport(rank, size, os.environ[ENV_RDV], device=dev)
            # close (and join the reader threads) before the interpreter
            # finalizes, also when the program never calls finalize()
            atexit.register(t.close)
            primitives.bind_host_rank(rank, dev, process=True)
            _world = P2PCommunicator(t, range(size))
        elif backend in ("self", "local"):
            from .transport.local import LocalTransport, LocalWorld

            dev = resolve_device(device)
            primitives.bind_host_rank(0, dev, process=True)
            _world = P2PCommunicator(
                LocalTransport(LocalWorld(1, device=dev), 0), range(1))
        elif backend == "shm":
            raise _shm_unported()
        else:
            raise ValueError(
                f"unknown backend {backend!r} for process-world init; the "
                f"SPMD path is entered via mpi_tpu_torch.run(fn, nranks=P)")
        return _world


def finalize() -> None:
    """MPI_Finalize: synchronize, close the transport, and warn about
    unexpected pending messages."""
    global _world
    with _world_lock:
        if _world is None:
            return
        _world.barrier()
        pending = _world.close_transport()
        _world = None
        primitives.unbind_host_process()
    if pending:
        import warnings

        warnings.warn(f"MPI_Finalize: {len(pending)} unreceived message(s): {pending[:8]}")


def run(fn: Callable, *args: Any, nranks: Optional[int] = None, device=None,
        backend: Optional[str] = None, **kwargs: Any):
    """Run a portable MPI program ``fn(comm, *args, **kwargs)``.

    * no backend, outside the launcher: one SPMD program over ``nranks``
      virtual ranks on ``device`` (default: the CUDA card); returns the
      per-rank results stacked ``[P, ...]``;
    * ``backend="local"``: ``nranks`` rank threads; returns the list of
      per-rank results;
    * ``backend="socket"`` (the default under the launcher) or ``"self"``:
      ``fn`` on this process's world communicator; returns its result.

    ``device`` defaults to the card for every backend and never falls back
    to the CPU on its own."""
    if backend is None:
        backend = os.environ.get(ENV_BACKEND) or (
            "socket" if ENV_RANK in os.environ else None)
    if backend in ("local", "socket", "self"):
        for name, item in _UNPORTED_RUN_KWARGS.items():
            if name in kwargs:
                raise NotImplementedError(
                    f"run(..., {name}=) is not ported yet: ROADMAP.md item "
                    f"{item}")
    if backend in ("socket", "self"):
        return fn(init(backend, device), *args, **kwargs)
    if backend == "local":
        from .transport.local import run_local

        if nranks is None:
            nranks = int(os.environ.get(ENV_SIZE, "1"))
        return run_local(fn, nranks, args=args, kwargs=kwargs, device=device)
    if backend == "shm":
        raise _shm_unported()
    if backend not in (None, "gpu"):
        raise ValueError(f"unknown backend {backend!r}")
    return run_spmd(fn, *args, nranks=nranks, device=device, **kwargs)


def __getattr__(name: str):
    if name == "COMM_WORLD":
        return init()
    raise AttributeError(f"module 'mpi_tpu_torch' has no attribute {name!r}")


__all__ = ["CartComm", "GraphComm", "SpmdContextError", "SpmdSemanticsError",
           "TorchCommunicator", "cart_create", "datatypes", "dims_create",
           "dist_graph_create_adjacent", "finalize", "graph_create", "init",
           "ops", "params_from_numpy", "rank_normal",
           "rank_uniform", "resolve_device", "run", "run_spmd", "to_numpy",
           "world_from_numpy"]
