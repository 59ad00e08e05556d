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

The package imports torch, numpy and the standard library only; the JAX
package ``mpi_tpu`` is its reference and is never imported.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from . import datatypes, ops
from .gpu import (SpmdContextError, SpmdSemanticsError, TorchCommunicator,
                  rank_normal, rank_uniform, resolve_device, run_spmd)
from .interop import params_from_numpy, to_numpy, world_from_numpy
from .topology import (CartComm, GraphComm, cart_create, dims_create,
                       dist_graph_create_adjacent, graph_create)

_HOST_BACKENDS = ("socket", "local", "shm", "self")


def run(fn: Callable, *args: Any, nranks: Optional[int] = None, device=None,
        backend: Optional[str] = None, **kwargs: Any):
    """Run a portable MPI program ``fn(comm, *args, **kwargs)`` as one SPMD
    program over ``nranks`` virtual ranks on ``device`` (default: the CUDA
    card; it never falls back to the CPU on its own).  Returns the stacked
    per-rank results."""
    if backend in _HOST_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is a host transport of mpi_tpu and is not "
            f"ported yet: see ROADMAP.md, 'Port queue' (host layer)")
    if backend not in (None, "gpu"):
        raise ValueError(f"unknown backend {backend!r}")
    return run_spmd(fn, *args, nranks=nranks, device=device, **kwargs)


__all__ = ["CartComm", "GraphComm", "SpmdContextError", "SpmdSemanticsError",
           "TorchCommunicator", "cart_create", "datatypes", "dims_create",
           "dist_graph_create_adjacent", "graph_create", "ops", "params_from_numpy", "rank_normal",
           "rank_uniform", "resolve_device", "run", "run_spmd", "to_numpy",
           "world_from_numpy"]
