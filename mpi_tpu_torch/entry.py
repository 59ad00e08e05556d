"""Entry point: the flagship step — counterpart of ``__graft_entry__.py:62``.

``entry()`` returns a forward step of the Jacobi halo-exchange workload (one
``jacobi_step`` plus the MAX allreduce of its residual) run as an SPMD
program over ``nranks`` ranks, with the grid split by rows, and an example
argument.  ``f(grid)`` returns ``(new grid, residual)``.
"""

from __future__ import annotations

import torch

from . import ops
from .examples.jacobi import jacobi_step
from .gpu import TorchCommunicator, resolve_device, run_spmd


def entry(nranks: int = 1, device=None):
    dev = resolve_device(device)
    world = TorchCommunicator(nranks)

    def fwd(comm, grid):
        local = grid.reshape(comm.size, -1, grid.shape[-1])[comm.rank]
        new = jacobi_step(comm, local)
        residual = comm.allreduce(torch.max(torch.abs(new - local)), op=ops.MAX)
        return new, residual

    def f(grid: torch.Tensor):
        new, residual = run_spmd(fwd, grid, comm=world, device=dev)
        return new.reshape(grid.shape), residual[0]

    example = torch.zeros((64, 128), dtype=torch.float32, device=dev)
    return f, (example,)
