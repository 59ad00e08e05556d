"""Jacobi stencil with halo exchange — counterpart of ``examples/jacobi.py``.

2-D heat problem: the global top edge is held at 1.0, every other boundary
at 0.0; the grid is decomposed by rows across ranks.  Each iteration
exchanges one-row halos with both neighbours (``comm.shift``, one ppermute
each way) and sweeps a 5-point stencil; the convergence norm is an
``allreduce(MAX)``.

    python -m mpi_tpu_torch.examples.jacobi --nranks 8            # CUDA
    python -m mpi_tpu_torch.examples.jacobi --nranks 8 --device cpu
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

import mpi_tpu_torch
from mpi_tpu_torch import ops


def jacobi_step(comm, local: torch.Tensor) -> torch.Tensor:
    """One halo exchange + 5-point sweep on this rank's row block."""
    # my last row goes down to rank+1; their last row arrives from rank-1
    above = comm.shift(local[-1], offset=1, wrap=False, fill=0.0)
    # hot top edge (as_tensor: the rank is an int on the host backends)
    top = torch.as_tensor(comm.rank == 0, device=above.device)
    above = torch.where(top, torch.ones_like(above), above)
    below = comm.shift(local[0], offset=-1, wrap=False, fill=0.0)
    padded = torch.cat([above[None], local, below[None]], dim=0)
    north, south = padded[:-2], padded[2:]
    west = F.pad(local[:, :-1], (1, 0))
    east = F.pad(local[:, 1:], (0, 1))
    new = 0.25 * (north + south + west + east)
    # vertical side walls are fixed at 0
    wall = torch.zeros_like(new[:, :1])
    return torch.cat([wall, new[:, 1:-1], wall], dim=1)


def jacobi_program(comm, rows_per_rank: int = 16, cols: int = 32, iters: int = 100):
    """Returns (final local block, global max-residual of the last sweep)."""
    local = torch.zeros((rows_per_rank, cols), dtype=torch.float32,
                        device=comm.device)
    prev = local
    for _ in range(iters):
        local, prev = jacobi_step(comm, local), local
    residual = comm.allreduce(torch.max(torch.abs(local - prev)), op=ops.MAX)
    return local, residual


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--nranks", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--rows", type=int, default=16, help="rows per rank")
    ap.add_argument("--cols", type=int, default=32)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    _, res = mpi_tpu_torch.run(jacobi_program, nranks=args.nranks,
                               device=args.device, rows_per_rank=args.rows,
                               cols=args.cols, iters=args.iters)
    print(f"jacobi: {args.iters} iters, last-sweep max residual "
          f"{float(res[0]):.3e}")


if __name__ == "__main__":
    main()
