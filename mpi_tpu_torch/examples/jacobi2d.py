"""2-D Jacobi stencil on a Cartesian process grid — counterpart of
``examples/jacobi2d.py``.

The global domain is tiled over a ``pr x pc`` Cartesian topology
(``dims_create`` balances the factorization).  Each iteration exchanges
one-row/one-column halos with all four neighbors (``cart.exchange``, one
ppermute per direction), then sweeps the 5-point stencil.  The hot global
top edge is 1.0, every other edge 0.0 (the boundary problem of
``examples/jacobi.py``, so the two decompositions can be cross-checked).

    python -m mpi_tpu_torch.examples.jacobi2d -n 8               # CUDA
    python -m mpi_tpu_torch.examples.jacobi2d -n 8 --device cpu
"""

from __future__ import annotations

import argparse

import torch

import mpi_tpu_torch
from mpi_tpu_torch import ops
from mpi_tpu_torch.topology import CartComm, dims_create


def jacobi2d_step(cart: CartComm, local: torch.Tensor) -> torch.Tensor:
    """One 4-direction halo exchange + 5-point sweep on this rank's tile."""
    _, pc = cart.dims
    row, col = cart.coords  # batched integer tensors
    # dim 0 = rows of the process grid: my bottom row goes down (+1), the
    # neighbor's bottom row arrives from above; and vice versa.
    north = cart.exchange(local[-1], dim=0, disp=1, fill=0.0)
    north = torch.where(row == 0, torch.ones_like(north), north)  # hot top edge
    south = cart.exchange(local[0], dim=0, disp=-1, fill=0.0)
    west = cart.exchange(local[:, -1], dim=1, disp=1, fill=0.0)
    east = cart.exchange(local[:, 0], dim=1, disp=-1, fill=0.0)
    zero = local.new_zeros((1,))
    padded = torch.cat([north[None], local, south[None]], dim=0)
    padded = torch.cat([torch.cat([zero, west, zero])[:, None], padded,
                        torch.cat([zero, east, zero])[:, None]], dim=1)
    new = 0.25 * (padded[:-2, 1:-1] + padded[2:, 1:-1]
                  + padded[1:-1, :-2] + padded[1:-1, 2:])
    # global side walls stay fixed at 0 on boundary tiles (the reference's
    # new.at[:, 0].mul(keep_w).at[:, -1].mul(keep_e), out of place)
    cols = torch.arange(new.shape[1], device=new.device)
    keep_w = torch.where((col == 0) & (cols == 0), 0.0, 1.0)
    keep_e = torch.where((col == pc - 1) & (cols == new.shape[1] - 1), 0.0, 1.0)
    return new * keep_w * keep_e


def jacobi2d_program(comm, tile_rows: int = 8, tile_cols: int = 8,
                     iters: int = 100, dims=None):
    """Returns (final local tile, global max-residual of the last sweep)."""
    dims = dims or dims_create(comm.size, 2)
    cart = CartComm(comm, dims)
    local = torch.zeros((tile_rows, tile_cols), dtype=torch.float32,
                        device=comm.device)
    prev = local
    for _ in range(iters):
        local, prev = jacobi2d_step(cart, local), local
    residual = comm.allreduce(torch.max(torch.abs(local - prev)), op=ops.MAX)
    return local, residual


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--nranks", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--rows", type=int, default=8, help="rows per tile")
    ap.add_argument("--cols", type=int, default=8, help="cols per tile")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    _, res = mpi_tpu_torch.run(jacobi2d_program, nranks=args.nranks,
                               device=args.device, tile_rows=args.rows,
                               tile_cols=args.cols, iters=args.iters)
    print(f"jacobi2d: {args.iters} iters, last-sweep max residual "
          f"{float(res[0]):.3e}")


if __name__ == "__main__":
    main()
