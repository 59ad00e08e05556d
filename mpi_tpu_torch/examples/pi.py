"""Distributed π Monte-Carlo — counterpart of ``examples/pi.py``.

Each rank samples from its own ``torch.Generator`` (seeded from the seed
and its rank) and the hit counts are summed with ``allreduce``.

    python -m mpi_tpu_torch.examples.pi --nranks 8
"""

from __future__ import annotations

import argparse

import torch

import mpi_tpu_torch
from mpi_tpu_torch import ops, rank_uniform


def pi_program(comm, n_per_rank: int = 200_000, seed: int = 42):
    pts = rank_uniform((n_per_rank, 2), seed)
    hits = torch.sum((pts * pts).sum(dim=1) <= 1.0, dtype=torch.float32)
    total = comm.allreduce(hits, op=ops.SUM)
    return 4.0 * total / (n_per_rank * comm.size)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--nranks", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--samples", type=int, default=200_000)
    args = ap.parse_args()
    est = mpi_tpu_torch.run(pi_program, nranks=args.nranks, device=args.device,
                            n_per_rank=args.samples)
    est = float(est[0])
    print(f"pi ~= {est:.6f}  (error {abs(est - 3.141592653589793):.2e})")


if __name__ == "__main__":
    main()
