"""Data-parallel training via allreduce — counterpart of
``examples/data_parallel.py``.

A small MLP regression trained with per-rank batch shards: each rank
computes local gradients with ``torch.func.grad_and_value``, gradients are
averaged with the hand-scheduled ring-allreduce (the north-star schedule),
and every rank applies the identical SGD step — the textbook DP loop.  A
ZeRO-style variant is one substitution away: ``comm.reduce_scatter`` +
``allgather`` instead of ``allreduce``.

    python -m mpi_tpu_torch.examples.data_parallel -n 8          # CUDA
    python -m mpi_tpu_torch.examples.data_parallel -n 8 --device cpu
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

import mpi_tpu_torch
from mpi_tpu_torch import ops

Params = Dict[str, torch.Tensor]


def init_params(d_in: int = 8, d_hidden: int = 16, seed: int = 0) -> Dict[str, np.ndarray]:
    """The MLP's weights as float32 numpy arrays, the same on every rank
    (the reference draws them with ``jax.random``, so the values differ)."""
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(d_in, d_hidden) * 0.3).astype(np.float32),
            "w2": (rng.randn(d_hidden, 1) * 0.3).astype(np.float32)}


def dp_train(comm, params: Params, x: torch.Tensor, y: torch.Tensor,
             steps: int = 20, lr: float = 0.05):
    """``steps`` SGD steps of the MLP on this rank's shard (x, y) with the
    ring-allreduce mean of the gradients.  Returns (final loss averaged over
    ranks, final params checksum)."""
    # params stay rank-local state until the explicit allreduce
    params = comm.localize(dict(params))

    def loss_fn(p):
        h = torch.tanh(x @ p["w1"])
        return torch.mean((h @ p["w2"] - y) ** 2)

    loss = torch.zeros((), device=x.device)
    for _ in range(steps):
        grads, loss = torch.func.grad_and_value(loss_fn)(params)
        # gradient sync: ring-allreduce then average — the DP collective
        grads = {n: comm.allreduce(g, op=ops.SUM, algorithm="ring") / comm.size
                 for n, g in grads.items()}
        params = {n: p - lr * grads[n] for n, p in params.items()}
    mean_loss = comm.allreduce(loss, op=ops.SUM) / comm.size
    checksum = sum(torch.sum(torch.abs(v)) for v in params.values())
    return mean_loss, checksum


def dp_inputs(comm, batch_per_rank: int = 32, d_in: int = 8, d_hidden: int = 16):
    """(params, x, y): the shared initial weights, and this rank's shard of
    a fixed synthetic regression task from its own generator
    (``rank_normal``)."""
    params = mpi_tpu_torch.params_from_numpy(init_params(d_in, d_hidden),
                                             comm.device)
    x = mpi_tpu_torch.rank_normal((batch_per_rank, d_in), 1)
    y = torch.sin(x.sum(dim=1, keepdim=True))
    return params, x, y


def dp_train_program(comm, steps: int = 20, batch_per_rank: int = 32,
                     d_in: int = 8, d_hidden: int = 16, lr: float = 0.05):
    """Returns (final loss averaged over ranks, final params checksum)."""
    params, x, y = dp_inputs(comm, batch_per_rank, d_in, d_hidden)
    return dp_train(comm, params, x, y, steps, lr)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--nranks", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    loss, _ = mpi_tpu_torch.run(dp_train_program, nranks=args.nranks,
                                device=args.device, steps=args.steps)
    print(f"data-parallel training: final mean loss {float(loss[0]):.5f} "
          f"after {args.steps} steps")


if __name__ == "__main__":
    main()
