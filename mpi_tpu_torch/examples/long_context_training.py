"""Long-context training over the fused ring attention — counterpart of
``examples/long_context_training.py``.

One transformer block (q/k/v projections, causal ring attention, output
projection, MLP) over a sequence sharded across ranks.  Both attention
passes run the ring kernels (forward, and the dQ / dK-dV backward); the
weights are replicated, so every gradient and the loss are averaged over
the ranks with one ``comm.allreduce`` each.  The step is checked against
the same block trained on one device with dense attention
(``dense_train_step``).

    python -m mpi_tpu_torch.examples.long_context_training -n 8 \\
        --seq-per-rank 4096 --d 128 --steps 3
    python -m mpi_tpu_torch.examples.long_context_training --device cpu
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn

import mpi_tpu_torch
from mpi_tpu_torch.gpu.attention import ring_attention
from mpi_tpu_torch.interop import params_from_numpy

Params = Dict[str, torch.Tensor]


def init_params(d: int, hidden: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """One block's weights as float32 numpy arrays, drawn exactly as the
    reference's ``init_params`` (examples/long_context_training.py:41)."""
    rng = np.random.RandomState(seed)

    def w(*shape):
        return (rng.randn(*shape) * (1.0 / math.sqrt(shape[0]))).astype(np.float32)

    return {"wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
            "w1": w(d, hidden), "w2": w(hidden, d)}


class TransformerBlock(nn.Module):
    """``block_forward`` (:53) on a ``[rows, d]`` slice; weights keep the
    reference's ``x @ W`` layout.  ``attention_fn(q, k, v)`` is the only
    op that is not local: dense on one device, a ring across ranks."""

    def __init__(self, d: int, hidden: int, device=None):
        super().__init__()
        shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
                  "w1": (d, hidden), "w2": (hidden, d)}
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape, device=device)))

    def forward(self, x: torch.Tensor, attention_fn: Callable) -> torch.Tensor:
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        h = x + attention_fn(q, k, v) @ self.wo
        return h + torch.relu(h @ self.w1) @ self.w2


def block_from_numpy(params: Dict[str, np.ndarray], device) -> TransformerBlock:
    d, hidden = params["w1"].shape
    block = TransformerBlock(d, hidden, device=device)
    block.load_state_dict(params_from_numpy(params, device))
    return block


def _loss(block: TransformerBlock, params: Params, x, y, attention_fn):
    pred = torch.func.functional_call(block, params, (x, attention_fn))
    return torch.mean((pred - y) ** 2)


def sharded_train_step(comm, block: TransformerBlock) -> Callable:
    """→ ``step(params, x_block, y_block)`` for one rank, called inside
    ``mpi_tpu_torch.run``: (loss, grads) with causal ring attention, both
    averaged over the ranks.  As in the reference (:81-98), each rank's
    gradient is that of every rank's loss restricted to the terms its
    shard computed (the ring backward hands each rank's cotangent to the
    blocks that need it), and their mean is the gradient of the mean
    loss."""

    def attention_fn(q, k, v):
        return ring_attention(q, k, v, comm, causal=True)

    def step(params: Params, xb: torch.Tensor, yb: torch.Tensor):
        grads, loss = torch.func.grad_and_value(
            lambda p: _loss(block, p, xb, yb, attention_fn))(params)
        loss = comm.allreduce(loss) / comm.size
        grads = {n: comm.allreduce(g) / comm.size for n, g in grads.items()}
        return loss, grads

    return step


def dense_attention(q, k, v):
    s = (q @ k.T) / math.sqrt(q.shape[-1])
    n = s.shape[0]
    causal = torch.ones((n, n), dtype=torch.bool, device=s.device).tril()
    s = s.masked_fill(~causal, -math.inf)
    return torch.softmax(s, dim=-1) @ v


def dense_train_step(block: TransformerBlock) -> Callable:
    """The one-device oracle (:103): the same block, dense causal
    attention over the whole sequence."""

    def step(params: Params, x: torch.Tensor, y: torch.Tensor):
        grads, loss = torch.func.grad_and_value(
            lambda p: _loss(block, p, x, y, dense_attention))(params)
        return loss, grads

    return step


def sharded_program(comm, block: TransformerBlock, params: Params,
                    x: torch.Tensor, y: torch.Tensor):
    """One sharded step on the global ``[S, d]`` data: rank r takes rows
    ``[r*S/P, (r+1)*S/P)``."""
    rows = x.shape[0] // comm.size
    xb = x.view(comm.size, rows, -1)[comm.rank]
    yb = y.view(comm.size, rows, -1)[comm.rank]
    return sharded_train_step(comm, block)(params, xb, yb)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--seq-per-rank", type=int, default=64)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-2)
    args = ap.parse_args()

    dev = mpi_tpu_torch.resolve_device(args.device)
    S = args.n * args.seq_per_rank
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(S, args.d).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(S, args.d).astype(np.float32)).to(dev)
    block = block_from_numpy(init_params(args.d, 2 * args.d), dev)
    params = {n: p.detach() for n, p in block.named_parameters()}
    for i in range(args.steps):
        loss, grads = mpi_tpu_torch.run(sharded_program, block, params, x, y,
                                        nranks=args.n, device=dev)
        params = {n: p - args.lr * grads[n][0] for n, p in params.items()}
        print(f"step {i}: loss={float(loss[0]):.6f} (S={S} over {args.n} "
              f"ranks, ring attention forward and backward on {dev})")


if __name__ == "__main__":
    main()
