"""Expert parallelism: a mixture-of-experts layer over MPI_Alltoall —
counterpart of ``examples/moe.py``.

Each rank hosts ONE expert MLP; tokens are routed top-1, dispatched to
their expert's rank with one all-to-all, transformed, and combined back
with a second all-to-all — the communication shape of Switch-Transformer
MoE, with static capacity-based routing so the whole layer stays one
fixed-shape SPMD program (no dynamic shapes, drops handled by masking).

    python -m mpi_tpu_torch.examples.moe -n 8                    # CUDA
    python -m mpi_tpu_torch.examples.moe -n 8 --device cpu
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

import mpi_tpu_torch


def moe_layer(comm, x, w_router, w_in, w_out, capacity):
    """One MoE layer, expert-parallel over ``comm``.

    x: [T, D] local tokens.  w_router: [D, P] (replicated).  w_in/w_out:
    THIS rank's expert weights ([D, F], [F, D]).  Tokens beyond
    ``capacity`` per (source rank, expert) pair are dropped (output 0 —
    combine with a residual in real models).  Returns [T, D].
    """
    P = comm.size
    T, D = x.shape
    logits = x @ w_router                                     # [T, P]
    choice = torch.argmax(logits, dim=-1)                     # [T], first max
    gate = torch.softmax(logits, dim=-1).gather(-1, choice[:, None])[:, 0]

    # position of each token within its expert's dispatch block
    experts = torch.arange(P, device=x.device)
    onehot = (choice[:, None] == experts[None, :]).to(torch.int64)  # [T, P]
    pos = torch.cumsum(onehot, dim=0) - 1                     # [T, P]
    slot = pos.gather(1, choice[:, None])[:, 0]               # [T]
    kept = slot < capacity

    # scatter tokens into [P, C, D] blocks: out-of-capacity tokens land in
    # an extra slot C that is cut off (the reference's mode="drop")
    blocks = x.new_zeros((P, capacity + 1, D)).index_put(
        (choice, torch.where(kept, slot, capacity)), x)[:, :capacity]
    recv = comm.alltoall(blocks)                              # [P, C, D]

    # this rank's expert transforms every token it received (jax.nn.gelu's
    # default is the tanh approximation)
    h = F.gelu(recv @ w_in, approximate="tanh")               # [P, C, F]
    y = h @ w_out                                             # [P, C, D]

    back = comm.alltoall(y)                                   # [P, C, D]
    # gather each local token's transformed value from (its expert, slot)
    out = back[choice, torch.where(kept, slot, 0)]            # [T, D]
    return torch.where(kept[:, None], out * gate[:, None], 0.0)


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + np.tanh(math.sqrt(2.0 / math.pi)
                                    * (x + 0.044715 * x ** 3)))


def moe_oracle(x_all, w_router, w_in_all, w_out_all, capacity):
    """Single-process reference in numpy (float64): same routing and
    capacity rules, no communication.  x_all: [P, T, D];
    w_in_all/w_out_all: stacked expert weights."""
    x_all = np.asarray(x_all, np.float64)
    w_router = np.asarray(w_router, np.float64)
    P, T, D = x_all.shape
    out = np.zeros_like(x_all)
    for src in range(P):
        x = x_all[src]
        logits = x @ w_router
        choice = logits.argmax(-1)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        gate = (e / e.sum(-1, keepdims=True))[np.arange(T), choice]
        counts = np.zeros(P, int)
        for t in range(T):
            ex = choice[t]
            if counts[ex] < capacity:
                h = _gelu_tanh(x[t] @ np.asarray(w_in_all[ex], np.float64))
                out[src, t] = (h @ np.asarray(w_out_all[ex], np.float64)) * gate[t]
            counts[ex] += 1
    return out


def moe_inputs(comm, tokens_per_rank: int = 16, d: int = 8, f: int = 16):
    """This rank's (x, w_router, w_in, w_out): tokens and expert weights
    from the rank's own generator (``rank_normal``; the reference draws
    with ``jax.random``, so the values differ from it), the replicated
    router from a numpy generator, the same on every rank."""
    P = comm.size
    x = mpi_tpu_torch.rank_normal((tokens_per_rank, d), 5)
    w_router = torch.as_tensor(
        np.random.RandomState(1000).randn(d, P).astype(np.float32),
        device=comm.device)
    w_in = mpi_tpu_torch.rank_normal((d, f), 2000) * 0.3
    w_out = mpi_tpu_torch.rank_normal((f, d), 3000) * 0.3
    return x, w_router, w_in, w_out


def moe_program(comm, tokens_per_rank: int = 16, d: int = 8, f: int = 16,
                capacity: int = 8):
    return moe_layer(comm, *moe_inputs(comm, tokens_per_rank, d, f), capacity)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--nranks", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--tokens-per-rank", type=int, default=16)
    args = ap.parse_args()
    out = mpi_tpu_torch.run(moe_program, nranks=args.nranks, device=args.device,
                            tokens_per_rank=args.tokens_per_rank)
    print(f"moe OK: local {tuple(out[0].shape)}, "
          f"|out| = {float(out[0].abs().mean()):.4f}")


if __name__ == "__main__":
    main()
