"""Ulysses-style (DeepSpeed-Ulysses) sequence parallelism via all-to-all —
counterpart of ``examples/ulysses_attention.py``.

Ranks start sequence-sharded with all heads; one all-to-all re-shards to
head-sharded with the full sequence; attention runs locally per head
(exact, no online softmax needed); a second all-to-all restores sequence
sharding.  Two all-to-alls per attention call instead of P-1 ring hops.
The local attention is plain torch products, as the reference's is
``jnp.einsum`` outside any kernel.

    python -m mpi_tpu_torch.examples.ulysses_attention -n 8      # CUDA
    python -m mpi_tpu_torch.examples.ulysses_attention -n 8 --device cpu
"""

from __future__ import annotations

import argparse
import math

import torch

import mpi_tpu_torch


def _seq_to_heads(comm, x):
    """[s_local, H, d] → [S, H/P, d] via one all-to-all."""
    s, H, d = x.shape
    P = comm.size
    blocks = x.reshape(s, P, H // P, d).permute(1, 0, 2, 3)  # [P, s, H/P, d]
    gathered = comm.alltoall(blocks)                         # [P, s, H/P, d]
    return gathered.reshape(P * s, H // P, d)


def _heads_to_seq(comm, x, s_local):
    """[S, H/P, d] → [s_local, H, d] via the inverse all-to-all."""
    S, Hp, d = x.shape
    P = comm.size
    blocks = x.reshape(P, s_local, Hp, d)                    # [P, s, H/P, d]
    scattered = comm.alltoall(blocks)                        # [P, s, H/P, d]
    return scattered.permute(1, 0, 2, 3).reshape(s_local, P * Hp, d)


def ulysses_attention(comm, q, k, v):
    """Exact multi-head attention, sequence-sharded in and out.

    q, k, v: [s_local, H, d] with H divisible by comm.size."""
    s_local, H, d = q.shape
    if H % comm.size:
        raise ValueError(f"heads ({H}) must be divisible by ranks ({comm.size})")
    qh, kh, vh = (_seq_to_heads(comm, t) for t in (q, k, v))  # [S, H/P, d]
    scores = torch.einsum("shd,thd->hst", qh, kh) / math.sqrt(d)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hst,thd->shd", probs, vh)             # [S, H/P, d]
    return _heads_to_seq(comm, out, s_local)


def ulysses_program(comm, seq_per_rank: int = 32, heads: int = 8, d: int = 16):
    """Q/K/V from the rank's own generator (``rank_normal``; the reference
    draws with ``jax.random``, so the values differ from it); returns
    (out, q, k, v) as the reference does."""
    shape = (seq_per_rank, heads, d)
    q, k, v = (mpi_tpu_torch.rank_normal(shape, seed) for seed in (11, 12, 13))
    return ulysses_attention(comm, q, k, v), q, k, v


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--nranks", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--seq-per-rank", type=int, default=32)
    ap.add_argument("--heads", type=int, default=8)
    args = ap.parse_args()
    out, _, _, _ = mpi_tpu_torch.run(ulysses_program, nranks=args.nranks,
                                     device=args.device,
                                     seq_per_rank=args.seq_per_rank,
                                     heads=args.heads)
    print(f"ulysses attention OK: local {tuple(out[0].shape)}, "
          f"|out| = {float(out[0].abs().mean()):.4f}")


if __name__ == "__main__":
    main()
