"""Ring attention: exact long-context attention over sequence-sharded ranks —
counterpart of ``examples/ring_attention.py``.

Each rank holds one sequence block of Q/K/V.  The ``comm.shift`` spelling
rotates the K/V blocks around the ring (one ppermute per hop) and folds
each into the online-softmax recurrence; ``kernel=True`` calls the fused
ring attention of ``mpi_tpu_torch.gpu.attention``, whose forward is the
hand-written CUDA kernel on the card.

    python -m mpi_tpu_torch.examples.ring_attention -n 8 --seq-per-rank 4096 \\
        --dim 128 --kernel --causal
    python -m mpi_tpu_torch.examples.ring_attention -n 4 --device cpu
"""

from __future__ import annotations

import argparse
import math

import torch

import mpi_tpu_torch
from mpi_tpu_torch.gpu.attention import ring_attention as fused_ring_attention
from mpi_tpu_torch.gpu.primitives import rank_normal


def ring_attention(comm, q, k, v, causal: bool = False):
    """Exact attention (full, or causal by global position) over the
    sequence sharded on the ring; q, k, v are this rank's ``[block, d]``
    blocks.  2(P-1) shifts in all (K and V)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    m = torch.full(q.shape[:1], -math.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros(q.shape[:1], dtype=q.dtype, device=q.device)
    acc = torch.zeros_like(q)
    k_cur, v_cur = k, v
    b = q.shape[0]
    rows = torch.arange(b, device=q.device)
    for step in range(comm.size):
        scores = (q @ k_cur.T) * scale
        if causal:
            kv_idx = (comm.rank - step) % comm.size
            qi = comm.rank * b + rows[:, None]
            kj = kv_idx * b + rows[None, :]
            scores = torch.where(kj <= qi, scores, torch.full_like(scores, -1e30))
        new_m = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[:, None])
        acc = acc * corr[:, None] + p @ v_cur
        l = l * corr + p.sum(dim=-1)
        m = new_m
        if step < comm.size - 1:
            k_cur = comm.shift(k_cur, offset=1, wrap=True)
            v_cur = comm.shift(v_cur, offset=1, wrap=True)
    return acc / l[:, None]


def ring_attention_program(comm, seq_per_rank: int = 64, d: int = 32,
                           kernel: bool = False, causal: bool = False):
    """Draw this rank's Q/K/V from its own generator and attend; returns
    ``(out, q, k, v)``.  ``kernel=True`` takes the fused ring attention
    (d a multiple of 128, block rows a multiple of 8)."""
    q, k, v = (rank_normal((seq_per_rank, d), seed) for seed in (7, 8, 9))
    if kernel:
        out = fused_ring_attention(q, k, v, comm, causal=causal)
    else:
        out = ring_attention(comm, q, k, v, causal=causal)
    return out, q, k, v


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--nranks", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--seq-per-rank", type=int, default=64)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--kernel", action="store_true",
                    help="use the fused ring attention (--dim multiple of 128)")
    ap.add_argument("--causal", action="store_true")
    args = ap.parse_args()
    out, _, _, _ = mpi_tpu_torch.run(
        ring_attention_program, nranks=args.nranks, device=args.device,
        seq_per_rank=args.seq_per_rank, d=args.dim, kernel=args.kernel,
        causal=args.causal)
    print(f"ring attention OK: local block {tuple(out.shape[1:])}, "
          f"|out| = {float(out.abs().mean()):.4f}")


if __name__ == "__main__":
    main()
