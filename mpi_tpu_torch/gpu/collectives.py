"""Hand-scheduled collective algorithms over ``ppermute`` steps.

Counterpart of ``mpi_tpu/tpu/collectives.py``.  Each function is written
per rank and runs inside ``run_spmd`` (under its ``torch.vmap``): a
``lax.ppermute`` becomes ``primitives.ppermute``, a permutation of the rank
dimension; ``lax.dynamic_index_in_dim`` / ``dynamic_update_index_in_dim``
with a traced chunk index become indexing and ``index_copy`` with a
batched index; ``lax.fori_loop`` becomes a Python loop.  The schedules and
fold orders are the reference's, step for step, so results match it
bitwise.

Every function takes group-level geometry:

* ``size`` — ranks per group,
* ``grank`` — this rank's group-local rank (batched integer tensor),
* ``world_pairs(group_pairs)`` — expands group-level (src, dst) pairs to
  world-level pairs across all sibling groups (validated by the checker).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Sequence, Tuple

import torch

from .. import ops as _ops
from .. import schedules
from . import primitives

Pair = Tuple[int, int]
WorldPairs = Callable[[Sequence[Pair]], List[Pair]]


def _pad_flat(x: torch.Tensor, size: int) -> Tuple[torch.Tensor, int]:
    """Flatten and zero-pad to a multiple of ``size`` (equal chunks)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    padded = -(-n // size) * size if n else size
    if padded != n:
        flat = torch.cat([flat, flat.new_zeros(padded - n)])
    return flat, n


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` along dim 0 for a batched index (dynamic_index_in_dim)."""
    return x[i]


def _put(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x`` with row ``i`` replaced by ``v`` (dynamic_update_index_in_dim)."""
    return x.index_copy(0, i.reshape(1), v.unsqueeze(0))


def _mask_of(ranks: Sequence[int], axis_size: int) -> torch.Tensor:
    """Batched bool: is this rank's world index in ``ranks``?"""
    table = [False] * axis_size
    for r in ranks:
        table[r] = True
    return primitives.lookup(table, dtype=torch.bool)


def tree_reduce_local(op: _ops.ReduceOp, stacked: torch.Tensor) -> torch.Tensor:
    """Reduce a stacked [P, ...] tensor along dim 0 with op.combine."""
    parts = [stacked[i] for i in range(stacked.shape[0])]
    return functools.reduce(op.combine, parts)


def ring_allreduce(x: torch.Tensor, size: int, grank, world_pairs: WorldPairs,
                   op: _ops.ReduceOp = _ops.SUM) -> torch.Tensor:
    """Reduce-scatter ring + allgather ring: 2(P-1) ppermute steps, each
    moving 1/P of the buffer."""
    if size == 1:
        return x
    shape = x.shape
    flat, n = _pad_flat(x, size)
    chunks = flat.reshape(size, -1)
    perm = world_pairs(schedules.ring_perm(size, 1))
    for s in range(size - 1):
        si = schedules.ring_rs_send_chunk(grank, s, size)
        ri = schedules.ring_rs_recv_chunk(grank, s, size)
        recvd = primitives.ppermute(_take(chunks, si), perm)
        chunks = _put(chunks, ri, op.combine(_take(chunks, ri), recvd))
    for s in range(size - 1):
        si = schedules.ring_ag_send_chunk(grank, s, size)
        ri = schedules.ring_ag_recv_chunk(grank, s, size)
        recvd = primitives.ppermute(_take(chunks, si), perm)
        chunks = _put(chunks, ri, recvd)
    return chunks.reshape(-1)[:n].reshape(shape)


def halving_allreduce(x: torch.Tensor, size: int, grank,
                      world_pairs: WorldPairs,
                      op: _ops.ReduceOp = _ops.SUM) -> torch.Tensor:
    """Recursive-halving reduce-scatter + recursive-doubling allgather:
    2·log2(P) steps; power-of-two groups only."""
    if size == 1:
        return x
    masks = schedules.halving_masks(size)  # raises for non-pow2
    shape = x.shape
    buf, n = _pad_flat(x, size)
    for mask in masks:
        perm = world_pairs(schedules.xor_perm(size, mask))
        half = buf.shape[0] // 2
        lower, upper = buf[:half], buf[half:]
        bit = (grank & mask) != 0
        send = torch.where(bit, lower, upper)
        keep = torch.where(bit, upper, lower)
        recvd = primitives.ppermute(send, perm)
        buf = op.combine(keep, recvd)
    for mask in schedules.doubling_masks(size):
        perm = world_pairs(schedules.xor_perm(size, mask))
        recvd = primitives.ppermute(buf, perm)
        bit = (grank & mask) != 0
        buf = torch.where(bit, torch.cat([recvd, buf]), torch.cat([buf, recvd]))
    return buf[:n].reshape(shape)


def tree_bcast(x: torch.Tensor, size: int, grank, world_pairs: WorldPairs,
               axis_size: int, root: int = 0) -> torch.Tensor:
    """Binomial-tree broadcast as log2(P) masked ppermute rounds; ranks not
    yet reached hold 0, so ``buf + recvd`` is exact."""
    if size == 1:
        return x
    if x.dtype == torch.bool:
        return tree_bcast(x.to(torch.uint8), size, grank, world_pairs,
                          axis_size, root).to(torch.bool)
    buf = torch.where(grank == root, x, torch.zeros_like(x))
    for pairs in schedules.binomial_bcast_rounds(size, root):
        wp = world_pairs(pairs)
        recvd = primitives.ppermute(buf, wp)
        is_dst = _mask_of([d for _, d in wp], axis_size)
        buf = buf + torch.where(is_dst, recvd, torch.zeros_like(recvd))
    return buf


def tree_reduce(x: torch.Tensor, size: int, grank, world_pairs: WorldPairs,
                axis_size: int, op: _ops.ReduceOp = _ops.SUM,
                root: int = 0) -> torch.Tensor:
    """Binomial-tree reduction to ``root``; non-root ranks end holding the
    op identity."""
    if size == 1:
        return x
    ident = torch.full(x.shape, op.identity(x.dtype), dtype=x.dtype,
                       device=x.device)
    buf = x
    for pairs in schedules.binomial_reduce_rounds(size, root):
        wp = world_pairs(pairs)
        recvd = primitives.ppermute(buf, wp)
        is_dst = _mask_of([d for _, d in wp], axis_size)
        buf = op.combine(buf, torch.where(is_dst, recvd, ident))
    return torch.where(grank == root, buf, ident)


def ring_allgather(x: torch.Tensor, size: int, grank,
                   world_pairs: WorldPairs) -> torch.Tensor:
    """P-1 ring steps; returns stacked [P, ...] in rank order."""
    out = _put(x.new_zeros((size,) + tuple(x.shape)), grank, x)
    if size == 1:
        return out
    perm = world_pairs(schedules.ring_perm(size, 1))
    for s in range(size - 1):
        si = (grank - s) % size
        ri = (grank - s - 1) % size
        recvd = primitives.ppermute(_take(out, si), perm)
        out = _put(out, ri, recvd)
    return out


def doubling_allgather(x: torch.Tensor, size: int, grank,
                       world_pairs: WorldPairs) -> torch.Tensor:
    """Recursive doubling: log2(P) steps; stacked [P, ...] in rank order
    (power-of-two groups only)."""
    buf = x[None]
    if size == 1:
        return buf
    for mask in schedules.doubling_masks(size):
        perm = world_pairs(schedules.xor_perm(size, mask))
        recvd = primitives.ppermute(buf, perm)
        bit = (grank & mask) != 0
        buf = torch.where(bit, torch.cat([recvd, buf]), torch.cat([buf, recvd]))
    return buf


def ring_reduce_scatter(x: torch.Tensor, size: int, grank,
                        world_pairs: WorldPairs,
                        op: _ops.ReduceOp = _ops.SUM) -> torch.Tensor:
    """Reduce-scatter ring on stacked [P, ...] blocks: P-1 steps; rank r
    ends holding the fully reduced block r."""
    if x.shape[0] != size:
        raise ValueError(f"need leading dim == {size}, got {tuple(x.shape)}")
    chunks = x
    perm = world_pairs(schedules.ring_perm(size, 1))
    for s in range(size - 1):
        si = schedules.ring_rs_block_send_chunk(grank, s, size)
        ri = schedules.ring_rs_block_recv_chunk(grank, s, size)
        recvd = primitives.ppermute(_take(chunks, si), perm)
        chunks = _put(chunks, ri, op.combine(_take(chunks, ri), recvd))
    return _take(chunks, grank)


def pairwise_alltoall(x: torch.Tensor, size: int, grank,
                      world_pairs: WorldPairs) -> torch.Tensor:
    """P-1 rounds; round k sends block (grank+k)%P to the rank at distance
    k and fills slot (grank-k)%P.  Input/output: stacked [P, ...]."""
    if x.shape[0] != size:
        raise ValueError(
            f"alltoall payload must have leading dim == group size {size}, "
            f"got {tuple(x.shape)}")
    out = _put(torch.zeros_like(x), grank, _take(x, grank))
    for k in schedules.alltoall_rounds(size):
        perm = world_pairs(schedules.ring_perm(size, k))
        recvd = primitives.ppermute(_take(x, (grank + k) % size), perm)
        out = _put(out, (grank - k) % size, recvd)
    return out
