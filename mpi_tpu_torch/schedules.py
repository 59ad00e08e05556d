"""Pure collective-schedule generators used by ``gpu/collectives.py``.

Own copy of the parts of ``mpi_tpu/schedules.py`` that the hand-scheduled
SPMD algorithms call: ``is_pow2`` (:31), the binomial rounds (:100-124),
``ring_perm`` (:132), the ring chunk formulas (:152-193), the
halving/doubling masks (:201-221), ``xor_perm`` (:224),
``alltoall_rounds`` (:234), and the graph-topology rounds
``dedupe_edges`` (:464) and ``graph_rounds`` (:483).

A round is a list of ``(src, dst)`` comm-rank pairs; chunk helpers take the
rank as a Python int or as a (batched) integer tensor and use only
``+ - %`` on it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

Pair = Tuple[int, int]


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def binomial_bcast_rounds(size: int, root: int = 0) -> List[List[Pair]]:
    """Binomial-tree broadcast: ceil(log2 P) rounds of (src, dst) pairs;
    ``root`` is handled by virtual-rank rotation."""
    rounds: List[List[Pair]] = []
    k = 1
    while k < size:
        pairs = []
        for v in range(k):
            peer = v + k
            if peer < size:
                pairs.append(((v + root) % size, (peer + root) % size))
        rounds.append(pairs)
        k *= 2
    return rounds


def binomial_reduce_rounds(size: int, root: int = 0) -> List[List[Pair]]:
    """Binomial-tree reduction to ``root``: mirror of bcast, children → parents."""
    return [
        [(dst, src) for (src, dst) in pairs]
        for pairs in reversed(binomial_bcast_rounds(size, root))
    ]


def ring_perm(size: int, shift: int = 1, wrap: bool = True) -> List[Pair]:
    """The ring permutation: every rank sends to ``rank + shift``."""
    pairs = []
    for r in range(size):
        d = r + shift
        if wrap:
            pairs.append((r, d % size))
        elif 0 <= d < size:
            pairs.append((r, d))
    return pairs


# Ring-allreduce: at reduce-scatter step s rank r sends chunk (r - s) mod P
# to r+1 and folds chunk (r - s - 1) mod P from r-1; after P-1 steps rank r
# holds the reduced chunk (r + 1) mod P, which the allgather half rotates.


def ring_rs_send_chunk(rank, step: int, size: int):
    return (rank - step) % size


def ring_rs_recv_chunk(rank, step: int, size: int):
    return (rank - step - 1) % size


def ring_ag_send_chunk(rank, step: int, size: int):
    return (rank - step + 1) % size


def ring_ag_recv_chunk(rank, step: int, size: int):
    return (rank - step) % size


# Reduce-scatter-to-rank variant: shifted by one so rank r ends holding the
# reduced chunk r (MPI Reduce_scatter_block semantics).


def ring_rs_block_send_chunk(rank, step: int, size: int):
    return (rank - step - 1) % size


def ring_rs_block_recv_chunk(rank, step: int, size: int):
    return (rank - step - 2) % size


def halving_masks(size: int) -> List[int]:
    """Partner masks for recursive-halving reduce-scatter, high bit first
    (power-of-two sizes only)."""
    if not is_pow2(size):
        raise ValueError(f"recursive halving requires power-of-two size, got {size}")
    masks = []
    m = size >> 1
    while m:
        masks.append(m)
        m >>= 1
    return masks


def doubling_masks(size: int) -> List[int]:
    """Recursive-doubling masks, low bit first (reverse of halving)."""
    return list(reversed(halving_masks(size)))


def xor_perm(size: int, mask: int) -> List[Pair]:
    """The pairwise-exchange permutation rank ↔ rank^mask."""
    return [(r, r ^ mask) for r in range(size)]


def alltoall_rounds(size: int) -> List[int]:
    """Offsets for the pairwise-exchange alltoall: P-1 rounds."""
    return list(range(1, size))


def dedupe_edges(edges: Sequence[Pair], size: int) -> List[Pair]:
    """Validate a directed edge list and drop duplicates, keeping the
    FIRST occurrence's position (neighbor order is input order — the
    dist_graph contract).  Self-edges are rejected (keep local data
    local); shared by graph_rounds and topology.GraphComm."""
    seen = set()
    out: List[Pair] = []
    for s, d in edges:
        s, d = int(s), int(d)
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError(f"edge ({s}, {d}) out of range for size {size}")
        if s == d:
            raise ValueError(f"self-edge ({s}, {d}): keep local data local")
        if (s, d) not in seen:
            seen.add((s, d))
            out.append((s, d))
    return out


def graph_rounds(edges: Sequence[Pair], size: int) -> List[List[Pair]]:
    """Decompose an arbitrary directed edge set into partial-permutation
    rounds (greedy edge coloring): within a round no rank sends twice and
    no rank receives twice — exactly ``lax.ppermute``'s precondition, so a
    graph-neighborhood collective lowers to one ppermute per round.  Round
    count ≤ 2·max(in_degree, out_degree) − 1 (bipartite greedy bound)."""
    remaining = dedupe_edges(edges, size)
    rounds: List[List[Pair]] = []
    while remaining:
        used_s, used_d = set(), set()
        this_round, rest = [], []
        for e in remaining:
            s, d = e
            if s in used_s or d in used_d:
                rest.append(e)
            else:
                used_s.add(s)
                used_d.add(d)
                this_round.append(e)
        rounds.append(this_round)
        remaining = rest
    return rounds
