"""Pure collective-schedule generators used by ``gpu/collectives.py`` and
by the host collective engine (``communicator.P2PCommunicator``).

Own copy of the parts of ``mpi_tpu/schedules.py`` that the hand-scheduled
SPMD algorithms and the segmented host engine call: ``is_pow2`` (:31),
the segment tables ``chunk_offsets`` (:46) and ``segment_spans`` (:64),
``binomial_tree_links`` (:76), the binomial rounds (:100-124),
``ring_perm`` (:132), the ring chunk formulas (:152-193), the
halving/doubling masks (:201-221), ``xor_perm`` (:224),
``alltoall_rounds`` (:234), ``dissemination_offsets`` (:246), and the
graph-topology rounds
``dedupe_edges`` (:464) and ``graph_rounds`` (:483).

A round is a list of ``(src, dst)`` comm-rank pairs; chunk helpers take the
rank as a Python int or as a (batched) integer tensor and use only
``+ - %`` on it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Pair = Tuple[int, int]
Span = Tuple[int, int]


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


# The host engine slices ONE contiguous working buffer with these pure
# tables, so both sides of every exchange agree on message boundaries
# without any metadata traffic.


def chunk_offsets(n: int, parts: int) -> List[int]:
    """``parts + 1`` monotone element offsets splitting ``n`` elements into
    ``parts`` chunks, np.array_split-compatible (the first ``n % parts``
    chunks get one extra element; trailing chunks may be empty).  Chunks
    ``[a, b)`` together are the contiguous range ``[offs[a], offs[b])``."""
    if parts < 1:
        raise ValueError(f"need at least one chunk, got {parts}")
    base, extra = divmod(n, parts)
    offs = [0]
    for i in range(parts):
        offs.append(offs[-1] + base + (1 if i < extra else 0))
    return offs


def segment_spans(lo: int, hi: int, max_elems: int) -> List[Span]:
    """Split element range ``[lo, hi)`` into pipeline segments of at most
    ``max_elems`` elements; an empty range produces no spans (and so no
    messages) on either side of an exchange."""
    if max_elems < 1:
        raise ValueError(f"segments need >= 1 element, got {max_elems}")
    if hi <= lo:
        return []
    return [(s, min(s + max_elems, hi)) for s in range(lo, hi, max_elems)]


def binomial_tree_links(size: int, rank: int,
                        root: int = 0) -> Tuple[Optional[int], List[int]]:
    """``(parent, children-in-send-order)`` of ``rank`` in the binomial
    broadcast tree; ``parent`` is None exactly at ``root``.  The segmented
    bcast forwards each segment to the children the moment it lands."""
    parent: Optional[int] = None
    children: List[int] = []
    for pairs in binomial_bcast_rounds(size, root):
        for s, d in pairs:
            if d == rank:
                parent = s
            elif s == rank:
                children.append(d)
    return parent, children


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


# Allgather ring for block-distributed chunks (rank r starts holding chunk
# r): composed with the block reduce-scatter above it is the Rabenseifner
# allreduce.


def ring_ag_block_send_chunk(rank, step: int, size: int):
    return (rank - step) % size


def ring_ag_block_recv_chunk(rank, step: int, size: int):
    return (rank - step - 1) % size


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


def dissemination_offsets(size: int) -> List[int]:
    """Offsets 1, 2, 4, ... < P of the dissemination barrier: at each round
    rank r signals (r+off)%P and waits on (r-off)%P."""
    offs = []
    k = 1
    while k < size:
        offs.append(k)
        k *= 2
    return offs


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
