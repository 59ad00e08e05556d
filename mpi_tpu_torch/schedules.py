"""Pure collective-schedule generators used by ``gpu/collectives.py`` and
by the host collective engine (``communicator.P2PCommunicator``).

Own copy of the parts of ``mpi_tpu/schedules.py`` that the hand-scheduled
SPMD algorithms and the segmented host engine call: ``is_pow2`` (:31),
the segment tables ``chunk_offsets`` (:46) and ``segment_spans`` (:64),
``binomial_tree_links`` (:76), the binomial rounds (:100-124),
``ring_perm`` (:132), the ring chunk formulas (:152-193), the
halving/doubling masks (:201-221), ``xor_perm`` (:224),
``alltoall_rounds`` (:234), ``dissemination_offsets`` (:246), the
per-rank step plans of the nonblocking collectives (span plans
``ring_allreduce_steps`` :288 through ``block_ring_reduce_scatter_steps``
:396, value plans ``bcast_value_steps`` :419 through
``barrier_value_steps`` :454), and the graph-topology rounds
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


# ---------------------------------------------------------------------------
# Compiled per-rank step plans (engine-owned nonblocking collectives,
# nbc.py).  A *step plan* is this rank's whole collective as pure
# data: a list of steps, each ``(sends, recvs)`` where
#
#   sends = ((peer, lo, hi), ...)        element spans of the flat work
#   recvs = ((peer, lo, hi, fold), ...)  buffer; fold=True accumulates
#                                        (op.combine_into), False copies
#
# advanced by the progress engine's completion callbacks (nbc.py — the
# MPICH/libNBC shape) instead of a per-call thread running the
# blocking loops.  The tables mirror the blocking algorithms above
# EXACTLY (same chunk functions, same step order, same skip-empty-span
# rule as segment_spans), so each plan's wire traffic is the per-step
# frame sequence the blocking path would emit unsegmented.  Spans with
# ``hi <= lo`` produce no message on either side — both ranks derive
# them from the same global chunk table, the zero-metadata invariant the
# segmented engine already leans on.
# ---------------------------------------------------------------------------

SpanSend = Tuple[int, int, int]
SpanRecv = Tuple[int, int, int, bool]
SpanStep = Tuple[Tuple[SpanSend, ...], Tuple[SpanRecv, ...]]


def _span_step(sends, recvs) -> SpanStep:
    """Drop empty spans (the segment_spans symmetry rule)."""
    return (tuple((d, lo, hi) for d, lo, hi in sends if hi > lo),
            tuple((s, lo, hi, f) for s, lo, hi, f in recvs if hi > lo))


def ring_allreduce_steps(size: int, rank: int,
                         offs: Sequence[int]) -> List[SpanStep]:
    """The 2(P-1)-step segmented ring allreduce as a per-rank plan
    (reduce-scatter ring then allgather ring — _allreduce_ring's exact
    step order)."""
    right, left = (rank + 1) % size, (rank - 1) % size
    steps: List[SpanStep] = []
    for step in range(size - 1):
        si = ring_rs_send_chunk(rank, step, size)
        ri = ring_rs_recv_chunk(rank, step, size)
        steps.append(_span_step(((right, offs[si], offs[si + 1]),),
                                ((left, offs[ri], offs[ri + 1], True),)))
    for step in range(size - 1):
        si = ring_ag_send_chunk(rank, step, size)
        ri = ring_ag_recv_chunk(rank, step, size)
        steps.append(_span_step(((right, offs[si], offs[si + 1]),),
                                ((left, offs[ri], offs[ri + 1], False),)))
    return steps


def halving_allreduce_steps(size: int, rank: int,
                            offs: Sequence[int]) -> List[SpanStep]:
    """Recursive-halving reduce-scatter + recursive-doubling allgather
    (pow2 only) — _allreduce_halving's exact partner/range walk."""
    masks = halving_masks(size)
    steps: List[SpanStep] = []
    lo, hi = 0, size
    for mask in masks:
        partner = rank ^ mask
        mid = (lo + hi) // 2
        if rank & mask:
            mine, theirs = (mid, hi), (lo, mid)
        else:
            mine, theirs = (lo, mid), (mid, hi)
        steps.append(_span_step(
            ((partner, offs[theirs[0]], offs[theirs[1]]),),
            ((partner, offs[mine[0]], offs[mine[1]], True),)))
        lo, hi = mine
    for mask in reversed(masks):
        partner = rank ^ mask
        w = hi - lo
        rb = (lo - w, lo) if rank & mask else (hi, hi + w)
        steps.append(_span_step(
            ((partner, offs[lo], offs[hi]),),
            ((partner, offs[rb[0]], offs[rb[1]], False),)))
        lo, hi = (rb[0], hi) if rank & mask else (lo, rb[1])
    return steps


def rabenseifner_allreduce_steps(size: int, rank: int,
                                 offs: Sequence[int]) -> List[SpanStep]:
    """Block-ring reduce_scatter + ring allgather composition [S: Thakur
    et al.] — _allreduce_rabenseifner's exact step order, any P."""
    right, left = (rank + 1) % size, (rank - 1) % size
    steps: List[SpanStep] = []
    for step in range(size - 1):
        si = ring_rs_block_send_chunk(rank, step, size)
        ri = ring_rs_block_recv_chunk(rank, step, size)
        steps.append(_span_step(((right, offs[si], offs[si + 1]),),
                                ((left, offs[ri], offs[ri + 1], True),)))
    for step in range(size - 1):
        si = ring_ag_block_send_chunk(rank, step, size)
        ri = ring_ag_block_recv_chunk(rank, step, size)
        steps.append(_span_step(((right, offs[si], offs[si + 1]),),
                                ((left, offs[ri], offs[ri + 1], False),)))
    return steps


def reduce_bcast_allreduce_steps(size: int, rank: int,
                                 n: int) -> List[SpanStep]:
    """The naive reference composition as a plan: binomial reduce to
    rank 0 (whole-buffer folds) then binomial bcast of the result."""
    steps: List[SpanStep] = []
    for pairs in binomial_reduce_rounds(size, 0):
        sends, recvs = [], []
        for s, d in pairs:
            if rank == s:
                sends.append((d, 0, n))
            elif rank == d:
                recvs.append((s, 0, n, True))
        steps.append(_span_step(sends, recvs))
    for pairs in binomial_bcast_rounds(size, 0):
        sends, recvs = [], []
        for s, d in pairs:
            if rank == s:
                sends.append((d, 0, n))
            elif rank == d:
                recvs.append((s, 0, n, False))
        steps.append(_span_step(sends, recvs))
    return [st for st in steps if st[0] or st[1]]


def reduce_tree_steps(size: int, rank: int, root: int,
                      n: int) -> List[SpanStep]:
    """Binomial-tree reduce to ``root``: whole-buffer folds, children →
    parents in round order (reduce's exact wire pattern)."""
    steps: List[SpanStep] = []
    for pairs in binomial_reduce_rounds(size, root):
        sends, recvs = [], []
        for s, d in pairs:
            if rank == s:
                sends.append((d, 0, n))
            elif rank == d:
                recvs.append((s, 0, n, True))
        steps.append(_span_step(sends, recvs))
    return [st for st in steps if st[0] or st[1]]


def block_ring_reduce_scatter_steps(size: int, rank: int,
                                    bn: int) -> List[SpanStep]:
    """MPI_Reduce_scatter_block's P-1-step block ring over a flat [P*bn]
    working buffer — reduce_scatter's segmented path, unsegmented."""
    right, left = (rank + 1) % size, (rank - 1) % size
    steps: List[SpanStep] = []
    for step in range(size - 1):
        si = ring_rs_block_send_chunk(rank, step, size)
        ri = ring_rs_block_recv_chunk(rank, step, size)
        steps.append(_span_step(((right, si * bn, (si + 1) * bn),),
                                ((left, ri * bn, (ri + 1) * bn, True),)))
    return steps


# Value plans: the same step shape over OPAQUE payload slots instead of
# buffer spans — for the collectives that move whole (possibly pickled)
# payloads rather than folding arrays.  sends = ((peer, slot), ...) and
# recvs = ((peer, slot), ...) where slot indexes the state machine's
# value table; slot -1 sends/receives a bare None (barrier signals).

ValueStep = Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[int, int], ...]]


def bcast_value_steps(size: int, rank: int, root: int) -> List[ValueStep]:
    """Binomial-tree bcast: one recv-from-parent step (non-root), then
    one send step per child in tree order — the cut-through walk of
    binomial_tree_links, whole payloads."""
    parent, children = binomial_tree_links(size, rank, root)
    steps: List[ValueStep] = []
    if parent is not None:
        steps.append(((), ((parent, 0),)))
    if children:
        steps.append((tuple((c, 0) for c in children), ()))
    return steps


def allgather_ring_value_steps(size: int, rank: int) -> List[ValueStep]:
    """The rotating allgather ring over P value slots (allgather's ring
    branch, whole payloads per step)."""
    right, left = (rank + 1) % size, (rank - 1) % size
    steps: List[ValueStep] = []
    for step in range(size - 1):
        si = ring_ag_send_chunk(rank, step + 1, size)
        ri = ring_ag_recv_chunk(rank, step + 1, size)
        steps.append((((right, si),), ((left, ri),)))
    return steps


def alltoall_value_steps(size: int, rank: int) -> List[ValueStep]:
    """Pairwise-exchange alltoall: P-1 independent rounds (slot k is the
    payload for / from the round-k partner)."""
    steps: List[ValueStep] = []
    for k in alltoall_rounds(size):
        steps.append(((((rank + k) % size, (rank + k) % size),),
                      (((rank - k) % size, (rank - k) % size),)))
    return steps


def barrier_value_steps(size: int, rank: int) -> List[ValueStep]:
    """Dissemination barrier: ceil(log2 P) signal rounds (slot -1 =
    None payloads, discarded on receive)."""
    steps: List[ValueStep] = []
    for off in dissemination_offsets(size):
        steps.append(((((rank + off) % size, -1),),
                      (((rank - off) % size, -1),)))
    return steps


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
