"""Process groups — MPI_Group and the group→communicator constructors; the
port's own copy of ``mpi_tpu/group.py``.

A :class:`Group` is an ordered, duplicate-free list of ranks *of a parent
communicator*.  Group operations are host-side bookkeeping; only
``Communicator.create`` (MPI_Comm_create_group) communicates.

MPI spelling map:
    comm.group()                → MPI_Comm_group
    g.incl / g.excl             → MPI_Group_incl / MPI_Group_excl
    g.union / g.intersection / g.difference
                                → MPI_Group_union / _intersection / _difference
    g.rank_of(comm_rank)        → MPI_Group_rank (via translate)
    g.translate(positions, g2)  → MPI_Group_translate_ranks
    comm.create(g)              → MPI_Comm_create_group
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class Group:
    """Ordered set of parent-communicator ranks (MPI_Group analogue)."""

    __slots__ = ("ranks",)

    def __init__(self, ranks: Sequence[int]):
        ranks = tuple(int(r) for r in ranks)
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"group ranks must be distinct, got {list(ranks)}")
        if any(r < 0 for r in ranks):
            raise ValueError(f"group ranks must be >= 0, got {list(ranks)}")
        self.ranks: Tuple[int, ...] = ranks

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __eq__(self, other) -> bool:
        return isinstance(other, Group) and self.ranks == other.ranks

    def __hash__(self) -> int:
        return hash(self.ranks)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Group({list(self.ranks)})"

    # -- MPI_Group_* constructors -----------------------------------------

    def incl(self, positions: Sequence[int]) -> "Group":
        """MPI_Group_incl: the listed *positions of this group*, in the
        listed order (also the reorder primitive)."""
        return Group([self.ranks[self._check_pos(p)] for p in positions])

    def excl(self, positions: Sequence[int]) -> "Group":
        """MPI_Group_excl: drop the listed positions, keep the rest in order."""
        drop = {self._check_pos(p) for p in positions}
        return Group([r for i, r in enumerate(self.ranks) if i not in drop])

    def union(self, other: "Group") -> "Group":
        """MPI_Group_union: self's ranks, then other's not already present."""
        seen = set(self.ranks)
        return Group(list(self.ranks) + [r for r in other.ranks if r not in seen])

    def intersection(self, other: "Group") -> "Group":
        """MPI_Group_intersection: self's ranks also in other, self's order."""
        keep = set(other.ranks)
        return Group([r for r in self.ranks if r in keep])

    def difference(self, other: "Group") -> "Group":
        """MPI_Group_difference: self's ranks not in other, self's order."""
        drop = set(other.ranks)
        return Group([r for r in self.ranks if r not in drop])

    # -- queries -----------------------------------------------------------

    def rank_of(self, comm_rank: int) -> Optional[int]:
        """Position of a parent-comm rank in this group (MPI_Group_rank for
        the calling process when passed ``comm.rank``); None = MPI_UNDEFINED."""
        if not isinstance(comm_rank, (int, np.integer)):
            raise TypeError(
                "Group.rank_of needs a concrete integer rank; inside an SPMD "
                "program the rank is a batched tensor — group membership is "
                "per-rank control flow, which has no SPMD analogue (use "
                "host-side bookkeeping or comm.create(group) instead)")
        try:
            return self.ranks.index(int(comm_rank))
        except ValueError:
            return None

    def translate(self, positions: Sequence[int],
                  other: "Group") -> List[Optional[int]]:
        """MPI_Group_translate_ranks: map positions in this group to positions
        in ``other`` (None where absent)."""
        return [other.rank_of(self.ranks[self._check_pos(p)]) for p in positions]

    def _check_pos(self, p: int) -> int:
        p = int(p)
        if not (0 <= p < self.size):
            raise ValueError(f"position {p} out of range for group size {self.size}")
        return p
