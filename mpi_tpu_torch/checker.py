"""Call-time check of communication schedules.

Own copy of ``mpi_tpu/checker.py:23-47`` (``ScheduleError``,
``validate_perm``): every rank permutation the SPMD communicator emits must
be a partial permutation, checked when the collective is called.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Tuple

Pair = Tuple[int, int]


class ScheduleError(ValueError):
    """A communication schedule is structurally invalid."""


def validate_perm(pairs: Iterable[Pair], size: int) -> None:
    """Raise ScheduleError unless ``pairs`` is a partial permutation over
    ``size`` ranks (no duplicate source, no duplicate destination, every
    endpoint in range)."""
    pairs = list(pairs)
    srcs = Counter(s for s, _ in pairs)
    dsts = Counter(d for _, d in pairs)
    for s, d in pairs:
        if not (0 <= s < size and 0 <= d < size):
            raise ScheduleError(f"pair ({s}, {d}) out of range for size {size}")
    dup_s = [r for r, c in srcs.items() if c > 1]
    dup_d = [r for r, c in dsts.items() if c > 1]
    if dup_s or dup_d:
        raise ScheduleError(
            f"not a partial permutation: duplicate sources {dup_s}, "
            f"duplicate destinations {dup_d}"
        )
