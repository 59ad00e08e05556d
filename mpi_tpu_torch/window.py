"""One-sided communication (MPI RMA): the backend-neutral pieces.

Own copy of ``mpi_tpu/window.py``: ``GetFuture`` (:55) and
``_normalize_pairs`` (:78).  The epoch semantics are the reference's
(module docstring there): operations apply at the closing ``fence()`` in
issue order, puts and accumulates before gets, and ``fence()`` is
collective.  The SPMD window is ``gpu/window.py``; the process backends'
``P2PWindow`` (passive target, PSCW, atomics) waits for the host layer.
"""

from __future__ import annotations

from typing import Any, List, Tuple

from .checker import validate_perm

Pair = Tuple[int, int]


class GetFuture:
    """Result of ``Window.get``: defined after the closing fence."""

    def __init__(self) -> None:
        self._resolved = False
        self._value: Any = None

    def _resolve(self, value: Any) -> None:
        self._value = value
        self._resolved = True

    @property
    def value(self) -> Any:
        if not self._resolved:
            raise RuntimeError(
                "GetFuture read before the closing fence: one-sided gets "
                "complete at Window.fence() [S: MPI-2 active-target RMA]")
        return self._value

    def wait(self) -> Any:
        return self.value


def _normalize_pairs(pairs, size: int) -> List[Pair]:
    """The pattern form: validate the partial permutation.  (The
    reference's int form, one target for this rank, serves its process
    backends only.)"""
    pairs = [(int(s), int(d)) for s, d in pairs]
    validate_perm(pairs, size)
    return pairs
