"""The abstract communicator surface the SPMD communicator inherits.

Own copy of the host-free part of ``mpi_tpu/communicator.py``:
``Request``/``_CompletedRequest`` (:495-527) and the ``Communicator`` base
(:887-1245) reduced to what ``gpu/communicator.py`` inherits — ``exscan``,
``maxloc``/``minloc``, the counts checks of the ``*v`` collectives and the
group check of ``create``.  Transports, progress engines, attribute caching
and fault tolerance are host-layer features with no counterpart here yet
(ROADMAP "Port queue").
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Sequence, Tuple

from . import ops as _ops


class Request:
    """Handle for a nonblocking operation (MPI_Request)."""

    def wait(self) -> Any:
        raise NotImplementedError

    def test(self) -> Tuple[bool, Any]:
        raise NotImplementedError


class _CompletedRequest(Request):
    """A request whose value already exists (SPMD nonblocking collectives
    are launched eagerly on the device stream)."""

    def __init__(self, value: Any = None):
        self._value = value

    def wait(self) -> Any:
        return self._value

    def test(self) -> Tuple[bool, Any]:
        return True, self._value


class Communicator(ABC):
    """Abstract communicator: the API user MPI programs are written against."""

    @property
    @abstractmethod
    def rank(self):
        """This rank in this communicator (0..size-1)."""

    @property
    @abstractmethod
    def size(self) -> int:
        """Number of ranks in this communicator."""

    @abstractmethod
    def shift(self, obj: Any, offset: int = 1, wrap: bool = True, fill: Any = None) -> Any:
        """Every rank sends ``obj`` to ``rank+offset`` and returns the
        payload from ``rank-offset``; with ``wrap=False`` the boundary hole
        is ``fill``."""

    @abstractmethod
    def allreduce(self, obj: Any, op: _ops.ReduceOp = _ops.SUM,
                  algorithm: str = "auto") -> Any: ...

    @abstractmethod
    def scan(self, obj: Any, op: _ops.ReduceOp = _ops.SUM) -> Any: ...

    def localize(self, obj: Any) -> Any:
        """Mark ``obj`` as rank-local state: the identity here, as on the
        reference's process backends (``mpi_tpu/communicator.py:1034``);
        the SPMD communicator overrides it with the reference's ``pvary``
        (``TorchCommunicator.localize``)."""
        return obj

    def exscan(self, obj: Any, op: _ops.ReduceOp = _ops.SUM) -> Any:
        """MPI_Exscan: rank r gets the reduction of ranks 0..r-1; rank 0
        gets the op identity, so ``scan == combine(exscan, local)``."""
        scanned = self.scan(obj, op)
        return self.shift(scanned, offset=1, wrap=False,
                          fill=op.identity(scanned.dtype))

    def maxloc(self, obj: Any):
        """MPI_MAXLOC: elementwise (max value, lowest rank attaining it)."""
        return self._allreduce_loc(obj, _ops.MAX)

    def minloc(self, obj: Any):
        """MPI_MINLOC: elementwise (min value, lowest rank attaining it)."""
        return self._allreduce_loc(obj, _ops.MIN)

    @abstractmethod
    def _allreduce_loc(self, obj: Any, op: _ops.ReduceOp): ...

    def _check_counts(self, counts: Sequence[int]) -> None:
        if len(counts) != self.size:
            raise ValueError(
                f"need one count per rank ({self.size}), got {len(counts)}")
        if any(int(c) < 0 for c in counts):
            raise ValueError(f"counts must be >= 0, got {list(counts)}")

    def _check_counts_matrix(self, counts: Sequence[Sequence[int]]) -> None:
        if len(counts) != self.size or any(len(row) != self.size for row in counts):
            raise ValueError(
                f"alltoallv counts must be a {self.size}x{self.size} matrix")
        if any(int(c) < 0 for row in counts for c in row):
            raise ValueError(
                f"alltoallv counts must be >= 0, got {[list(r) for r in counts]}")

    def _check_group(self, group) -> None:
        """Shared validation for create(): non-empty, ranks in range."""
        ranks = list(group.ranks)
        if not ranks:
            raise ValueError(
                "create(group) needs a non-empty group (MPI_GROUP_EMPTY has "
                "no communicator)")
        bad = [r for r in ranks if not (0 <= r < self.size)]
        if bad:
            raise ValueError(
                f"group ranks {bad} out of range for a size-{self.size} communicator")
