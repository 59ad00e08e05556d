"""One-sided RMA on the SPMD backend: windows as functional state.

Counterpart of ``mpi_tpu/tpu/window.py`` (``TpuWindow`` :43-178).  The
window is a per-rank tensor inside the SPMD program; RMA calls queue
static-pattern transfers, and ``fence()`` lowers the epoch to one
``primitives.ppermute`` per call plus a masked update on the destination
ranks.  Semantics are the reference's exactly (issue order; writes before
gets; fence closes the epoch), so results equal it bitwise.  An int
target is diagnosed with ``SpmdSemanticsError``: every rank runs one
program, so the pattern must be static.

A write at a static ``loc`` (``arr.at[loc].set`` in the reference) is an
out-of-place ``index_put`` on the flat window: the window may be a tensor
made inside the rank vmap, which a batched value cannot be written into in
place.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from .. import ops as _ops
from ..window import GetFuture, _normalize_pairs
from . import collectives as algos
from . import primitives

Pair = Tuple[int, int]


def _static_pairs(pairs, size: int) -> List[Pair]:
    if isinstance(pairs, (int, np.integer)) or \
            (isinstance(pairs, torch.Tensor) and pairs.dim() == 0):
        from .communicator import _unsupported

        raise _unsupported(
            "rank-dynamic RMA (an int target rank)",
            "Pass the static pattern form pairs=[(src, dst), ...] — the same "
            "list on every rank, like Communicator.exchange.")
    return _normalize_pairs(pairs, size)


def _set_at(arr: torch.Tensor, loc: Any, value: torch.Tensor) -> torch.Tensor:
    """``arr`` with ``arr[loc]`` replaced by ``value`` (broadcast to it),
    out of place; ``loc`` is static basic indexing."""
    sel = torch.arange(arr.numel(), device=arr.device).reshape(arr.shape)[loc]
    vals = torch.broadcast_to(value.to(arr.dtype), sel.shape)
    flat = arr.reshape(-1).index_put((sel.reshape(-1),), vals.reshape(-1))
    return flat.reshape(arr.shape)


class TorchWindow:
    """RMA window over a :class:`TorchCommunicator` (functional).

    ``local`` tracks the current window value through fences; programs
    return it from the SPMD program like any other tensor."""

    @staticmethod
    def _no_passive(*_a, **_k):
        raise NotImplementedError(
            "passive-target RMA (Win_lock/unlock) has no SPMD spelling — "
            "one SPMD program cannot leave a rank's window passively "
            "accessible mid-program; use fence epochs (active target) on "
            "this backend")

    def lock(self, rank: int, exclusive: bool = True):
        self._no_passive()

    def unlock(self, rank: int):
        self._no_passive()

    def put_at(self, rank: int, data=None, loc=None):
        self._no_passive()

    def get_at(self, rank: int, loc=None):
        self._no_passive()

    def accumulate_at(self, rank: int, data=None, op=None, loc=None):
        self._no_passive()

    def fetch_and_op(self, rank: int, data=None, op=None, loc=None):
        self._no_passive()

    def compare_and_swap(self, rank: int, compare=None, new=None, loc=None):
        self._no_passive()

    def flush(self, rank: int):
        self._no_passive()

    # PSCW is rank-asymmetric control flow — same no-SPMD-spelling
    # diagnosis as passive target (fence is the active-target mode here)
    post = start = complete = wait = test = _no_passive
    # MPI-3 epoch/atomic helpers: all passive-target shaped
    lock_all = unlock_all = flush_all = _no_passive
    flush_local = flush_local_all = _no_passive
    get_accumulate = rput = rget = raccumulate = _no_passive

    def sync(self) -> None:
        """MPI_Win_sync is valid on any window; in one SPMD program the
        program order IS the memory order — a correct no-op."""

    def __init__(self, comm, init: Any):
        self._comm = comm
        self._arr = primitives.as_tensor(init)
        # queued ops, in issue order (pairs are group-local; they are
        # world-mapped at fence via comm._world_pairs):
        # ("put", data, pairs, loc, None) / ("acc", data, pairs, loc, op)
        # ("get", None, pairs, loc, (fill, future))
        self._queue: List[Tuple] = []
        self._freed = False

    @property
    def local(self) -> torch.Tensor:
        """Current local window value."""
        return self._arr

    # -- epoch ops ---------------------------------------------------------

    def put(self, data: Any, pairs, loc: Any = None) -> None:
        """Queue a pattern put: (src, dst) ships src's ``data`` into dst's
        window (at static index ``loc`` if given)."""
        self._check_open()
        norm = _static_pairs(pairs, self._comm.size)
        self._queue.append(("put", primitives.as_tensor(data), norm, loc, None))

    def accumulate(self, data: Any, pairs, op: _ops.ReduceOp = _ops.SUM,
                   loc: Any = None) -> None:
        """Queue a pattern accumulate: dst window[loc] = op(window[loc], data)."""
        self._check_open()
        norm = _static_pairs(pairs, self._comm.size)
        self._queue.append(("acc", primitives.as_tensor(data), norm, loc, op))

    def get(self, pairs, fill: Any = 0, loc: Any = None) -> GetFuture:
        """Queue a pattern get; the future resolves at ``fence()`` to src's
        window[loc] on each dst rank (``fill`` elsewhere — SPMD programs
        produce a value on every rank)."""
        self._check_open()
        norm = _static_pairs(pairs, self._comm.size)
        fut = GetFuture()
        self._queue.append(("get", None, norm, loc, (fill, fut)))
        return fut

    def fence(self) -> None:
        """Close the epoch: lower queued ops to ppermutes, in issue order;
        writes land before gets are serviced."""
        self._check_open()
        comm = self._comm
        arr = self._arr
        writes = [q for q in self._queue if q[0] != "get"]
        gets = [q for q in self._queue if q[0] == "get"]
        for kind, data, norm, loc, op in writes:
            world = comm._world_pairs(norm)
            incoming = primitives.ppermute(data, world)
            is_dst = algos._mask_of([d for _, d in world], comm._axis_size)
            if kind == "put":
                updated = incoming if loc is None else _set_at(arr, loc, incoming)
            else:
                cur = arr if loc is None else arr[loc]
                combined = op.combine(cur, incoming)
                updated = combined if loc is None else _set_at(arr, loc, combined)
            updated = torch.broadcast_to(updated, arr.shape).to(arr.dtype)
            arr = torch.where(is_dst, updated, arr)
        for _, _, norm, loc, (fill, fut) in gets:
            world = comm._world_pairs(norm)
            src_val = arr if loc is None else arr[loc]
            out = primitives.ppermute(src_val, world)
            is_dst = algos._mask_of([d for _, d in world], comm._axis_size)
            out = torch.where(is_dst, out, torch.full_like(out, fill))
            fut._resolve(out)
        self._arr = arr
        self._queue.clear()

    def free(self) -> None:
        self._freed = True

    def _check_open(self) -> None:
        if self._freed:
            raise RuntimeError("operation on a freed Window")
