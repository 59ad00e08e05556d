"""Reduction operators for the port's collectives.

Own copy of ``mpi_tpu/ops.py:31-187`` (the user ops' ``_maximum`` /
``_minimum``, ``ReduceOp``, ``make_op``, the ten built-ins and
``BY_NAME``) with torch combines.  ``combine_into`` (:62) is
the host engine's in-place fold: the reference's ``ufunc(acc, value,
out=acc)`` becomes the op's torch function with ``out=acc``, on the
accumulator's own device, after the same buffer-ownership hook
(``bufpool.touch``).

``identity(dtype)`` takes a ``torch.dtype`` and returns the neutral
element as a Python scalar, exact for every width (an int64 identity is a
Python int, never a float round trip).
"""

from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import bufpool as _bufpool


def _maximum(a, b):
    """Elementwise max for user ops (``mpi_tpu/ops.py:31``): torch's when
    either side is a tensor (on its device), numpy's otherwise."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))
    return np.maximum(a, b)


def _minimum(a, b):
    """Elementwise min for user ops (``mpi_tpu/ops.py:39``), as
    :func:`_maximum`."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.minimum(torch.as_tensor(a), torch.as_tensor(b))
    return np.minimum(a, b)


@dataclass(frozen=True)
class ReduceOp:
    """An MPI reduction operator: elementwise combiner + dtype-aware identity.

    ``inplace`` (built-in ops only) is the torch function with an ``out=``
    argument that ``combine_into`` folds with; ``combine`` stays the
    portable spelling (and the one user ops supply)."""

    name: str
    combine: Callable[[Any, Any], Any]
    identity: Callable[[torch.dtype], Any]  # torch.dtype -> neutral scalar
    commutative: bool = True
    inplace: Any = None  # torch function taking out=, for host folds

    def combine_into(self, acc: torch.Tensor, value: Any,
                     decode: Optional[Callable[[Any], Any]] = None
                     ) -> torch.Tensor:
        """Accumulate ``value`` into tensor ``acc`` IN PLACE on ``acc``'s
        device: no result allocation for built-in ops, one temporary for
        user ops.  Always keeps ``acc``'s dtype (MPI reduces in the
        datatype, so a user combine that upcasts is cast back at every
        fold).  ``acc`` may still be retained by reference in a socket
        link's replay window, so the ownership layer is told first.

        ``decode`` is the wire-dtype != fold-dtype seam (``compress.py``):
        when set, ``value`` arrived in a wire encoding and is decoded to
        the fold dtype here, the one point where the two dtypes meet."""
        if decode is not None:
            value = decode(value)
        if not isinstance(value, torch.Tensor) or value.device != acc.device:
            value = torch.as_tensor(value, device=acc.device)
        _bufpool.touch(acc)
        if self.inplace is not None:
            self.inplace(acc, value, out=acc)
            return acc
        out = self.combine(acc, value)
        if out is not acc:
            acc.copy_(out)
        return acc

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ReduceOp({self.name})"


def _kind(dtype: torch.dtype) -> str:
    if dtype == torch.bool:
        return "b"
    if dtype.is_floating_point:
        return "f"
    if dtype.is_complex:
        return "c"
    return "i"


def _id_sum(dtype):
    return False if _kind(dtype) == "b" else 0


def _id_prod(dtype):
    return True if _kind(dtype) == "b" else 1


def _id_max(dtype):
    k = _kind(dtype)
    if k == "f":
        return float("-inf")
    if k == "i":
        return torch.iinfo(dtype).min
    if k == "b":
        return False
    raise TypeError(f"MAX has no identity for dtype {dtype}")


def _id_min(dtype):
    k = _kind(dtype)
    if k == "f":
        return float("inf")
    if k == "i":
        return torch.iinfo(dtype).max
    if k == "b":
        return True
    raise TypeError(f"MIN has no identity for dtype {dtype}")


def _id_band(dtype):
    k = _kind(dtype)
    if k == "b":
        return True
    if k == "i":
        return -1 if torch.iinfo(dtype).min < 0 else torch.iinfo(dtype).max
    raise TypeError(f"BAND has no identity for dtype {dtype}")


def _id_false(dtype):
    k = _kind(dtype)
    if k == "b":
        return False
    if k == "i":
        return 0
    raise TypeError(f"bitwise/logical op has no identity for dtype {dtype}")


def _id_true(dtype):
    k = _kind(dtype)
    if k == "b":
        return True
    if k == "i":
        return 1
    raise TypeError(f"LAND has no identity for dtype {dtype}")


def make_op(combine: Callable[[Any, Any], Any], identity: Any,
            name: str = "user", commutative: bool = True) -> ReduceOp:
    """MPI_Op_create analogue.  ``combine(a, b)`` must be associative and
    elementwise over tensors; ``identity`` is a scalar or a callable
    ``torch.dtype -> scalar``."""
    ident_fn = identity if callable(identity) else (lambda dtype, _v=identity: _v)
    return ReduceOp(name, combine, ident_fn, commutative)


SUM = ReduceOp("sum", operator.add, _id_sum, inplace=torch.add)
PROD = ReduceOp("prod", operator.mul, _id_prod, inplace=torch.mul)
MAX = ReduceOp("max", torch.maximum, _id_max,  # NaN-propagating
               inplace=torch.maximum)
MIN = ReduceOp("min", torch.minimum, _id_min, inplace=torch.minimum)
# the in-place functions mirror the operator spellings exactly (``&`` /
# ``|`` / ``^`` on tensors ARE the bitwise functions), as the reference's
# ufuncs mirror its operators
LAND = ReduceOp("land", operator.and_, _id_true, inplace=torch.bitwise_and)
LOR = ReduceOp("lor", operator.or_, _id_false, inplace=torch.bitwise_or)
LXOR = ReduceOp("lxor", operator.xor, _id_false, inplace=torch.bitwise_xor)
BAND = ReduceOp("band", operator.and_, _id_band, inplace=torch.bitwise_and)
BOR = ReduceOp("bor", operator.or_, _id_false, inplace=torch.bitwise_or)
BXOR = ReduceOp("bxor", operator.xor, _id_false, inplace=torch.bitwise_xor)

ALL_OPS = (SUM, PROD, MAX, MIN, LAND, LOR, LXOR, BAND, BOR, BXOR)
BY_NAME = {op.name: op for op in ALL_OPS}
