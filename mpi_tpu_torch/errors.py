"""MPI error classes and error handlers — the port's own copy of
``mpi_tpu/errors.py``.

The object API raises Python exceptions; ``error_class`` (:282) maps an
exception onto the MPI error-class constants, ``error_string`` (:330)
renders one, and ``invoke_handler`` (:334) dispatches an exception
through a communicator's error handler (``ERRORS_ARE_FATAL`` propagates,
``ERRORS_RETURN`` returns an :class:`ErrorCode`, a callable is called).
``ProcFailedError`` and ``RevokedError`` are kept as types only: fault
tolerance (ULFM) is not ported yet (ROADMAP item 16.2), so nothing in the
port raises them.
"""

from __future__ import annotations

import re as _re
from typing import Any, Optional

__all__ = [
    "MPI_SUCCESS", "MPI_ERR_BUFFER", "MPI_ERR_COUNT", "MPI_ERR_TYPE",
    "MPI_ERR_TAG", "MPI_ERR_COMM", "MPI_ERR_RANK", "MPI_ERR_REQUEST",
    "MPI_ERR_ROOT", "MPI_ERR_GROUP", "MPI_ERR_OP", "MPI_ERR_TOPOLOGY",
    "MPI_ERR_DIMS", "MPI_ERR_ARG", "MPI_ERR_UNKNOWN", "MPI_ERR_TRUNCATE",
    "MPI_ERR_OTHER", "MPI_ERR_INTERN", "MPI_ERR_PENDING", "MPI_ERR_IO",
    "MPI_ERR_PROC_FAILED", "MPI_ERR_REVOKED",
    "ERRORS_ARE_FATAL", "ERRORS_RETURN", "ErrorCode",
    "ProcFailedError", "RevokedError",
    "error_class", "error_string", "invoke_handler",
]

MPI_SUCCESS = 0
MPI_ERR_BUFFER = 1
MPI_ERR_COUNT = 2
MPI_ERR_TYPE = 3
MPI_ERR_TAG = 4
MPI_ERR_COMM = 5
MPI_ERR_RANK = 6
MPI_ERR_REQUEST = 7
MPI_ERR_ROOT = 8
MPI_ERR_GROUP = 9
MPI_ERR_OP = 10
MPI_ERR_TOPOLOGY = 11
MPI_ERR_DIMS = 12
MPI_ERR_ARG = 13
MPI_ERR_UNKNOWN = 14
MPI_ERR_TRUNCATE = 15
MPI_ERR_OTHER = 16
MPI_ERR_INTERN = 17
MPI_ERR_PENDING = 18
MPI_ERR_IO = 19
# ULFM (MPI Forum User-Level Failure Mitigation proposal) error classes:
# a peer process is known dead / the communicator was revoked.
MPI_ERR_PROC_FAILED = 20
MPI_ERR_REVOKED = 21

_STRINGS = {
    MPI_SUCCESS: "no error",
    MPI_ERR_BUFFER: "invalid buffer",
    MPI_ERR_COUNT: "invalid count",
    MPI_ERR_TYPE: "invalid datatype",
    MPI_ERR_TAG: "invalid tag",
    MPI_ERR_COMM: "invalid communicator",
    MPI_ERR_RANK: "invalid rank",
    MPI_ERR_REQUEST: "invalid request",
    MPI_ERR_ROOT: "invalid root",
    MPI_ERR_GROUP: "invalid group",
    MPI_ERR_OP: "invalid reduce operation",
    MPI_ERR_TOPOLOGY: "invalid topology",
    MPI_ERR_DIMS: "invalid dimensions",
    MPI_ERR_ARG: "invalid argument",
    MPI_ERR_UNKNOWN: "unknown error",
    MPI_ERR_TRUNCATE: "message truncated on receive",
    MPI_ERR_OTHER: "known error not in this list",
    MPI_ERR_INTERN: "internal error",
    MPI_ERR_PENDING: "pending operation (timeout)",
    MPI_ERR_IO: "I/O error",
    MPI_ERR_PROC_FAILED: "peer process has failed",
    MPI_ERR_REVOKED: "communicator has been revoked",
}


class ProcFailedError(RuntimeError):
    """MPI_ERR_PROC_FAILED [S: ULFM]: an operation could not complete
    because a member of the communicator is dead — detected either by the
    liveness layer (mpi_tpu/ft.py heartbeat detector) or by transport
    evidence (failed send / recv timeout on a suspected peer).  Carries
    the suspected comm ranks and, for collective waits, which collective
    and pipeline segment was in flight when the death surfaced."""

    def __init__(self, msg: str, failed=(), collective: Optional[str] = None,
                 segment: Optional[int] = None):
        super().__init__(msg)
        self.failed = tuple(failed)
        self.collective = collective
        self.segment = segment

    def __str__(self) -> str:
        base = super().__str__()
        bits = []
        if self.failed:
            bits.append(f"failed ranks {list(self.failed)}")
        if self.collective:
            bits.append(f"in {self.collective}")
        if self.segment is not None:
            bits.append(f"segment {self.segment}")
        return f"{base} [{', '.join(bits)}]" if bits else base


class RevokedError(RuntimeError):
    """MPI_ERR_REVOKED [S: ULFM]: the communicator was revoked
    (``comm.revoke()`` on any rank); every pending and future p2p or
    collective operation on it raises this — the mechanism that unblocks
    survivors who were not themselves talking to a dead rank."""


class _FatalHandler:
    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "ERRORS_ARE_FATAL"


class _ReturnHandler:
    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "ERRORS_RETURN"


ERRORS_ARE_FATAL = _FatalHandler()
ERRORS_RETURN = _ReturnHandler()


class ErrorCode(int):
    """An MPI error code: an int (comparable to the MPI_ERR_* constants)
    that also carries the originating exception for diagnosis."""

    exception: Optional[BaseException]

    def __new__(cls, code: int, exception: Optional[BaseException] = None):
        self = super().__new__(cls, code)
        self.exception = exception
        return self

    @classmethod
    def from_exception(cls, exc: BaseException) -> "ErrorCode":
        return cls(error_class(exc), exc)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"ErrorCode({int(self)}: {error_string(int(self))}"
                f"{f', from {self.exception!r}' if self.exception else ''})")


# word-pattern → class, first hit wins; keep specific words before generic
# ones.  \b boundaries so short keys don't fire inside unrelated words
# ("op" in "open", "source" in "resource", "tag" in "storage").
_CLASSIFY = [(_re.compile(p), c) for p, c in [
    (r"\btags?\b", MPI_ERR_TAG),
    (r"\branks?\b", MPI_ERR_RANK),
    (r"\bdest\b", MPI_ERR_RANK),
    (r"\bsource\b", MPI_ERR_RANK),
    (r"\broot\b", MPI_ERR_ROOT),
    (r"\bcounts?\b", MPI_ERR_COUNT),
    (r"truncat", MPI_ERR_TRUNCATE),
    (r"payload has", MPI_ERR_TRUNCATE),
    (r"\bdatatype\b", MPI_ERR_TYPE),
    (r"\bdtype\b", MPI_ERR_TYPE),
    (r"\bcommunicator\b", MPI_ERR_COMM),
    (r"\bgroups?\b", MPI_ERR_GROUP),
    (r"\balgorithm\b", MPI_ERR_OP),
    (r"\bops?\b", MPI_ERR_OP),
    (r"topolog", MPI_ERR_TOPOLOGY),
    (r"\bdims?\b", MPI_ERR_DIMS),
    (r"\bbuffers?\b", MPI_ERR_BUFFER),
    (r"\bfiles?\b", MPI_ERR_IO),
]]


def error_class(exc: Any) -> int:
    """Classify an exception (or an ErrorCode) into an MPI error class."""
    if isinstance(exc, ErrorCode):
        return int(exc)
    if isinstance(exc, int):
        return exc
    if isinstance(exc, ProcFailedError):
        return MPI_ERR_PROC_FAILED
    if isinstance(exc, RevokedError):
        return MPI_ERR_REVOKED
    from .transport.base import RecvTimeout  # local import: no cycle at load

    if isinstance(exc, RecvTimeout):
        return MPI_ERR_PENDING
    if isinstance(exc, (OSError, IOError)):
        return MPI_ERR_IO
    msg = str(exc).lower()
    if isinstance(exc, (TypeError,)) and ("dtype" in msg or "datatype" in msg):
        return MPI_ERR_TYPE
    if isinstance(exc, (ValueError, KeyError, IndexError, TypeError)):
        for pat, code in _CLASSIFY:
            if pat.search(msg):
                return code
        return MPI_ERR_ARG
    return MPI_ERR_OTHER


def error_string(code: int) -> str:
    return _STRINGS.get(int(code), f"invalid error class {int(code)}")


def invoke_handler(comm: Any, exc: BaseException) -> Any:
    """Dispatch ``exc`` through ``comm``'s error handler (api.py boundary)."""
    get = getattr(comm, "get_errhandler", None)
    handler = get() if get is not None else ERRORS_ARE_FATAL
    if handler is ERRORS_ARE_FATAL:
        raise exc
    if handler is ERRORS_RETURN:
        return ErrorCode.from_exception(exc)
    return handler(comm, exc)
