"""MUST-style runtime correctness verifier + static MPI linter — the
port's own copy of ``mpi_tpu/verify/__init__.py`` (``enable`` :85,
``_attach_clock`` :115, the re-exports :58-78).

* **Deadlock detection** (:mod:`.deadlock`): every verified blocking wait
  runs in slices; past ``verify_stall_timeout_s`` the rank publishes its
  pending op out of band and the AND-OR wait-for analysis
  (``checker.find_deadlock``) turns a closed blocking picture into
  :class:`~mpi_tpu_torch.errors.DeadlockError` naming every rank, its
  pending op and its call site, instead of a hang.
* **Collective matching** (:mod:`.collcheck`): per-entry signatures
  cross-checked in band on the reserved ``TAG_VERIFY`` ring before any
  data moves; divergence raises
  :class:`~mpi_tpu_torch.errors.CollectiveMismatchError` on every rank.
* **Request/resource lints** (:mod:`.state`): leaked requests,
  double-wait, overlapping live tensor ranges across pending nonblocking
  ops (the message-race case) and unfreed communicators, reported
  through the ``verify_*`` pvars and the finalize-time report
  (:func:`take_report` / :func:`finalize_report`).
* **Static lint v2** (:mod:`.lint` on :mod:`.dataflow` +
  :mod:`.commgraph`, CLI ``python -m mpi_tpu_torch.tools.mpilint``):
  rules MPL001–MPL009, suppressed per line by ``# mpilint: ok``.
* **Wildcard-race detection** (:mod:`.vclock`): a vector clock rides on
  every message under verify; an ``ANY_SOURCE`` receive that consumes a
  message concurrent with another eligible pending sender is reported
  as a named race.

Enable with ``MPI_TPU_VERIFY=1`` under the launcher (or
``python -m mpi_tpu_torch.launcher --verify``), ``run(...,
backend="local", verify=True)``, or :func:`enable` on any P2P
communicator.  Off (the default) the whole subsystem is one ``is None``
attribute test per operation, and every ``verify_*`` pvar stays 0.
"""

from __future__ import annotations

import os
from typing import Optional

from ..checker import ScheduleError, find_deadlock, validate_perm, \
    validate_rounds, verify_matching
from ..errors import CollectiveMismatchError, DeadlockError
from ..trace import TracingTransport, verify_run
from . import state as _state
from .collcheck import TAG_VERIFY
from .lint import Finding, lint_file, lint_paths, lint_source
from .state import (CommVerify, FileBoard, MemoryBoard, WorldVerify,
                    finalize_report, peek_report, take_report, user_site)
from .vclock import VClock

__all__ = [
    "enable", "is_enabled", "take_report", "peek_report", "finalize_report",
    "user_site",
    "MemoryBoard", "FileBoard", "WorldVerify", "CommVerify", "VClock",
    "DeadlockError", "CollectiveMismatchError", "TAG_VERIFY",
    "Finding", "lint_source", "lint_file", "lint_paths",
    # the folded-in seed: schedule checking + trace-based matching
    "ScheduleError", "validate_perm", "validate_rounds", "verify_matching",
    "find_deadlock", "verify_run", "TracingTransport",
]


def is_enabled(comm) -> bool:
    return getattr(comm, "_verify", None) is not None


def enable(comm, board=None, rdv_dir: Optional[str] = None,
           stall_timeout_s: Optional[float] = None):
    """Enable the runtime verifier on a P2P communicator (idempotent per
    transport; split/dup children inherit).  Process worlds default to
    ``pending.<rank>`` files under the rendezvous dir (``rdv_dir`` or
    the launcher's MPI_TPU_RDV); in-process worlds pass the shared
    :class:`MemoryBoard` (``run(..., backend="local", verify=True)`` does
    this for you)."""
    if getattr(comm, "_verify", None) is not None:
        return comm
    world = getattr(comm._t, "_verify_world", None)
    if world is None:
        if board is None:
            rdv = rdv_dir or os.environ.get("MPI_TPU_RDV")
            if rdv is None:
                raise ValueError(
                    "the verifier needs an out-of-band board: pass board= "
                    "(in-process worlds) or rdv_dir= / set MPI_TPU_RDV "
                    "(process worlds)")
            board = FileBoard(rdv, comm._t.world_rank, comm._t.world_size)
        world = WorldVerify(
            comm._t, board,
            _state._STALL_TIMEOUT_S if stall_timeout_s is None
            else stall_timeout_s)
        comm._t._verify_world = world
    _attach_clock(comm._t)
    comm._verify = CommVerify(world)
    return comm


def _attach_clock(transport) -> None:
    """Attach one per-rank :class:`VClock` to the transport stack (the
    wildcard-race detector's send stamp + consume merge).  Wrapper
    transports (FaultyTransport, TracingTransport) delegate ``send`` to
    their inner transport, so the clock must sit on EVERY layer down the
    ``inner`` chain — they all share one mailbox, which gets the same
    clock as its consume-side merge point.  Idempotent."""
    t = transport
    if getattr(t, "verify_clock", None) is not None:
        return
    vc = VClock(t.world_rank, t.world_size)
    seen = set()
    while t is not None and id(t) not in seen:
        seen.add(id(t))
        t.verify_clock = vc
        mb = getattr(t, "mailbox", None)
        if mb is not None:
            mb.clock = vc
        t = getattr(t, "inner", None) or getattr(t, "_inner", None)
