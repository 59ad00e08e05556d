"""The observability layer — the port's own copy of
``mpi_tpu/telemetry/__init__.py`` (:32-121).

* the **flight recorder** (``recorder.py``): one process-wide ring of
  ``(t_ns, dur_ns, kind, name, tid, attrs)`` events — collective spans
  with their resolved algorithm and payload bytes, blocked waits past
  ``WAIT_MIN_NS``, socket frames, link reconnects, replays and heals,
  nonblocking-collective state machines, fault suspicions, epoch
  transitions and verifier findings — exported as Chrome-trace JSON, one
  file per rank, merged by ``python -m mpi_tpu_torch.tools.tracecat``;
* the **histogram pvars** and **sessions** of ``mpit.py``;
* ``profiling.comm_stats()``, the per-op counters of the traced run.

``REC`` is the off-mode gate: every seam reads it and returns when it is
None, so with tracing off the ``trace_events`` pvar stays 0.  Enable with
``run(..., backend="local", trace=True)``, ``MPI_TPU_TRACE=1`` (export at
exit with ``MPI_TPU_TRACE_DIR``, the launcher's ``--trace-dir``) or
:func:`enable`.  ``telemetry/metrics.py`` renders a resident world
server's ``stats()`` and the histogram pvars as Prometheus text (the
``/metrics`` endpoint of ``serve.WorldServer``).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .recorder import Recorder, WAIT_MIN_NS

__all__ = [
    "Recorder", "REC", "WAIT_MIN_NS", "enable", "disable", "enabled",
    "recorder", "export_chrome", "env_enabled", "env_trace_dir",
    "enable_from_env",
]

# THE off-mode gate: every instrumentation seam in the library reads
# this module attribute and returns when it is None.  Process-wide on
# purpose (like the mpit counters): local-backend rank threads share
# one recorder and are told apart by tid; process worlds each own one.
REC: Optional[Recorder] = None

_LAST: Optional[Recorder] = None  # kept after disable() for export
_lock = threading.Lock()


def enable(rank: Optional[int] = None, capacity: int = 0,
           trace_dir: Optional[str] = None) -> Recorder:
    """Start (or return) the process flight recorder.  Idempotent like
    ft/verify enable: re-enabling an active recorder returns it
    unchanged (rank/capacity of the first call win)."""
    global REC, _LAST
    with _lock:
        if REC is None:
            REC = _LAST = Recorder(capacity=capacity, rank=rank,
                                   trace_dir=trace_dir)
        return REC


def disable() -> Optional[Recorder]:
    """Stop recording.  The recorder object (and its events) survives
    as :func:`recorder`'s return value so a just-finished traced run
    can still be exported/inspected — only NEW events stop."""
    global REC
    with _lock:
        rec, REC = REC, None
        return rec


def enabled() -> bool:
    return REC is not None


def recorder() -> Optional[Recorder]:
    """The active recorder, or the most recently disabled one."""
    return REC if REC is not None else _LAST


def export_chrome(path: str, rec: Optional[Recorder] = None) -> str:
    """Export the active (or last) recorder as Chrome-trace JSON."""
    rec = rec or recorder()
    if rec is None:
        raise RuntimeError("no recorder: enable tracing first "
                           "(MPI_TPU_TRACE=1 / run(..., trace=True) / "
                           "telemetry.enable())")
    return rec.export_chrome(path)


# -- environment enablement (init() / worker processes) ----------------------


def env_enabled() -> bool:
    return os.environ.get("MPI_TPU_TRACE", "") not in ("", "0")


def env_trace_dir() -> Optional[str]:
    return os.environ.get("MPI_TPU_TRACE_DIR") or None


def enable_from_env(rank: Optional[int] = None) -> Optional[Recorder]:
    """init()-time enablement: ``MPI_TPU_TRACE=1`` starts the recorder,
    ``MPI_TPU_TRACE_DIR`` (launcher ``--trace-dir``) makes it export at
    process exit — atexit rather than finalize-only, because a rank
    program that ``sys.exit``s without a finalize has exactly the trace
    worth keeping."""
    if not env_enabled():
        return None
    rec = enable(rank=rank, trace_dir=env_trace_dir())
    if rec.trace_dir:
        import atexit

        atexit.register(rec.export_to_dir)
    return rec
