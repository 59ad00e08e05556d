"""The flight recorder: a fixed-size, lock-light ring of binary events —
the port's own copy of ``mpi_tpu/telemetry/recorder.py`` (``Recorder``
:64, ``WAIT_MIN_NS`` :62, the Chrome export :170-230).

One :class:`Recorder` per process (module-level singleton in
``telemetry/__init__.py``); every instrumentation seam in the library
tests the singleton for ``None`` and returns — the off-mode contract
(ft/verify/progress all gate the same way), asserted by the
``trace_events`` pvar staying 0.

Every time here is host time (``time.perf_counter_ns``), as in the
reference.  On the card a collective's span ends when its host call
returns: the device work it queued on the stream (clones, folds) may
still be running then.

An event is one tuple ``(t_ns, dur_ns, kind, name, tid, attrs)``:

* ``t_ns`` — ``time.perf_counter_ns()`` at emit (monotonic; the
  recorder stores a (wall, mono) anchor pair taken at enable so export
  maps every event onto the wall clock);
* ``dur_ns`` — 0 for instant events, the span length for completed
  spans (collective begin/end, link heal, lease job, blocked wait);
* ``kind``/``name`` — the event class and the specific event
  (``("coll", "allreduce")``, ``("link", "heal")``, ...);
* ``tid`` — the emitting thread (local-backend ranks are threads; the
  progress engine / fold pool / nonblocking-collective / reader
  threads get their own rows in the trace viewer);
* ``attrs`` — a small dict (algorithm, bytes, seq, peer, ...) or None.

The ring OVERWRITES oldest-first once full (``dropped`` counts what was
lost — a flight recorder keeps the newest history, like its namesake);
capacity comes from ``MPI_TPU_TRACE_EVENTS`` (default 65536/rank,
~4MB).  Emission is one tuple build + one index bump under a plain
lock — "lock-light" here means the critical section is two statements,
not that it is lock-free; at the event rates this library produces
(thousands/s, not millions/s) a futex-free fancy structure would buy
noise.

Export is Chrome-trace / Perfetto JSON (``chrome://tracing`` or
https://ui.perfetto.dev): span events as ``ph: "X"``, instants as
``ph: "i"``, one process per rank, one track per thread.  Cross-rank
merging + clock-offset refinement live in ``tools/tracecat.py``.  The
document keeps the reference's ``mpi_tpu`` metadata key, so the
reference's and the port's ``tracecat`` read either package's traces.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .. import mpit as _mpit
from ..profiling import CommStats

_DEFAULT_CAPACITY = int(os.environ.get("MPI_TPU_TRACE_EVENTS", "65536"))

# Span kinds the Chrome export renders as complete ("X") events; every
# other kind is an instant.  A kind may still emit dur=0 spans (a
# sub-microsecond collective) — they render fine.
_SPAN_KINDS = frozenset({"coll", "wait", "link", "lease", "sm", "heal"})

# Blocked-wait spans below this duration are NOT recorded: a healthy
# recv that hit its message on the first slice would otherwise emit one
# event per receive and drown the trace in noise.  1ms ~= 20 FT poll
# slices of headroom above a same-box delivery.
WAIT_MIN_NS = 1_000_000


class Recorder:
    """Fixed-size ring of timestamped events + per-op comm counters."""

    def __init__(self, capacity: int = 0, rank: Optional[int] = None,
                 trace_dir: Optional[str] = None) -> None:
        self.capacity = int(capacity) or _DEFAULT_CAPACITY
        if self.capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        self.rank = rank
        self.trace_dir = trace_dir
        self.pid = os.getpid()
        # the clock anchor pair: every event timestamp is monotonic;
        # export maps mono -> wall through this pair, so single-host
        # multi-process traces land on one shared timeline (refined
        # further by tracecat's message-matching offset estimation)
        self.wall_anchor_ns = time.time_ns()
        self.mono_anchor_ns = time.perf_counter_ns()
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0  # total events ever emitted (ring index = n % cap)
        self._lock = threading.Lock()
        self._tls = threading.local()  # per-thread open-collective stack
        # per-collective op/byte counters filled by every traced
        # collective (profiling.comm_stats() reads them)
        self.stats = CommStats()

    # -- emission ----------------------------------------------------------

    def emit(self, kind: str, name: str, dur_ns: int = 0,
             attrs: Optional[dict] = None) -> None:
        evt = (time.perf_counter_ns() - dur_ns, dur_ns, kind, name,
               threading.get_ident(), attrs)
        with self._lock:
            self._buf[self._n % self.capacity] = evt
            self._n += 1
        _mpit.count(trace_events=1)

    # -- collective spans (communicator.py seam) ---------------------------

    def coll_begin(self, name: str, algorithm: Optional[str],
                   nbytes: Optional[int]) -> list:
        """Open a collective span on this thread; returns the mutable
        span cell (``_resolve_algorithm`` rewrites slot 1 with the
        RESOLVED algorithm via :meth:`note_algorithm`)."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        cell = [name, algorithm, nbytes, time.perf_counter_ns()]
        stack.append(cell)
        return cell

    def note_algorithm(self, algorithm: str) -> None:
        """Record the resolved algorithm into the innermost open
        collective span (the ``_resolve_algorithm`` seam — one line at
        the single gate every host collective already passes)."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack[-1][1] = algorithm

    def coll_end(self, cell: list, error: Optional[str] = None) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is cell:
            stack.pop()
        name, algorithm, nbytes, t0 = cell
        dur = time.perf_counter_ns() - t0
        attrs: Dict[str, Any] = {}
        if algorithm is not None:
            attrs["algorithm"] = algorithm
        if nbytes is not None:
            attrs["nbytes"] = int(nbytes)
        if error is not None:
            attrs["error"] = error
        self.emit("coll", name, dur_ns=dur, attrs=attrs or None)
        with self._lock:
            # local-backend rank threads share this recorder: the
            # CommStats dict bumps need the same lock emit holds
            self.stats.record(name, int(nbytes or 0))
        _mpit.hist_record("coll_latency_s", dur / 1e9)

    # -- introspection -----------------------------------------------------

    @property
    def events_total(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def dump(self) -> List[dict]:
        """Events oldest-first as dicts (tests / ad-hoc inspection)."""
        with self._lock:
            n = self._n
            if n <= self.capacity:
                raw = self._buf[:n]
            else:
                cut = n % self.capacity
                raw = self._buf[cut:] + self._buf[:cut]
        return [{"t_ns": t, "dur_ns": d, "kind": k, "name": nm,
                 "tid": tid, "attrs": a or {}}
                for (t, d, k, nm, tid, a) in raw]

    def find(self, kind: str, name: Optional[str] = None) -> List[dict]:
        return [e for e in self.dump()
                if e["kind"] == kind and (name is None or e["name"] == name)]

    # -- Chrome-trace export -----------------------------------------------

    def _wall_us(self, t_ns: int) -> float:
        return (self.wall_anchor_ns + (t_ns - self.mono_anchor_ns)) / 1e3

    def chrome_trace(self) -> dict:
        """The Perfetto/chrome://tracing document for THIS rank.  The
        ``mpi_tpu`` metadata block carries what tracecat.py needs for
        cross-rank alignment (anchors, rank, drop count)."""
        pid = self.pid if self.rank is None else self.rank
        events: List[dict] = [
            {"ph": "M", "pid": pid, "name": "process_name",
             "args": {"name": (f"rank {self.rank}" if self.rank is not None
                               else f"pid {self.pid}")}},
        ]
        for e in self.dump():
            rec = {"pid": pid, "tid": e["tid"],
                   "name": e["name"], "cat": e["kind"],
                   "ts": self._wall_us(e["t_ns"]),
                   "args": e["attrs"]}
            if e["kind"] in _SPAN_KINDS:
                rec["ph"] = "X"
                rec["dur"] = e["dur_ns"] / 1e3
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            events.append(rec)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "mpi_tpu": {
                "rank": self.rank, "pid": self.pid,
                "wall_anchor_ns": self.wall_anchor_ns,
                "mono_anchor_ns": self.mono_anchor_ns,
                "events_total": self.events_total,
                "dropped": self.dropped,
                "capacity": self.capacity,
            },
        }

    def export_chrome(self, path: str) -> str:
        """Write the Chrome-trace JSON atomically; returns the path."""
        doc = self.chrome_trace()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def export_to_dir(self, trace_dir: Optional[str] = None
                      ) -> Optional[str]:
        """Standard per-rank export: ``<dir>/trace.r<rank>.<pid>.json``
        (pid-suffixed — serve workers and relaunched worlds share trace
        dirs across process generations).  None when no dir configured."""
        d = trace_dir or self.trace_dir
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        tag = "x" if self.rank is None else str(self.rank)
        return self.export_chrome(
            os.path.join(d, f"trace.r{tag}.{self.pid}.json"))
