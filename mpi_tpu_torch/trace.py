"""Communication tracing + matching verification — the port's own copy of
``mpi_tpu/trace.py`` (``TracingTransport`` :28, ``verify_run`` :73).

Two layers:

* :class:`TracingTransport` — wraps any Transport at the plugin boundary and
  records every send/recv with timestamps; works under ``run_local``'s
  ``transport_wrapper`` hook or around a SocketTransport.
* :func:`verify_run` — runs a portable MPI program on the thread backend
  with tracing on every rank, then cross-checks the per-rank logs with
  ``checker.verify_matching``: unmatched sends (message leaks) and
  unmatched receives are reported exactly like a message-race detector
  would.  The SPMD path needs none of this at runtime — its matching is
  static — but the same user program can be checked here first.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import checker
from .transport.base import Transport


class TracingTransport(Transport):
    """Decorator transport: records (op, peer, ctx, tag, t) tuples."""

    def __init__(self, inner: Transport) -> None:
        self.inner = inner
        self.world_rank = inner.world_rank
        self.world_size = inner.world_size
        self.mailbox = inner.mailbox
        self.device = inner.device
        self.aliases_payloads = inner.aliases_payloads
        # decorate, don't re-tune: a traced run must execute the same
        # collective wire schedule as the wrapped data plane
        self.coll_segment_hint = inner.coll_segment_hint
        self.log: List[Tuple] = []
        self._lock = threading.Lock()

    def _record(self, entry: Tuple) -> None:
        with self._lock:
            self.log.append(entry)

    def send(self, dest: int, ctx, tag: int, payload: Any) -> None:
        self._record(("send", dest, ctx, tag, time.monotonic()))
        self.inner.send(dest, ctx, tag, payload)

    def recv(self, source: int, ctx, tag: int, timeout: Optional[float] = None):
        payload, src, t = self.inner.recv(source, ctx, tag, timeout)
        # record the *matched* source/tag (wildcards resolved), which is what
        # matching verification needs
        self._record(("recv", src, ctx, t, time.monotonic()))
        return payload, src, t

    def poll(self, source: int, ctx, tag: int):
        hit = self.inner.poll(source, ctx, tag)
        if hit is not None:
            _, src, t = hit
            self._record(("recv", src, ctx, t, time.monotonic()))
        return hit

    # the membership epoch is the wrapped transport's
    @property
    def epoch(self) -> int:
        return self.inner.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self.inner.epoch = value

    @property
    def min_peer_epoch(self):
        return self.inner.min_peer_epoch

    def close(self) -> None:
        self.inner.close()

    def as_match_log(self) -> List[Tuple[str, int, int]]:
        """Project to checker.verify_matching format: (op, peer, tag)."""
        return [(op, peer, tag) for (op, peer, ctx, tag, _) in self.log]


def verify_run(
    fn: Callable,
    nranks: int,
    args: Sequence = (),
    kwargs: Optional[Dict] = None,
    timeout: float = 120.0,
    strict_fifo: bool = True,
    runtime_verify: bool = False,
    device=None,
) -> Tuple[List[Any], List[str]]:
    """Run ``fn(comm, *args)`` on the thread backend with full comm tracing;
    return (per-rank results, problems).  ``problems`` is empty iff every
    send was received, every recv was satisfied by a real send, and (with
    ``strict_fifo``, the default) no recv matched a send behind the head
    of its channel — see checker.verify_matching.

    ``device`` is the ranks' device, as for ``run`` (the card unless
    ``"cpu"`` is asked for).  ``runtime_verify=True`` additionally runs
    the MUST-style runtime verifier (``verify/``) during the traced run — deadlocks raise
    DeadlockError, divergent collectives CollectiveMismatchError — and
    appends its lint report (leaked requests, buffer overlaps, ...) to
    ``problems``: one call covering both the post-hoc matching check and
    the online checks."""
    from .transport.local import run_local

    traces: List[Optional[TracingTransport]] = [None] * nranks
    lock = threading.Lock()

    def wrapper(t: Transport) -> Transport:
        tt = TracingTransport(t)
        with lock:
            traces[t.world_rank] = tt
        return tt

    results = run_local(fn, nranks, args=args, kwargs=kwargs, timeout=timeout,
                        transport_wrapper=wrapper, verify=runtime_verify,
                        device=device)
    logs = [t.as_match_log() if t else [] for t in traces]
    problems = checker.verify_matching(logs, strict_fifo=strict_fifo)
    if runtime_verify:
        from .verify import finalize_report

        problems += finalize_report()
    return results, problems
