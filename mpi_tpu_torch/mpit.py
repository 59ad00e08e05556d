"""MPI_T tool interface — the port's own copy of the part of
``mpi_tpu/mpit.py`` the host layer reads.

* Performance variables (pvars): exact, thread-safe counters.  ``count``
  (:126) takes the reference's keyword names; ``pvar_read`` /
  ``pvar_reset`` (:437-445) read them under the reference's pvar names
  (``msgs_sent``, ``bytes_raw_sent``, ``bytes_pickled_sent``,
  ``payload_copies``, the ``link_*`` and ``recv_*`` families, the
  user-buffer steering's ``recv_user_inplace`` / ``recv_user_fallbacks``
  (:164-165, :407-408); the
  fault-tolerance, progress and nonblocking-collective counters
  ``proc_failures_detected``, ``revokes_delivered``,
  ``shrinks_completed``, ``rejoins_completed``, ``epoch_skews_detected``,
  ``faulty_dropped`` / ``faulty_duplicated``, ``progress_*``,
  ``nbc_threads_spawned``, ``nbc_state_machines``, ``persistent_starts``;
  the runtime verifier's ``verify_*`` (:133-218, :274-300), the flight
  recorder's ``trace_events`` (:380), the collective arena's
  ``coll_sm_hits`` / ``coll_sm_bytes`` / ``coll_sm_fallbacks`` (:266),
  compression's ``bytes_compressed_saved`` / ``compress_fallbacks``
  (:311), tuned dispatch's ``tuned_table_hits`` /
  ``tuned_table_fallbacks`` (:320) and the namespace store's
  ``store_elections``, ``store_entries_truncated``,
  ``store_partition_dropped`` counters and ``store_term`` /
  ``store_commit_index`` gauges (:409-428)).
* Histogram pvars (:451-600): log-bucketed distributions,
  ``hist_record``, ``pvar_hist_list`` / ``pvar_hist_read`` /
  ``pvar_hist_reset``, ``hist_quantile``, ``hist_cumulative``, pre-seeded
  with ``coll_latency_s``, ``lease_acquire_s`` and ``link_heal_s``.
* Control variables (cvars): ``cvar_read`` / ``cvar_write`` (:602-611)
  over the knobs the host layer reads — ``collective_segment_bytes``,
  the two allreduce crossovers, ``recv_steering``, and (:700-1000)
  ``progress``, ``nbc_mode``, ``nbc_fold_workers``, ``nbc_sm_max_bytes``,
  ``fault_detect_timeout_s``, ``fault_heartbeat_interval_s``,
  ``epoch_grace_s``, ``link_keepalive_s`` and ``verify_stall_timeout_s``
  (:720, :804), ``shm_write_timeout_s`` (:786), ``coll_sm_arena_bytes``
  / ``coll_sm_eager_bytes`` (:857), ``compress_wire_dtype`` /
  ``compress_topk_ratio`` (:884) and ``tuning_table_path`` (:1032), with
  the reference's defaults and validation.
* Sessions (:1056-1077): ``Session`` / ``session_create``, pvar reads
  relative to the session's resets.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["count", "pvar_list", "pvar_read", "pvar_reset", "cvar_list",
           "cvar_read", "cvar_write", "hist_record", "pvar_hist_list",
           "pvar_hist_read", "pvar_hist_reset", "hist_quantile",
           "hist_cumulative", "Session", "session_create"]

_lock = threading.Lock()

# count() keyword -> pvar name (the reference's spellings of both)
_PVAR_OF = {
    "sends": "msgs_sent",
    "send_bytes": "bytes_sent",
    "recvs": "msgs_received",
    "collectives": "collectives_started",
    "bytes_raw": "bytes_raw_sent",
    "bytes_pickled": "bytes_pickled_sent",
    "copies": "payload_copies",
    "link_reconnects": "link_reconnects",
    "link_frames_replayed": "link_frames_replayed",
    "link_faults_masked": "link_faults_masked",
    "link_bytes_retained": "link_bytes_retained",
    "link_cow_snapshots": "link_cow_snapshots",
    "link_cow_bytes": "link_cow_bytes",
    "link_send_syscalls": "link_send_syscalls",
    "link_recv_syscalls": "link_recv_syscalls",
    "link_torn_frames": "link_torn_frames",
    "recv_pool_hits": "recv_pool_hits",
    "recv_pool_misses": "recv_pool_misses",
    "recv_pool_rendezvous": "recv_pool_rendezvous",
    "recv_bytes_steered": "recv_bytes_steered",
    "recv_pool_fold_fallbacks": "recv_pool_fold_fallbacks",
    "recv_user_inplace": "recv_user_inplace",
    "recv_user_fallbacks": "recv_user_fallbacks",
    "proc_failed": "proc_failures_detected",
    "revokes": "revokes_delivered",
    "shrinks": "shrinks_completed",
    "rejoins": "rejoins_completed",
    "epoch_skews": "epoch_skews_detected",
    "faulty_dropped": "faulty_dropped",
    "faulty_duplicated": "faulty_duplicated",
    "progress_wakeups": "progress_wakeups",
    "progress_completions": "progress_completions",
    "progress_idle_parks": "progress_idle_parks",
    "nbc_threads_spawned": "nbc_threads_spawned",
    "nbc_state_machines": "nbc_state_machines",
    "persistent_starts": "persistent_starts",
    "verify_deadlocks": "verify_deadlocks_detected",
    "verify_mismatches": "verify_collective_mismatches",
    "verify_requests_leaked": "verify_requests_leaked",
    "verify_double_waits": "verify_double_waits",
    "verify_buffer_overlaps": "verify_buffer_overlaps",
    "verify_comms_unfreed": "verify_comms_unfreed",
    "verify_wildcard_races": "verify_wildcard_races",
    "verify_clock_bytes": "verify_clock_bytes",
    "trace_events": "trace_events",
    "coll_sm_hits": "coll_sm_hits",
    "coll_sm_bytes": "coll_sm_bytes",
    "coll_sm_fallbacks": "coll_sm_fallbacks",
    "bytes_compressed_saved": "bytes_compressed_saved",
    "compress_fallbacks": "compress_fallbacks",
    "tuned_table_hits": "tuned_table_hits",
    "tuned_table_fallbacks": "tuned_table_fallbacks",
    # the replicated namespace store (federation_store.py): elections a
    # node of this process started, uncommitted entries a new leader's
    # conflict check truncated, and node frames an installed partition
    # map dropped; all 0 in runs without a raft store
    "store_elections": "store_elections",
    "store_entries_truncated": "store_entries_truncated",
    "store_partition_dropped": "store_partition_dropped",
}

_counters: Dict[str, int] = {name: 0 for name in _PVAR_OF.values()}


def _store_gauge(field: str) -> int:
    # a lazy lookup: reading a pvar must not import the federation tier
    mod = sys.modules.get("mpi_tpu_torch.federation_store")
    return 0 if mod is None else int(mod.store_gauge(field))


# gauges, not counters: the current max term / commit index over this
# process's live store nodes (0 with none)
_GAUGES: Dict[str, Callable[[], int]] = {
    "store_term": lambda: _store_gauge("term"),
    "store_commit_index": lambda: _store_gauge("commit_index"),
}


def count(**deltas: int) -> None:
    """Thread-safe increment (the local backend's rank threads share this
    process's counters).  Keywords are the reference's ``count`` names."""
    with _lock:
        for key, n in deltas.items():
            if n:
                _counters[_PVAR_OF[key]] += n


def pvar_list() -> List[str]:
    """MPI_T_pvar_get_info over all indices: the variable names."""
    return sorted([*_counters, *_GAUGES])


def pvar_read(name: str) -> int:
    """Absolute (process-lifetime) value of a performance variable."""
    gauge = _GAUGES.get(name)
    if gauge is not None:
        return gauge()
    try:
        return _counters[name]
    except KeyError:
        raise KeyError(f"unknown pvar {name!r}; have {pvar_list()}") from None


def pvar_reset(name: str) -> int:
    """The current value, to subtract from later reads (MPI_T puts the
    reset itself in a session)."""
    return pvar_read(name)


# -- histogram pvars ---------------------------------------------------------
#
# Log-bucketed (base-2) histograms: bucket k holds values in
# [2^(k-1), 2^k) nanoseconds, 64 buckets, O(1) record cost.  Quantiles are
# the geometric midpoint 2^(k-0.5) of the bucket the rank falls in,
# clamped to the observed min/max (at most ~41% relative error).
# Recording sites: every traced collective (coll_latency_s, gated on the
# flight recorder), every socket link heal (link_heal_s, always on) and
# every serve lease grant (lease_acquire_s).

_HIST_BUCKETS = 64


class _Hist:
    __slots__ = ("counts", "n", "total_ns", "min_ns", "max_ns")

    def __init__(self) -> None:
        self.counts = [0] * _HIST_BUCKETS
        self.n = 0
        self.total_ns = 0
        self.min_ns: Optional[int] = None
        self.max_ns = 0

    def add(self, ns: int) -> None:
        self.counts[min(_HIST_BUCKETS - 1, ns.bit_length())] += 1
        self.n += 1
        self.total_ns += ns
        if self.min_ns is None or ns < self.min_ns:
            self.min_ns = ns
        if ns > self.max_ns:
            self.max_ns = ns


# pre-seeded so pvar_hist_list() is stable before any event fires
_HISTS: Dict[str, _Hist] = {
    "coll_latency_s": _Hist(),
    "lease_acquire_s": _Hist(),
    "link_heal_s": _Hist(),
}


def hist_record(name: str, seconds: float) -> None:
    """Record one sample (seconds; negative clamps to 0) into the named
    histogram, creating it on first use."""
    ns = max(0, int(seconds * 1e9))
    with _lock:
        h = _HISTS.get(name)
        if h is None:
            h = _HISTS[name] = _Hist()
        h.add(ns)


def pvar_hist_list() -> List[str]:
    with _lock:
        return sorted(_HISTS)


def _hist(name: str) -> _Hist:
    h = _HISTS.get(name)
    if h is None:
        raise KeyError(f"unknown histogram pvar {name!r}; have "
                       f"{sorted(_HISTS)}")
    return h


def pvar_hist_read(name: str) -> Dict[str, Any]:
    """Snapshot of a histogram pvar: count/sum/min/max plus the non-empty
    buckets as ``{upper_bound_seconds: count}``."""
    with _lock:
        h = _hist(name)
        return {
            "count": h.n,
            "sum_s": h.total_ns / 1e9,
            "min_s": (h.min_ns or 0) / 1e9,
            "max_s": h.max_ns / 1e9,
            "buckets": {(1 << k) / 1e9: c
                        for k, c in enumerate(h.counts) if c},
        }


def pvar_hist_reset(name: str) -> None:
    with _lock:
        if name in _HISTS:
            _HISTS[name] = _Hist()


def hist_cumulative(name: str) -> List[Tuple[float, int]]:
    """Cumulative (upper_bound_seconds, count<=bound) pairs over the
    non-empty prefix (the Prometheus ``le`` series)."""
    with _lock:
        h = _hist(name)
        out: List[Tuple[float, int]] = []
        cum = 0
        top = max((k for k, c in enumerate(h.counts) if c), default=-1)
        for k in range(top + 1):
            cum += h.counts[k]
            out.append(((1 << k) / 1e9, cum))
        return out


def hist_quantile(name: str, q: float) -> Optional[float]:
    """Estimated q-quantile (seconds), or None for an empty histogram."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    with _lock:
        h = _hist(name)
        if h.n == 0:
            return None
        target = q * h.n
        cum = 0
        for k, c in enumerate(h.counts):
            cum += c
            if cum >= target and c:
                est = 2.0 ** (k - 0.5)
                return min(max(est, float(h.min_ns or 0)),
                           float(h.max_ns)) / 1e9
        return h.max_ns / 1e9  # pragma: no cover - cum == n at the top


# -- control variables -------------------------------------------------------

_CVARS: Dict[str, Tuple[Callable[[], Any], Callable[[Any], None], str]] = {}


def _builtin_cvars() -> None:
    """Registered lazily: the communicator and recvpool modules import
    this one, so their knobs are looked up at first use."""
    if _CVARS:
        return
    from . import coll_sm as _sm
    from . import communicator as _c
    from . import compress as _compress
    from . import ft as _ft
    from . import nbc as _nbc
    from . import progress as _prog
    from . import recvpool as _recvpool
    from . import resilience as _resilience
    from . import tuning as _tuning
    from .transport import shm as _shm
    from .transport import socket as _socket
    from .verify import state as _vstate

    def _set_nonneg(attr: str, what: str):
        def write(v):
            if int(v) < 0:
                raise ValueError(f"{what} must be >= 0")
            setattr(_c, attr, int(v))
        return write

    def _set_steering(v):
        _recvpool._STEERING = 1 if int(v) else 0

    def _set_positive(mod, attr: str, what: str):
        def write(v):
            if float(v) <= 0:
                raise ValueError(f"{what} must be > 0")
            setattr(mod, attr, float(v))
        return write

    def _set_nonneg_s(mod, attr: str, what: str):
        def write(v):
            if float(v) < 0:
                raise ValueError(f"{what} must be >= 0")
            setattr(mod, attr, float(v))
        return write

    def _set_progress(v):
        if v not in _prog.MODES:
            raise ValueError(
                f"progress must be one of {list(_prog.MODES)}, got {v!r}")
        _prog._DEFAULT_MODE = v

    def _set_nbc_mode(v):
        if v not in _nbc.MODES:
            raise ValueError(
                f"nbc_mode must be one of {list(_nbc.MODES)}, got {v!r}")
        _nbc._MODE = v

    def _set_nbc_fold_workers(v):
        if int(v) < 1:
            raise ValueError("nbc_fold_workers must be >= 1")
        _nbc._FOLD_WORKERS = int(v)

    def _set_nbc_sm_max(v):
        if int(v) < 0:
            raise ValueError("nbc_sm_max_bytes must be >= 0 (0 = no cap)")
        _nbc._SM_MAX_BYTES = int(v)

    def _set_sm_arena(v):
        if int(v) < 0:
            raise ValueError("coll_sm_arena_bytes must be >= 0 (0 = off)")
        _sm._ARENA_BYTES = int(v)

    def _set_sm_eager(v):
        if int(v) < 0:
            raise ValueError("coll_sm_eager_bytes must be >= 0")
        _sm._EAGER_BYTES = int(v)

    def _set_wire_dtype(v):
        if v not in _compress.FORMATS:
            raise ValueError(
                f"compress_wire_dtype must be one of "
                f"{sorted(_compress.FORMATS)}, got {v!r}")
        _compress._WIRE_DTYPE = v

    def _set_topk_ratio(v):
        if float(v) <= 0:
            raise ValueError("compress_topk_ratio must be > 0")
        _compress._TOPK_RATIO = float(v)

    def _set_epoch_grace(v):
        if float(v) < 0:
            raise ValueError("epoch_grace_s must be >= 0")
        # one knob, both byte-stream transports: socket hello acks and
        # shm readiness stamps
        _socket._EPOCH_GRACE_S = float(v)
        _shm._EPOCH_GRACE_S = float(v)

    def _set_verify_stall(v):
        if float(v) <= 0:
            raise ValueError("verify_stall_timeout_s must be > 0")
        _vstate._STALL_TIMEOUT_S = float(v)

    _CVARS.update({
        "collective_segment_bytes": (
            lambda: _c._SEGMENT_BYTES,
            _set_nonneg("_SEGMENT_BYTES",
                        "collective_segment_bytes (0 = per-transport)"),
            "pipeline segment size of the host collective engine; 0 "
            "defers to the transport's coll_segment_hint"),
        "allreduce_ring_crossover_bytes": (
            lambda: _c._RING_CROSSOVER_BYTES,
            _set_nonneg("_RING_CROSSOVER_BYTES",
                        "allreduce_ring_crossover_bytes"),
            "allreduce auto picks recursive halving below this size "
            "(pow2 groups), ring at or above it"),
        "allreduce_rabenseifner_crossover_bytes": (
            lambda: _c._RABENSEIFNER_CROSSOVER_BYTES,
            _set_nonneg("_RABENSEIFNER_CROSSOVER_BYTES",
                        "allreduce_rabenseifner_crossover_bytes"),
            "allreduce auto hands payloads at or above this size to the "
            "Rabenseifner composition"),
        "recv_steering": (
            lambda: _recvpool._STEERING, _set_steering,
            "1: socket readers land collective segments directly in the "
            "posted destination views; 0: every frame takes the pool "
            "path (accounting stays on)"),
        "progress": (
            lambda: _prog._DEFAULT_MODE, _set_progress,
            "default progress mode of new worlds: 'thread' starts one "
            "progress engine per world (background completion of "
            "nonblocking operations), 'none' keeps progress "
            "caller-financed; run(progress=...) and MPI_TPU_PROGRESS "
            "override"),
        "nbc_mode": (
            lambda: _nbc._MODE, _set_nbc_mode,
            "'auto' runs i-collectives as schedule state machines on "
            "worlds with a progress engine; 'thread' runs each on a "
            "thread of its own; MPI_TPU_NBC seeds the default"),
        "nbc_fold_workers": (
            lambda: _nbc._FOLD_WORKERS, _set_nbc_fold_workers,
            "width of the per-world pool that applies the state "
            "machines' folds and posts their sends; read at a world's "
            "first state machine; MPI_TPU_NBC_FOLD_WORKERS seeds it"),
        "nbc_sm_max_bytes": (
            lambda: _nbc._SM_MAX_BYTES, _set_nbc_sm_max,
            "payload ceiling of the state-machine path (reductions: the "
            "working buffer; ialltoall: the largest block); larger calls "
            "take the segmented blocking algorithms on a thread; 0 "
            "removes the cap; MPI_TPU_NBC_SM_MAX_BYTES seeds it"),
        "fault_detect_timeout_s": (
            lambda: _ft._DETECT_TIMEOUT_S,
            _set_positive(_ft, "_DETECT_TIMEOUT_S", "fault_detect_timeout_s"),
            "failure-detection bound: a peer whose heartbeat is stale "
            "this long is declared dead; read at ft.enable()"),
        "fault_heartbeat_interval_s": (
            lambda: _ft._HEARTBEAT_S,
            _set_positive(_ft, "_HEARTBEAT_S", "fault_heartbeat_interval_s"),
            "how often each fault-tolerant rank beats and scans its "
            "peers; keep well below fault_detect_timeout_s; read at "
            "ft.enable()"),
        "epoch_grace_s": (
            lambda: _socket._EPOCH_GRACE_S, _set_epoch_grace,
            "how long a peer's newer membership epoch is tolerated (socket "
            "hello acks and shm readiness stamps) before this process is "
            "declared a stale straggler (EpochSkewError)"),
        "shm_write_timeout_s": (
            lambda: _shm._WRITE_TIMEOUT,
            _set_positive(_shm, "_WRITE_TIMEOUT", "shm_write_timeout_s"),
            "shm transport no-progress stall bound: a ring write (full "
            "ring, nobody draining) or mid-frame read with no progress for "
            "this long declares the peer dead (TransportError); the "
            "fault detector should fire far earlier"),
        "coll_sm_arena_bytes": (
            lambda: _sm._ARENA_BYTES, _set_sm_arena,
            "size of each shm communicator's collective arena: P flag "
            "lines + P data slots; a rank's slot is the P-th share, the "
            "ceiling of the in-place block paths.  0 disables the arena.  "
            "Read at arena creation"),
        "coll_sm_eager_bytes": (
            lambda: _sm._EAGER_BYTES, _set_sm_eager,
            "flat-path gate of the arena reductions: payloads at or below "
            "this are folded whole from every peer's slot; above it "
            "allreduce folds per chunk in place and reduce takes the "
            "binomial tree"),
        "compress_wire_dtype": (
            lambda: _compress._WIRE_DTYPE, _set_wire_dtype,
            "wire encoding the plain algorithm='compressed' spelling "
            "resolves to: 'bf16' (2 bytes/elem) or 'int8' (per-segment "
            "max-abs scale + int8 mantissas).  Folds stay float32 "
            "(float64 payloads float64).  Must agree across the group"),
        "compress_topk_ratio": (
            lambda: _compress._TOPK_RATIO, _set_topk_ratio,
            "fraction of gradient entries algorithm='compressed:topk' "
            "sends per rank (ceil(ratio*n), >= 1, clamped to n); the "
            "unsent remainder accumulates in the error-feedback residual "
            "(compress.reset_residuals clears).  Must agree across the "
            "group"),
        "tuning_table_path": (
            _tuning.table_path,
            lambda v: _tuning.set_table_path(str(v) if v else None),
            "path of the active per-machine tuning table: measured "
            "(transport, nranks, collective, payload band) -> algorithm "
            "rows that algorithm='auto' consults before the seed "
            "constants.  Empty = no table.  Writing loads and validates "
            "at once; a table measured on another machine loads but never "
            "serves"),
        "link_retry_timeout_s": (
            lambda: _resilience._RETRY_TIMEOUT_S,
            _set_positive(_resilience, "_RETRY_TIMEOUT_S",
                          "link_retry_timeout_s"),
            "socket link-healing budget: a send-path OSError whose peer is "
            "not failure-suspected reconnects with backoff and replays the "
            "unacked frames for up to this many seconds; also the "
            "no-ack-progress bound of a full retained window.  Keep it "
            "below fault_detect_timeout_s.  MPI_TPU_LINK_RETRY_S (the "
            "launcher's --link-retry-timeout) seeds the default"),
        "connect_retry_timeout_s": (
            lambda: _resilience._CONNECT_RETRY_TIMEOUT_S,
            _set_nonneg_s(_resilience, "_CONNECT_RETRY_TIMEOUT_S",
                          "connect_retry_timeout_s (0 = first-failure "
                          "raise)"),
            "initial server-connect retry budget of connect() / "
            "serve.ServerClient and the serve worker's control dial: a "
            "refused or timed-out dial is retried with backoff and jitter "
            "for this long (a serve --addr-file still being published is "
            "waited for as long).  0 restores first-failure raise.  "
            "MPI_TPU_CONNECT_RETRY_S seeds the default"),
        "link_keepalive_s": (
            lambda: _resilience._KEEPALIVE_S,
            _set_nonneg_s(_resilience, "_KEEPALIVE_S",
                          "link_keepalive_s (0 = no probing)"),
            "idle socket links that sent nothing for this long are probed "
            "with a header-only ack frame, so a link torn while idle heals "
            "before the next send; 0 disables probing"),
        "verify_stall_timeout_s": (
            lambda: _vstate._STALL_TIMEOUT_S, _set_verify_stall,
            "runtime-verifier stall bound: a verified blocking wait stuck "
            "this long publishes its pending op out of band and runs the "
            "wait-for deadlock analysis; a proven cross-rank cycle or knot "
            "raises DeadlockError naming every rank, its pending op and "
            "its call site.  Read at verify.enable()"),
    })


def cvar_list() -> Dict[str, str]:
    """name -> description (MPI_T_cvar_get_info)."""
    _builtin_cvars()
    return {k: v[2] for k, v in sorted(_CVARS.items())}


def cvar_read(name: str) -> Any:
    _builtin_cvars()
    try:
        return _CVARS[name][0]()
    except KeyError:
        raise KeyError(f"unknown cvar {name!r}; have "
                       f"{sorted(_CVARS)}") from None


def cvar_write(name: str, value: Any) -> None:
    _builtin_cvars()
    try:
        _, writer, _ = _CVARS[name]
    except KeyError:
        raise KeyError(f"unknown cvar {name!r}; have "
                       f"{sorted(_CVARS)}") from None
    writer(value)


# -- sessions ----------------------------------------------------------------

class Session:
    """MPI_T session: pvar reads are relative to the session's resets."""

    def __init__(self) -> None:
        self._base: Dict[str, int] = {}

    def read(self, name: str) -> int:
        return pvar_read(name) - self._base.get(name, 0)

    def reset(self, name: str) -> None:
        self._base[name] = pvar_read(name)

    def reset_all(self) -> None:
        for name in pvar_list():
            self.reset(name)


def session_create() -> Session:
    """MPI_T_pvar_session_create."""
    return Session()
