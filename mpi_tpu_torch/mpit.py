"""MPI_T tool interface — the port's own copy of the part of
``mpi_tpu/mpit.py`` the host layer reads.

* Performance variables (pvars): exact, thread-safe counters.  ``count``
  (:126) takes the reference's keyword names; ``pvar_read`` /
  ``pvar_reset`` (:437-445) read them under the reference's pvar names
  (``msgs_sent``, ``bytes_raw_sent``, ``bytes_pickled_sent``,
  ``payload_copies``, the ``link_*`` and ``recv_*`` families; the
  fault-tolerance, progress and nonblocking-collective counters
  ``proc_failures_detected``, ``revokes_delivered``,
  ``shrinks_completed``, ``rejoins_completed``, ``epoch_skews_detected``,
  ``faulty_dropped`` / ``faulty_duplicated``, ``progress_*``,
  ``nbc_threads_spawned``, ``nbc_state_machines``, ``persistent_starts``).
* Control variables (cvars): ``cvar_read`` / ``cvar_write`` (:602-611)
  over the knobs the host layer reads — ``collective_segment_bytes``,
  the two allreduce crossovers, ``recv_steering``, and (:700-1000)
  ``progress``, ``nbc_mode``, ``nbc_fold_workers``, ``nbc_sm_max_bytes``,
  ``fault_detect_timeout_s``, ``fault_heartbeat_interval_s``,
  ``epoch_grace_s`` and ``link_keepalive_s``, with the reference's
  defaults and validation.

Sessions and histogram pvars are not ported yet (ROADMAP item 16.3).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Tuple

__all__ = ["count", "pvar_list", "pvar_read", "pvar_reset", "cvar_list",
           "cvar_read", "cvar_write"]

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
}

_counters: Dict[str, int] = {name: 0 for name in _PVAR_OF.values()}


def count(**deltas: int) -> None:
    """Thread-safe increment (the local backend's rank threads share this
    process's counters).  Keywords are the reference's ``count`` names."""
    with _lock:
        for key, n in deltas.items():
            if n:
                _counters[_PVAR_OF[key]] += n


def pvar_list() -> List[str]:
    """MPI_T_pvar_get_info over all indices: the variable names."""
    return sorted(_counters)


def pvar_read(name: str) -> int:
    """Absolute (process-lifetime) value of a performance variable."""
    try:
        return _counters[name]
    except KeyError:
        raise KeyError(f"unknown pvar {name!r}; have {pvar_list()}") from None


def pvar_reset(name: str) -> int:
    """The current value, to subtract from later reads (MPI_T puts the
    reset itself in a session)."""
    return pvar_read(name)


# -- control variables -------------------------------------------------------

_CVARS: Dict[str, Tuple[Callable[[], Any], Callable[[Any], None], str]] = {}


def _builtin_cvars() -> None:
    """Registered lazily: the communicator and recvpool modules import
    this one, so their knobs are looked up at first use."""
    if _CVARS:
        return
    from . import communicator as _c
    from . import ft as _ft
    from . import nbc as _nbc
    from . import progress as _prog
    from . import recvpool as _recvpool
    from . import resilience as _resilience
    from .transport import socket as _socket

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
            lambda: _socket._EPOCH_GRACE_S,
            _set_nonneg_s(_socket, "_EPOCH_GRACE_S", "epoch_grace_s"),
            "how long a peer's newer membership epoch is tolerated in the "
            "socket hello before this process is declared a stale "
            "straggler (EpochSkewError)"),
        "link_keepalive_s": (
            lambda: _resilience._KEEPALIVE_S,
            _set_nonneg_s(_resilience, "_KEEPALIVE_S",
                          "link_keepalive_s (0 = no probing)"),
            "idle socket links that sent nothing for this long are probed "
            "with a header-only ack frame, so a link torn while idle heals "
            "before the next send; 0 disables probing"),
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
