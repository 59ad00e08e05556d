"""MPI_T tool interface — the port's own copy of the part of
``mpi_tpu/mpit.py`` the host layer reads.

* Performance variables (pvars): exact, thread-safe counters.  ``count``
  (:126) takes the reference's keyword names; ``pvar_read`` /
  ``pvar_reset`` (:437-445) read them under the reference's pvar names
  (``msgs_sent``, ``bytes_raw_sent``, ``bytes_pickled_sent``,
  ``payload_copies``, the ``link_*`` and ``recv_*`` families).
* Control variables (cvars): ``cvar_read`` / ``cvar_write`` (:602-611)
  over the knobs this slice steers — ``collective_segment_bytes``, the
  two allreduce crossovers and ``recv_steering``.

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
    from . import recvpool as _recvpool

    def _set_nonneg(attr: str, what: str):
        def write(v):
            if int(v) < 0:
                raise ValueError(f"{what} must be >= 0")
            setattr(_c, attr, int(v))
        return write

    def _set_steering(v):
        _recvpool._STEERING = 1 if int(v) else 0

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
