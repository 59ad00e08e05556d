"""The process-wide tuned-dispatch resolver — the port's own copy of
``mpi_tpu/tuning/resolver.py`` (``set_table_path`` :50, the lazy
``MPI_TPU_TUNING_TABLE`` read :95, ``last_decision`` :125, ``explain``
:140, ``pick`` :163).

``pick`` is the one call every ``algorithm="auto"`` decision point makes
(the communicator's allreduce / reduce_scatter / alltoall, the
nonblocking allreduce plan, and the arena's ``sm_allreduce`` /
``sm_reduce`` gates): given (transport, group size, collective, payload
bytes) it returns the active table's algorithm — counted in
``tuned_table_hits`` — or None, the seed policy, counted in
``tuned_table_fallbacks``.  With no table every decision is a fallback and
the behaviour is the seed constants'.

Activation: the ``tuning_table_path`` cvar, ``MPI_TPU_TUNING_TABLE`` (read
lazily, once), ``run(..., backend="local", tuning_table=)`` or the
launcher's ``--tuning-table``.  A table whose machine fingerprint does not
match this host loads but never serves (``reason`` says why).  The table
must agree across the group.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional, Sequence

from .. import mpit as _mpit
from .table import TuningTable, TuningTableError, fingerprint

ENV_TABLE = "MPI_TPU_TUNING_TABLE"

_lock = threading.Lock()
_path: Optional[str] = None
_table: Optional[TuningTable] = None
_reason: Optional[str] = None  # why the configured table is not serving
_env_done = False
_last: Optional[Dict] = None


def set_table_path(path: Optional[str]) -> None:
    """Load ``path`` as the process's active tuning table (strict: a
    malformed table raises :class:`TuningTableError` and leaves the
    previous table in place).  ``None``/"" clears the table — every
    auto decision falls back to the seed constants again."""
    global _path, _table, _reason, _env_done
    if not path:
        with _lock:
            _path, _table, _reason, _env_done = None, None, None, True
        return
    tab = TuningTable.load(path)  # outside the lock; may raise
    reason = None
    if not tab.matches_machine():
        fp = fingerprint()
        reason = (f"fingerprint mismatch: table measured on "
                  f"{tab.fingerprint.get('hostname')!r}/"
                  f"{tab.fingerprint.get('cpu_count')}cpu, this machine is "
                  f"{fp['hostname']!r}/{fp['cpu_count']}cpu — falling back "
                  f"to seed constants (re-run python -m mpi_tpu_torch.tools.tune here)")
    with _lock:
        _path, _table, _reason, _env_done = path, tab, reason, True


def table_path() -> str:
    """The configured table path ('' when none) — the cvar's reader."""
    _ensure_env()
    with _lock:
        return _path or ""


def reason() -> Optional[str]:
    """Why the configured table is not serving (None when it is, or
    when no table is configured)."""
    _ensure_env()
    with _lock:
        return _reason


def active_table() -> Optional[TuningTable]:
    """The table picks are served from: loaded AND fingerprint-matched."""
    _ensure_env()
    with _lock:
        return None if _reason is not None else _table


def _ensure_env() -> None:
    """Lazy init from MPI_TPU_TUNING_TABLE.  Unlike the strict cvar
    writer this must never kill world creation: a bad env-named table
    is reported on stderr and recorded in `reason`.  ``_env_done``
    flips only AFTER the table is configured — rank threads race into
    their first pick concurrently, and an early flip would hand the
    losers a fallback on a world the env var meant to tune (duplicate
    loads in that window are idempotent and harmless)."""
    global _env_done, _path, _reason
    with _lock:
        if _env_done:
            return
        path = os.environ.get(ENV_TABLE)
        if not path:
            _env_done = True
            return
    try:
        set_table_path(path)  # flips _env_done under its lock
    except TuningTableError as e:
        with _lock:
            _path, _env_done = path, True
            _reason = f"table from ${ENV_TABLE} rejected: {e}"
        sys.stderr.write(f"mpi_tpu_torch.tuning: {_reason}\n")


def _record(decision: Dict) -> None:
    global _last
    with _lock:
        _last = decision


def last_decision() -> Optional[Dict]:
    """The most recent `pick` outcome UNDER AN ACTIVE TABLE:
    ``{"collective", "transport", "nranks", "nbytes", "algorithm",
    "source"}`` where source is ``"table:trusted"``,
    ``"table:untrusted"`` or ``"seed"`` (algorithm None for seed — no
    row matched, the caller's constants decided).  With no active
    table, picks take the recording-free fast path and this keeps the
    last recorded decision (use `explain` for hypotheticals)."""
    with _lock:
        return dict(_last) if _last is not None else None


def explain(transport: str, nranks: int, collective: str,
            nbytes: int) -> Dict:
    """What `pick` WOULD decide for one request, without counting it —
    the introspection entry point (README "Tuned dispatch")."""
    tab = active_table()
    row = (tab.match(transport, nranks, collective, nbytes)
           if tab is not None else None)
    return {
        "collective": collective, "transport": transport,
        "nranks": nranks, "nbytes": int(nbytes),
        "algorithm": None if row is None else row.algorithm,
        "source": ("seed" if row is None
                   else "table:trusted" if row.trusted
                   else "table:untrusted"),
        "row": None if row is None else row.as_dict(),
        "table": None if tab is None else tab.path,
        "inactive_reason": reason(),
    }


def pick(comm, collective: str, nbytes: int,
         allowed: Sequence[str]) -> Optional[str]:
    """The dispatch consult: the matching row's algorithm when the
    active table has one AND it is applicable here (``allowed`` — the
    caller's real algorithm set for this group: e.g. no
    recursive_halving on non-pow2 groups, no "sm" off the shm
    transport), else None = run the seed policy.  Exactly one of
    ``tuned_table_hits`` / ``tuned_table_fallbacks`` is counted per
    consult."""
    # The no-table fast path (the overwhelmingly common one): a
    # LOCK-FREE read of the module cells — _env_done flips exactly once
    # and _table is written before it under the lock, so a stale read
    # only ever sends a racer down the slow path, never past a
    # configured table.  One counter tick, no decision record —
    # last_decision()/explain() describe ACTIVE-table resolution, and
    # taking the resolver lock (twice) plus a dict allocation here
    # would tax a path that used to be a constant comparison.
    if _env_done and _table is None:
        _mpit.count(tuned_table_fallbacks=1)
        return None
    tab = active_table()
    if tab is None:  # inactive (fingerprint mismatch / env rejection)
        _mpit.count(tuned_table_fallbacks=1)
        return None
    transport = getattr(comm._t, "tuning_transport", None)
    nranks = comm.size
    row = None
    if transport is not None:
        row = tab.match(transport, nranks, collective, int(nbytes))
        if row is not None and row.algorithm not in allowed:
            row = None
    if row is not None:
        _mpit.count(tuned_table_hits=1)
        _record({"collective": collective, "transport": transport,
                 "nranks": nranks, "nbytes": int(nbytes),
                 "algorithm": row.algorithm,
                 "source": ("table:trusted" if row.trusted
                            else "table:untrusted")})
        return row.algorithm
    _mpit.count(tuned_table_fallbacks=1)
    _record({"collective": collective, "transport": transport,
             "nranks": nranks, "nbytes": int(nbytes),
             "algorithm": None, "source": "seed"})
    return None


def _reset_for_tests() -> None:
    """Drop every module-level cell (tests only)."""
    global _path, _table, _reason, _env_done, _last
    with _lock:
        _path = _table = _reason = _last = None
        _env_done = False


__all__ = ["ENV_TABLE", "set_table_path", "table_path", "reason",
           "active_table", "pick", "explain", "last_decision"]
