"""Prometheus text rendering for the serve metrics endpoint — the port's
own copy of ``mpi_tpu/telemetry/metrics.py`` (``_fmt`` :35,
``render_histogram`` :39, ``prometheus_text`` :51).

Pure functions from a ``WorldServer.stats()`` document (plus the mpit
histogram pvars) to Prometheus exposition format, so the HTTP endpoint
in ``serve.py`` is a small thread and the rendering is testable without
a server.  The metric names are the reference's (``mpi_tpu_serve_*``,
``mpi_tpu_lease_acquire_seconds``): for the same stats document and the
same histogram the text is the reference's byte for byte.  Counters get
``_total``, histograms emit ``_bucket{le=...}`` + ``_sum`` + ``_count``,
labels carry the per-worker rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import mpit as _mpit

# stats() keys rendered as monotone counters (name -> _total metric)
_COUNTER_KEYS = ("leases_granted", "leases_denied", "jobs_ok",
                 "jobs_failed", "heals_completed", "workers_lost",
                 "busy_rejected", "orphans_reregistered",
                 "pools_adopted", "pools_relinquished")

# stats() keys rendered as gauges
_GAUGE_KEYS = ("epoch", "pool_size", "idle", "leases_active",
               "worlds_per_s", "uptime_s", "waiting", "max_pending")

# federation roll-up keys (stats()["federation"]) rendered as gauges
_FED_GAUGE_KEYS = ("servers_total", "servers_live", "worlds_per_s",
                   "workers", "idle", "pools", "leases_active",
                   "waiting", "leader_term")

_PREFIX = "mpi_tpu_serve"


def _fmt(v) -> str:
    return repr(float(v)) if isinstance(v, float) else str(int(v))


def render_histogram(name: str, metric: str,
                     lines: List[str]) -> None:
    """One mpit histogram pvar as a Prometheus histogram series."""
    snap = _mpit.pvar_hist_read(name)
    lines.append(f"# TYPE {metric} histogram")
    for le, cum in _mpit.hist_cumulative(name):
        lines.append(f'{metric}_bucket{{le="{le:.9g}"}} {cum}')
    lines.append(f'{metric}_bucket{{le="+Inf"}} {snap["count"]}')
    lines.append(f"{metric}_sum {snap['sum_s']:.9g}")
    lines.append(f"{metric}_count {snap['count']}")


def prometheus_text(stats: Dict,
                    hists: Optional[Dict[str, str]] = None) -> str:
    """Render a serve stats document (see ``WorldServer.stats()``) as
    Prometheus exposition text.  ``hists`` maps mpit histogram pvar
    names to metric names; the default exports the lease-acquire
    distribution (the p50/p99 the acceptance names)."""
    lines: List[str] = []
    for key in _GAUGE_KEYS:
        if key in stats:
            metric = f"{_PREFIX}_{key}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {_fmt(stats[key])}")
    for key in _COUNTER_KEYS:
        if key in stats:
            metric = f"{_PREFIX}_{key}_total"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {_fmt(stats[key])}")
    workers = stats.get("workers") or {}
    if workers:
        metric = f"{_PREFIX}_worker_state"
        lines.append(f"# TYPE {metric} gauge")
        for slot, state in sorted(workers.items()):
            lines.append(
                f'{metric}{{slot="{slot}",state="{state}"}} 1')
    healing = stats.get("healing")
    if healing is not None:
        metric = f"{_PREFIX}_healing_slots"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {len(healing)}")
    # multi-pool detail: per-pool epoch and worker states, labeled by
    # pool id, so a scrape tells the home pool from adopted ones
    pools = stats.get("pools") or {}
    if len(pools) > 1 or any(not p.get("home") for p in pools.values()):
        metric = f"{_PREFIX}_pool_epoch"
        lines.append(f"# TYPE {metric} gauge")
        for pid, p in sorted(pools.items()):
            home = "true" if p.get("home") else "false"
            lines.append(f'{metric}{{pool="{pid}",home="{home}"}} '
                         f'{_fmt(p.get("epoch", 0))}')
        metric = f"{_PREFIX}_pool_worker_state"
        lines.append(f"# TYPE {metric} gauge")
        for pid, p in sorted(pools.items()):
            for slot, state in sorted((p.get("workers") or {}).items()):
                lines.append(f'{metric}{{pool="{pid}",slot="{slot}",'
                             f'state="{state}"}} 1')
    if stats.get("is_leader") is not None:
        metric = f"{_PREFIX}_is_leader"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {1 if stats['is_leader'] else 0}")
    # federation namespace roll-up: the endpoint stays truthful when
    # pools move between servers
    fed = stats.get("federation")
    if fed:
        for key in _FED_GAUGE_KEYS:
            if key in fed:
                metric = f"mpi_tpu_fed_{key}"
                lines.append(f"# TYPE {metric} gauge")
                lines.append(f"{metric} {_fmt(fed[key])}")
        metric = "mpi_tpu_fed_server_live"
        lines.append(f"# TYPE {metric} gauge")
        for sid, rec in sorted((fed.get("servers") or {}).items()):
            leader = "true" if rec.get("is_leader") else "false"
            lines.append(
                f'{metric}{{server="{sid}",leader="{leader}"}} '
                f'{1 if rec.get("live") else 0}')
    # aggregated worker pvars (piggybacked on job_done replies and the
    # idle push): link reconnects, arena hits, detected failures, summed
    # over the latest snapshot of each slot
    agg = stats.get("worker_pvars") or {}
    if agg:
        metric = "mpi_tpu_worker_pvar"
        lines.append(f"# TYPE {metric} gauge")
        for name in sorted(agg):
            lines.append(f'{metric}{{name="{name}"}} {_fmt(agg[name])}')
    for name, metric in (hists if hists is not None
                         else {"lease_acquire_s":
                               "mpi_tpu_lease_acquire_seconds"}).items():
        render_histogram(name, metric, lines)
    # the quantile gauges, estimated from the log buckets (see
    # mpit.hist_quantile's error bound)
    for q, label in ((0.5, "p50"), (0.99, "p99")):
        est = _mpit.hist_quantile("lease_acquire_s", q)
        if est is not None:
            metric = f"{_PREFIX}_lease_acquire_{label}_seconds"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {est:.9g}")
    return "\n".join(lines) + "\n"
