"""Socket ranks under the flight recorder.  Run under the launcher with
``--trace-dir``:

    python -m mpi_tpu_torch.launcher -n 4 --trace-dir TRACES mpi_tpu_torch/examples/host_trace.py --out DIR
    python -m mpi_tpu_torch.tools.tracecat TRACES -o merged.json

Every rank runs a ring allreduce of ``--mib`` MiB of float32 (checked
against a float64 sum), then each other host collective once at
``--small-mib`` MiB (bcast, reduce, allgather, alltoall, barrier, scan,
reduce_scatter, scatter, gather), and exits through ``finalize``, which
exports its Chrome trace into TRACES.  For every call the rank keeps the
collective's span from its recorder (host time) beside the wall of the
same call followed by a device synchronize: on the card a span ends when
the host call returns, and the device work it queued may run on after.
Each rank writes ``DIR/rank<r>.json``: those times, the
``coll_latency_s`` quantiles, the recorder's event count and drops, and
``profiling.comm_stats()``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import mpi_tpu_torch
from mpi_tpu_torch import mpit, profiling, telemetry
from mpi_tpu_torch.examples.host_allreduce import _sync, check_allreduce, rank_input


def _span_vs_wall(comm, name: str, call):
    """(result, the span's host ms, the call's ms with a synchronize)."""
    rec = telemetry.REC
    comm.barrier()
    _sync(comm.device)
    t0 = time.perf_counter()
    out = call()
    _sync(comm.device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    span = rec.find("coll", name)[-1]
    return out, span["dur_ns"] / 1e6, wall_ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="directory for rank<r>.json")
    ap.add_argument("--mib", type=int, default=256, help="MiB per rank of the ring")
    ap.add_argument("--small-mib", type=int, default=1,
                    help="MiB per rank of every other collective")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    comm = mpi_tpu_torch.init()
    if telemetry.REC is None or not telemetry.REC.trace_dir:
        raise RuntimeError("run under the launcher with --trace-dir")
    dev, p, r = comm.device, comm.size, comm.rank
    numel = (args.mib << 20) // 4
    x = rank_input(r, numel, args.seed, dev)
    out, span_ms, wall_ms = _span_vs_wall(
        comm, "allreduce", lambda: comm.allreduce(x, algorithm="ring"))
    err = check_allreduce(comm, out, numel, args.seed, range(p))
    rec = {"rank": r, "size": p, "device": str(dev), "bytes_per_rank": numel * 4,
           "allreduce": {"span_ms": span_ms, "wall_sync_ms": wall_ms,
                         "max_abs_err_vs_f64": err}}
    del out, x
    n = (args.small_mib << 20) // 4 // p * p  # p equal blocks
    y = rank_input(r, n, args.seed + 1, dev)
    blocks = y.view(p, -1)
    calls = {
        "bcast": lambda: comm.bcast(y if r == 0 else None, root=0),
        "reduce": lambda: comm.reduce(y, root=0),
        "allgather": lambda: comm.allgather(y[: n // p]),
        "alltoall": lambda: comm.alltoall(blocks),
        "barrier": lambda: comm.barrier(),
        "scan": lambda: comm.scan(y),
        "reduce_scatter": lambda: comm.reduce_scatter(blocks),
        "scatter": lambda: comm.scatter(list(blocks) if r == 0 else None, root=0),
        "gather": lambda: comm.gather(y, root=0),
    }
    times = {}
    for name, call in calls.items():
        _, span_ms, wall_ms = _span_vs_wall(comm, name, call)
        times[name] = {"span_ms": span_ms, "wall_sync_ms": wall_ms}
    rec["small"] = {"bytes_per_rank": n * 4, "calls": times}
    tr = telemetry.REC
    stats = profiling.comm_stats()
    rec["coll_latency_s"] = {"p50": mpit.hist_quantile("coll_latency_s", 0.5),
                             "p99": mpit.hist_quantile("coll_latency_s", 0.99),
                             "count": mpit.pvar_hist_read("coll_latency_s")["count"]}
    rec["events"] = tr.events_total
    rec["dropped"] = tr.dropped
    rec["comm_stats"] = {"ops": stats.ops, "bytes": stats.bytes}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{r}.json"), "w") as f:
        json.dump(rec, f)
    mpi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
