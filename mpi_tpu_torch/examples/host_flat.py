"""Hierarchical dispatch and the flat MPI layer as rank processes, checked
and timed.  Run under the launcher, one process per rank, on the shm
transport::

    python -m mpi_tpu_torch.launcher -n 4 --backend shm --tuning-table T \\
        mpi_tpu_torch/examples/host_flat.py --out DIR
    python -m mpi_tpu_torch.launcher -n 4 --backend shm --device cpu \\
        mpi_tpu_torch/examples/host_flat.py --out DIR --mib 4

Every rank draws its float32 input of ``--mib`` MiB from ``(--seed,
rank)`` on its device, and runs, each leg timed (a barrier and a
synchronize before, a synchronize before the clock stops):

1. ``HierarchicalComm(comm, node_key=lambda r: r // 2)``, 2 nodes of 2
   ranks: allreduce, bcast (root 3), reduce (root 2) and allgather, each
   on the card and again with the input as a CPU tensor, bitwise equal
   (a CPU payload travels to the receiving rank's device, as every
   payload does, and the folds run on the result's device: the second
   run holds the card's result against host-made inputs and host
   copies, not against a CPU-only world; phase 13 and the tests hold
   that); the allreduce within rtol 1e-5, atol 1e-5 of a float64 sum.  Each tier's
   ``tuned_table_hits`` / ``tuned_table_fallbacks`` are counted per call
   (one consult per level and rank: the table, if given, pins the
   leaders' 2-rank allreduce);
2. the three-level form (NUMA ``r % 2`` inside each node): allreduce and
   allgather, bitwise against the same calls on CPU inputs;
3. ``examples.master_worker`` on the world, 40 tasks: the results on the
   rank's device, each within atol 1e-12 of the serial computation on the
   CPU;
4. an ``InterComm`` of the two halves: allreduce of the remote half,
   bitwise against the same call on CPU inputs;
5. a partitioned ``psend_init`` / ``precv_init`` of the input in 8
   partitions from rank 0 to rank 1 (and 2 to 3), readied by 4 producer
   threads, each partition refilled right after its ``pready``: the
   receiver gets the input, bitwise;
6. 10 rounds of ``api.MPI_Allreduce_init`` over a buffer refilled in place
   between rounds: each round bitwise against the same round on CPU
   inputs.

Each rank writes ``DIR/rank<r>.json``; a failed check raises, so the rank
(and the launcher) exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import torch

import mpi_tpu_torch
from mpi_tpu_torch import api, mpi4, mpit, topology
from mpi_tpu_torch.examples import master_worker
from mpi_tpu_torch.examples.host_allreduce import rank_input

PVARS = ("tuned_table_hits", "tuned_table_fallbacks")


def _tap(comm, level: str, counts: dict) -> None:
    """Count the tuned-resolver consults of ``comm``'s collectives under
    ``level`` (an instance attribute over each bound method; a collective
    that calls another of the same communicator counts once)."""
    if comm is None:
        return
    depth = [0]
    for name in ("reduce", "allreduce", "bcast", "gather", "allgather"):
        fn = getattr(comm, name)

        def counted(*args, _fn=fn, **kwargs):
            depth[0] += 1
            before = [mpit.pvar_read(p) for p in PVARS]
            try:
                return _fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    got = counts.setdefault(level, [0, 0])
                    for i, p in enumerate(PVARS):
                        got[i] += mpit.pvar_read(p) - before[i]

        setattr(comm, name, counted)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tasks", type=int, default=40)
    args = ap.parse_args(argv)

    comm = mpi_tpu_torch.init()
    n, r, dev = comm.size, comm.rank, comm.device
    if n != 4:
        raise SystemExit("run with -n 4")
    card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if card else (lambda: None)
    numel = (args.mib << 20) // 4
    x = rank_input(r, numel, args.seed, dev)
    x_cpu = x.cpu()
    info = {"rank": r, "device": str(dev), "bytes_per_rank": numel * 4,
            "legs": {}}

    def timed(name, fn):
        comm.barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        info["legs"][name] = {"ms": (time.perf_counter() - t0) * 1e3}
        return out

    def check(name, ok, **extra):
        info["legs"][name].update(ok=bool(ok), **extra)
        if not ok:
            raise RuntimeError(f"rank {r}: {name} failed its check {extra}")

    want = torch.zeros(numel, dtype=torch.float64, device=dev)
    for q in range(n):
        want += rank_input(q, numel, args.seed, dev).double()
    want = want.cpu()

    # 1. two-level hierarchical collectives, card against CPU
    h = topology.HierarchicalComm(comm, node_key=lambda q: q // 2)
    consults: dict = {}
    _tap(h.intra, "intra", consults)
    _tap(h.leaders, "leaders", consults)
    calls = {
        "allreduce": lambda v: h.allreduce(v),
        "bcast": lambda v: h.bcast(v if r == 3 else None, root=3),
        "reduce": lambda v: h.reduce(v, root=2),
        "allgather": lambda v: h.allgather(v[: numel // n]),
    }
    for name, call in calls.items():
        before = {k: list(v) for k, v in consults.items()}
        got = timed(f"hier {name}", lambda: call(x))
        # [tuned_table_hits, tuned_table_fallbacks] of each tier, this call
        extra = {"consults": {k: [v[0] - before.get(k, [0, 0])[0],
                                  v[1] - before.get(k, [0, 0])[1]]
                              for k, v in consults.items()}}
        cpu = call(x_cpu)
        same = (got is None and cpu is None) or torch.equal(got.cpu(), cpu.cpu())
        if name == "allreduce":
            extra["max_abs_err_vs_f64"] = float((got.cpu().double() - want).abs().max())
            same = same and torch.allclose(got.cpu().double(), want, rtol=1e-5, atol=1e-5)
        check(f"hier {name}", same and (got is None or got.device == dev), **extra)

    # 2. the three-level form
    h3 = topology.HierarchicalComm(comm, node_key=lambda q: q // 2,
                                   numa_key=lambda q: q % 2)
    for name, call in (("allreduce", lambda v: h3.allreduce(v)),
                       ("allgather", lambda v: h3.allgather(v[: numel // n]))):
        got = timed(f"hier3 {name}", lambda: call(x))
        check(f"hier3 {name}", torch.equal(got.cpu(), call(x_cpu).cpu()))

    # 3. master/worker on the world
    res = timed("master_worker", lambda: master_worker.run(comm, args.tasks))
    if r == 0:
        err = max(float((a.cpu() - master_worker._task(i)).abs())
                  for i, a in enumerate(res))
        check("master_worker", len(res) == args.tasks and err <= 1e-12
              and all(a.device == dev for a in res), max_abs_err=err)
    else:
        check("master_worker", res is None)

    # 4. an intercommunicator of the two halves
    ic = mpi_tpu_torch.create_intercomm(comm, [0, 1], [2, 3])
    got = timed("intercomm allreduce", lambda: ic.allreduce(x))
    check("intercomm allreduce", torch.equal(got.cpu(), ic.allreduce(x_cpu).cpu()))

    # 5. partitioned point-to-point from producer threads
    parts = 8

    def partitioned():
        if r % 2 == 0:
            buf = x.clone().view(parts, -1)
            req = mpi4.psend_init(comm, buf, parts, dest=r + 1, tag=8).start()

            def producer(ids):
                for i in ids:
                    req.pready(i)
                    buf[i].fill_(-1.0)  # refilled right after its pready

            ts = [threading.Thread(target=producer, args=(range(k, parts, 4),))
                  for k in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            req.wait()
            return None
        return mpi4.precv_init(comm, parts, source=r - 1, tag=8).start().wait()

    got = timed("partitioned 8 parts", partitioned)
    if r % 2:
        src = rank_input(r - 1, numel, args.seed, dev).cpu().view(parts, -1)
        check("partitioned 8 parts", torch.equal(torch.stack([p.cpu() for p in got]), src)
              and all(p.device == dev for p in got))
    else:
        check("partitioned 8 parts", got is None)

    # 6. persistent allreduce rounds over a buffer refilled in place
    rounds = 10

    def persistent(v0):
        buf = v0.clone()
        handle = api.MPI_Allreduce_init(buf, comm=comm)
        outs = []
        for k in range(rounds):
            buf.copy_(v0).mul_(float(k + 1))
            outs.append(handle.start().wait())
        return outs

    got = timed("MPI_Allreduce_init x10", lambda: persistent(x))
    cpu = persistent(x_cpu)
    check("MPI_Allreduce_init x10", all(torch.equal(a.cpu(), b.cpu())
                                        for a, b in zip(got, cpu)))

    with open(os.path.join(args.out, f"rank{r}.json"), "w") as f:
        json.dump(info, f)
    mpi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
