"""Master/worker task farm — the canonical dynamic MPI-1 pattern [S].

The port's copy of ``examples/master_worker.py``.  Rank 0 hands out work
items one at a time; whichever worker returns a result first gets the
next item (self-balancing under uneven task costs), with tags and
``api.MPI_Waitany``.  It is rank-dynamic (the master branches on which
worker answered), so it runs on the host backends only (local, socket,
shm), never as one SPMD program.

Each task's value is computed on the worker's device: a float64 sum of
``sin(x k) / k`` over ``k = 1 .. 50 (x mod 7 + 1) - 1`` (uneven cost, as
the reference's), returned to the master as a 0-d tensor that stays on
the card under a card world.  The reference sums the same terms in a
Python loop, so the two agree to float64 rounding, not bitwise.

Run::

    python -m mpi_tpu_torch.launcher -n 4 mpi_tpu_torch/examples/master_worker.py
    python -m mpi_tpu_torch.launcher -n 4 --device cpu mpi_tpu_torch/examples/master_worker.py
    python -m mpi_tpu_torch.examples.master_worker --backend local -n 4 --device cpu
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

TAG_WORK, TAG_RESULT, TAG_STOP = 1, 2, 3


def _task(x: int, device=None) -> torch.Tensor:
    """Task ``x``'s value on ``device`` (0-d float64; uneven cost)."""
    k = torch.arange(1, 50 * (x % 7 + 1), dtype=torch.float64, device=device)
    return (torch.sin(x * k) / k).sum()


def run(comm, n_tasks: int = 40) -> Optional[List[torch.Tensor]]:
    """Returns (on rank 0) the list of all task results, task-indexed;
    None on the workers."""
    from mpi_tpu_torch.api import MPI_Waitany

    if comm.size < 2:
        return [_task(i, comm.device) for i in range(n_tasks)]

    if comm.rank == 0:
        results: List[Optional[torch.Tensor]] = [None] * n_tasks
        next_task = 0
        # prime each worker with one item; surplus workers (more workers
        # than tasks) are stopped at once and get NO result irecv: a
        # pending receive from a stopped worker could never complete
        primed = []
        for w in range(1, comm.size):
            if next_task < n_tasks:
                comm.send(next_task, dest=w, tag=TAG_WORK)
                next_task += 1
                primed.append(w)
            else:
                comm.send(None, dest=w, tag=TAG_STOP)
        # one outstanding irecv per active worker; Waitany picks whichever
        # finishes first, and its slot maps back through `primed`
        reqs = [comm.irecv(source=w, tag=TAG_RESULT) for w in primed]
        outstanding = len(primed)
        while outstanding:
            i, (task_id, value) = MPI_Waitany(reqs)
            results[task_id] = value
            worker = primed[i]
            if next_task < n_tasks:
                comm.send(next_task, dest=worker, tag=TAG_WORK)
                next_task += 1
                reqs[i] = comm.irecv(source=worker, tag=TAG_RESULT)
            else:
                comm.send(None, dest=worker, tag=TAG_STOP)
                outstanding -= 1
        return results

    from mpi_tpu_torch import ANY_TAG, Status

    while True:  # task ids arrive with TAG_WORK until a TAG_STOP
        status = Status()
        item = comm.recv(source=0, tag=ANY_TAG, status=status)
        if status.tag == TAG_STOP:
            return None
        comm.send((item, _task(item, comm.device)), dest=0, tag=TAG_RESULT)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default=None,
                    help="local (rank threads); default: the launcher's")
    ap.add_argument("-n", "--nranks", type=int, default=None)
    ap.add_argument("--tasks", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="'cpu' without a card (default: the card)")
    args = ap.parse_args(argv)

    import mpi_tpu_torch

    if args.backend in (None, "socket", "shm"):
        comm = mpi_tpu_torch.init(args.backend, device=args.device)
        res = run(comm, args.tasks)
        if comm.rank == 0:
            print(f"master_worker: {sum(r is not None for r in res)}/"
                  f"{args.tasks} tasks done, sum={float(sum(res)):.4f}")
        mpi_tpu_torch.finalize()
    elif args.backend == "local":
        res = mpi_tpu_torch.run(lambda c: run(c, args.tasks), backend="local",
                                nranks=args.nranks, device=args.device)[0]
        print(f"master_worker: {sum(r is not None for r in res)}/"
              f"{args.tasks} tasks done, sum={float(sum(res)):.4f}")
    else:
        raise SystemExit(
            f"master_worker runs on the host backends (local, socket, shm), "
            f"not {args.backend!r}: it is rank-dynamic by design")


if __name__ == "__main__":
    main()
