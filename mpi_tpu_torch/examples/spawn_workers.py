"""Dynamic process management: a master grows its own worker pool.

The port's copy of ``examples/spawn_workers.py``.  The master world
spawns a fresh worker world at run time (``spawn.comm_spawn``), scatters
work over the parent-child intercommunicator and reduces the partial
results — no launcher restart, the job resizes itself.

Worker ``j`` draws the reference's samples (numpy ``default_rng(j)``,
``n`` points in the unit square), moves them to its device and counts the
points inside the quarter circle there; it returns the count as a 0-d
int64 tensor, which arrives on the master's device, with its device's
type.  The worker world also allreduces the counts, and its rank 0 sends
the total.  The counts equal the reference's (the same float64 products
and sums of two squares), so the estimate does too.

Workers run on the card (child ``r`` on card ``r % device_count``) unless
the master's environment carries ``MPI_TPU_DEVICE`` (the launcher's
``--device cpu`` sets it).  Run::

    python -m mpi_tpu_torch.launcher -n 1 mpi_tpu_torch/examples/spawn_workers.py
    python -m mpi_tpu_torch.launcher -n 1 --device cpu mpi_tpu_torch/examples/spawn_workers.py
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

import mpi_tpu_torch
from mpi_tpu_torch import spawn

NWORKERS = 3
SAMPLES = 40_000


def reference_hits(seed: int, n: int) -> int:
    """Worker ``seed``'s count as the reference computes it, in numpy."""
    xy = np.random.default_rng(seed).random((n, 2))
    return int(((xy * xy).sum(axis=1) <= 1.0).sum())


def master(comm, nworkers: int = NWORKERS,
           samples: int = SAMPLES) -> Optional[dict]:
    """Collective over ``comm``: spawn ``nworkers`` workers running this
    file, scatter one work item to each from rank 0, gather the counts.
    Returns (on rank 0) ``{"pi", "hits", "total", "per_worker",
    "world_total", "devices"}``; None elsewhere."""
    inter = spawn.comm_spawn([os.path.abspath(__file__)], nworkers,
                             comm=comm)
    out = None
    if comm.rank == 0:
        for j in range(nworkers):
            inter.send(("pi-samples", samples, j), dest=j)
        per_worker, devices = [], []
        hits, total = 0, 0
        for j in range(nworkers):
            h, n, dev = inter.recv(source=j)
            per_worker.append(int(h))
            devices.append(dev)
            hits, total = hits + int(h), total + n
        world_total = int(inter.recv(source=0))
        out = {"pi": 4.0 * hits / total, "hits": hits, "total": total,
               "per_worker": per_worker, "world_total": world_total,
               "devices": devices}
    comm.barrier()  # workers answered before rank 0 releases the world
    inter.free()
    return out


def worker() -> None:
    """The spawned side: one work item from the master, counted on this
    worker's device."""
    comm = mpi_tpu_torch.COMM_WORLD   # the worker world
    parent = spawn.comm_get_parent()
    kind, n, seed = parent.recv(source=0)
    assert kind == "pi-samples"
    dev = comm.device
    xy = torch.from_numpy(np.random.default_rng(seed).random((n, 2))).to(dev)
    hits = ((xy * xy).sum(dim=1) <= 1.0).sum()
    total = comm.allreduce(hits)       # a worker-world collective
    parent.send((hits, n, dev.type), dest=0)
    if comm.rank == 0:
        parent.send(total, dest=0)


def main() -> None:
    if spawn.comm_get_parent() is not None:
        worker()
        return
    comm = mpi_tpu_torch.COMM_WORLD
    got = master(comm)
    if comm.rank == 0:
        want = sum(reference_hits(j, SAMPLES) for j in range(NWORKERS))
        assert got["hits"] == got["world_total"] == want, (got, want)
        print(f"master: pi ~= {got['pi']:.6f} from {got['total']} samples "
              f"across {NWORKERS} spawned workers on {got['devices']}")


if __name__ == "__main__":
    main()
