"""Two independently started programs couple through a port.

The port's copy of ``examples/coupled_models.py``: an "ocean" model and an
"atmosphere" model are SEPARATE jobs (their own launchers, their own
worlds; launch both with the same ``-n``) that find each other through the
name service (``spawn.publish_name`` / ``lookup_name``) and exchange
boundary data every step over the intercommunicator
(``comm_accept`` / ``comm_connect``).  The boundaries are float64 tensors
on each rank's device; a tensor sent over the bridge arrives on the
receiver's device.

The example's own check: each rank replays both models' recurrences in
numpy float64 and requires its final boundary to equal the replay exactly
(elementwise products and sums, the same IEEE operations on either
device).  With ``--out DIR`` each rank writes ``DIR/<role>_rank<r>.json``.
``MPI_TPU_NAMESERVICE`` names the registry directory both jobs share.
Run (two shells, or backgrounded)::

    python -m mpi_tpu_torch.launcher -n 2 mpi_tpu_torch/examples/coupled_models.py ocean &
    python -m mpi_tpu_torch.launcher -n 2 mpi_tpu_torch/examples/coupled_models.py atmosphere

(``--device cpu`` after ``-n 2`` runs them on the CPU.)
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

import numpy as np
import torch

import mpi_tpu_torch
from mpi_tpu_torch import spawn

SERVICE = "coupled-demo"
STEPS = 5
N = 8  # boundary points per rank


def oracle(rank: int, steps: int = STEPS) -> Tuple[np.ndarray, np.ndarray]:
    """Both models' final boundaries for a rank pair, replayed in numpy."""
    sst = np.full(N, 290.0) + rank
    air = np.full(N, 285.0) + rank
    for _ in range(steps):
        sst, air = sst + 0.1 * (air - sst), air + 0.05 * (sst - air)
    return sst, air


def ocean(comm, steps: int = STEPS) -> torch.Tensor:
    """Server side: open a port, publish it, accept the atmosphere."""
    port = spawn.open_port() if comm.rank == 0 else None
    port = comm.bcast(port, 0)
    if comm.rank == 0:
        spawn.publish_name(SERVICE, port)
    inter = spawn.comm_accept(port, comm=comm)
    assert inter.remote_size == comm.size, "launch both jobs with the same -n"
    sst = torch.full((N,), 290.0, dtype=torch.float64,
                     device=comm.device) + comm.rank
    for _ in range(steps):
        # each ocean rank exchanges boundaries with its peer atmosphere rank
        peer = comm.rank % inter.remote_size
        flux = inter.sendrecv(sst, peer, source=peer)
        sst = sst + 0.1 * (flux - sst)  # relax toward the forcing
    if comm.rank == 0:
        spawn.unpublish_name(SERVICE)
        spawn.close_port(port)
    inter.free()
    return sst


def atmosphere(comm, steps: int = STEPS) -> torch.Tensor:
    """Client side: look the service up (waiting for the server), connect."""
    port = spawn.lookup_name(SERVICE, timeout=60) if comm.rank == 0 else None
    port = comm.bcast(port, 0)
    inter = spawn.comm_connect(port, comm=comm)
    assert inter.remote_size == comm.size, "launch both jobs with the same -n"
    air = torch.full((N,), 285.0, dtype=torch.float64,
                     device=comm.device) + comm.rank
    for _ in range(steps):
        peer = comm.rank % inter.remote_size
        sst = inter.sendrecv(air, peer, source=peer)
        air = air + 0.05 * (sst - air)
    inter.free()
    return air


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("role", nargs="?", default="ocean",
                    choices=("ocean", "atmosphere"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    comm = mpi_tpu_torch.COMM_WORLD
    got = (ocean if args.role == "ocean" else atmosphere)(comm)
    want = oracle(comm.rank)[0 if args.role == "ocean" else 1]
    ok = got.dtype == torch.float64 and np.array_equal(got.cpu().numpy(),
                                                       want)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out,
                               f"{args.role}_rank{comm.rank}.json"), "w") as f:
            json.dump({"role": args.role, "rank": comm.rank,
                       "device": str(got.device), "ok": bool(ok),
                       "final": got.cpu().tolist()}, f)
    if not ok:
        raise SystemExit(f"{args.role} rank {comm.rank}: final boundary "
                         f"{got.cpu().tolist()} != replay {want.tolist()}")
    if comm.rank == 0:
        name = "sst" if args.role == "ocean" else "air"
        print(f"{args.role}: coupled {STEPS} steps, final {name}[0] = "
              f"{float(got[0]):.3f}")


if __name__ == "__main__":
    main()
