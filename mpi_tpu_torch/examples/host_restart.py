"""The failure story of the host layer, end to end: a rank dies mid-run,
the launcher relaunches the world, and the world resumes from its last
committed checkpoint.  Run under the launcher with ``--restarts``::

    python -m mpi_tpu_torch.launcher -n 2 --restarts 2 mpi_tpu_torch/examples/host_restart.py --out DIR
    python -m mpi_tpu_torch.launcher -n 2 --restarts 2 --backend shm --device cpu \\
        mpi_tpu_torch/examples/host_restart.py --out DIR --mib 4

Each rank's state is ``--mib`` MiB of float32 drawn from ``(--seed,
rank)`` on its device.  A step adds ``rank + step`` to it and folds in a
ring allreduce of its first 64 KiB, then ``checkpoint.save`` commits the
state (``DIR/ckpt``).  On attempt 0 (``MPI_TPU_ATTEMPT``) rank 1 calls
``os._exit(41)`` right after the save of step ``--crash-step``; the
launcher kills the world and starts it again, which finds the committed
generation, loads it onto each rank's device and runs the remaining
steps.  Then every rank replays all ``--steps`` steps from the seed
without saving (the crash-free oracle, the same collectives in the same
order) and checks its resumed state against it bitwise.  Each rank of the
last attempt writes ``DIR/rank<r>.json``: the attempt, the generation it
resumed from, the bytes per rank, the save and load seconds, the devices
of the loaded tensors and the check; a failed check raises (the rank, and
the launcher, exit non-zero).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

import mpi_tpu_torch
from mpi_tpu_torch import checkpoint
from mpi_tpu_torch.examples.host_allreduce import rank_input

FOLD = 16384  # elements of the state folded in by each step's allreduce


def step(comm, w: torch.Tensor, k: int) -> None:
    """One step of the rank's program, in place on its device."""
    w.add_(float(comm.rank + k))
    w[:FOLD] += comm.allreduce(w[:FOLD], algorithm="ring") * 1e-3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--crash-step", type=int, default=1)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    comm = mpi_tpu_torch.init()
    attempt = int(os.environ.get("MPI_TPU_ATTEMPT", "0"))
    ckpt = os.path.join(args.out, "ckpt")
    numel = (args.mib << 20) // 4
    sync = (lambda: torch.cuda.synchronize(comm.device)
            if comm.device.type == "cuda" else None)
    info = {"rank": comm.rank, "attempt": attempt, "device": str(comm.device),
            "bytes_per_rank": numel * 4, "save_s": []}
    resumed_from = None
    if checkpoint.exists(ckpt):
        comm.barrier()
        t0 = time.perf_counter()
        state = checkpoint.load(ckpt, comm)
        sync()
        info["load_s"] = time.perf_counter() - t0
        with open(os.path.join(ckpt, "manifest.json")) as f:
            resumed_from = json.load(f)["gen"]
        info["loaded_devices"] = sorted({str(state["w"].device)})
        if state["w"].device != comm.device:
            raise RuntimeError(f"rank {comm.rank}: state loaded on "
                               f"{state['w'].device}, not {comm.device}")
    else:
        state = {"step": 0, "w": rank_input(comm.rank, numel, args.seed,
                                            comm.device)}
    info["resumed_from_gen"] = resumed_from
    info["resumed_at_step"] = state["step"]
    w = state["w"]
    for k in range(state["step"], args.steps):
        step(comm, w, k)
        sync()
        comm.barrier()
        t0 = time.perf_counter()
        checkpoint.save(ckpt, {"step": k + 1, "w": w}, comm)
        info["save_s"].append(time.perf_counter() - t0)
        if attempt == 0 and comm.rank == 1 and k == args.crash_step:
            os._exit(41)  # the crash, mid-run, after a committed save
    with open(os.path.join(ckpt, "manifest.json")) as f:
        info["committed_gen"] = json.load(f)["gen"]
    oracle = rank_input(comm.rank, numel, args.seed, comm.device)
    for k in range(args.steps):
        step(comm, oracle, k)
    info["bitwise_equal_to_crash_free"] = bool(torch.equal(w, oracle))
    info["max_abs_diff"] = float((w - oracle).abs().max())
    with open(os.path.join(args.out, f"rank{comm.rank}.json"), "w") as f:
        json.dump(info, f)
    if not info["bitwise_equal_to_crash_free"]:
        raise RuntimeError(f"rank {comm.rank}: resumed state differs from the "
                           f"crash-free run by {info['max_abs_diff']}")
    mpi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
