"""Socket-rank check and timing of the host collectives, and the portable
examples as socket ranks.  Run under the launcher, one process per rank:

    python -m mpi_tpu_torch.launcher -n 4 mpi_tpu_torch/examples/host_allreduce.py --out DIR
    python -m mpi_tpu_torch.launcher -n 4 --device cpu mpi_tpu_torch/examples/host_allreduce.py --out DIR --mib 4

Every rank draws its float32 input of ``--mib`` MiB from ``(--seed,
rank)`` on its device and runs the ring and Rabenseifner allreduce: one
call of each first, whose pickled bytes (the ``bytes_pickled_sent``
pvar) must be 0, then for each 1 warm-up and 3 timed calls (a barrier and a
synchronize before each, a synchronize before the clock stops; the
call's time is the slowest rank's).  Each rank then regenerates every
rank's input to check its result against a float64 sum (rtol 1e-5, atol
1e-5) and holds it bitwise against rank 0's (broadcast).  Ranks 0 and 1
also time a 1 KiB float32 allreduce on a communicator of their own.
Finally the unmodified ``pi_program`` and ``jacobi_program`` run on the
world.  Each rank writes ``DIR/rank<r>.json``; any failed check raises,
so the rank (and the launcher) exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

import mpi_tpu_torch
from mpi_tpu_torch import mpit
from mpi_tpu_torch.examples.jacobi import jacobi_program
from mpi_tpu_torch.examples.pi import pi_program


def rank_input(rank: int, numel: int, seed: int, device) -> torch.Tensor:
    """Rank ``rank``'s float32 input, the same on every rank that draws it."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + rank)
    return torch.randn(numel, generator=gen, device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(comm, fn, reps: int = 3):
    """One warm-up and ``reps`` timed calls of ``fn()``; returns the last
    result and each call's seconds on the slowest rank."""
    fn()
    mine = []
    out = None
    for _ in range(reps):
        comm.barrier()
        _sync(comm.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(comm.device)
        mine.append(time.perf_counter() - t0)
    everyone = comm.allgather(mine)
    return out, [max(ts[i] for ts in everyone) for i in range(reps)]


def check_allreduce(comm, out, numel, seed, ranks) -> float:
    """Float64 sum of the inputs of ``ranks`` (regenerated here) against
    ``out``; bitwise agreement with the communicator's rank 0.  Returns
    the largest absolute difference from the float64 sum."""
    want = torch.zeros(numel, dtype=torch.float64, device=out.device)
    for r in ranks:
        want += rank_input(r, numel, seed, out.device).double()
    err = float((out.double() - want).abs().max())
    if not torch.allclose(out.double(), want, rtol=1e-5, atol=1e-5):
        raise RuntimeError(f"allreduce disagrees with the float64 sum: {err}")
    ref = comm.bcast(out if comm.rank == 0 else None, root=0)
    if not torch.equal(ref.to(out.device), out):
        raise RuntimeError(f"rank {comm.rank}'s allreduce differs from rank 0's")
    return err


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="directory for rank<r>.json")
    ap.add_argument("--mib", type=int, default=256, help="MiB per rank")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    comm = mpi_tpu_torch.init()
    dev = comm.device
    numel = (args.mib << 20) // 4
    x = rank_input(comm.rank, numel, args.seed, dev)
    rec = {"rank": comm.rank, "size": comm.size, "device": str(dev),
           "bytes_per_rank": numel * 4}
    algos = ("ring", "rabenseifner")
    pickled = {}
    for algo in algos:  # both run once before either is timed
        before = mpit.pvar_read("bytes_pickled_sent")
        comm.allreduce(x, algorithm=algo)
        pickled[algo] = mpit.pvar_read("bytes_pickled_sent") - before
        if pickled[algo]:
            raise RuntimeError(f"{algo} allreduce pickled {pickled[algo]} bytes")
    for algo in algos:
        out, secs = timed(comm, lambda: comm.allreduce(x, algorithm=algo))
        err = check_allreduce(comm, out, numel, args.seed, range(comm.size))
        rec[algo] = {"s": secs, "median_ms": statistics.median(secs) * 1e3,
                     "pickled_bytes": pickled[algo], "max_abs_err_vs_f64": err}
        del out
    del x
    pair = comm.split(0 if comm.rank < 2 else None)
    if pair is not None:  # the 1 KiB latency case on two ranks
        small = rank_input(comm.rank, 256, args.seed + 1, dev)
        out, secs = timed(pair, lambda: pair.allreduce(small))
        err = check_allreduce(pair, out, 256, args.seed + 1, range(2))
        rec["allreduce_1KiB_2ranks"] = {
            "s": secs, "median_ms": statistics.median(secs) * 1e3,
            "max_abs_err_vs_f64": err}
    rec["pi"] = float(pi_program(comm))
    block, residual = jacobi_program(comm)
    rec["jacobi"] = {"block": block.cpu().tolist(), "residual": float(residual)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{comm.rank}.json"), "w") as f:
        json.dump(rec, f)
    mpi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
