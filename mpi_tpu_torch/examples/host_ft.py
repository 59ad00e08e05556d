"""A rank's death and the world's recovery on socket (or shm) ranks:
detect, revoke, shrink, agree, then a fresh process rejoins the vacant
slot.

    python -m mpi_tpu_torch.examples.host_ft --out DIR [--ranks 4] [--mib 256]
    python -m mpi_tpu_torch.examples.host_ft --out DIR --device cpu --mib 1
    python -m mpi_tpu_torch.examples.host_ft --out DIR --backend shm

The driver starts ``--ranks`` rank processes the way the launcher does
(``MPI_TPU_RANK`` / ``SIZE`` / ``RDV``, ``MPI_TPU_FT=1`` and
``MPI_TPU_PROGRESS=thread``: fault tolerance and a progress engine in
every rank) and one joiner process with only the rendezvous dir.  Every
rank draws ``--mib`` MiB of float32 from ``(--seed, rank)`` on its device.
Rank 1 calls ``os._exit(42)`` while rank 0 is inside a ring allreduce and
ranks 2.. are blocked on a receive from rank 0.  Rank 0 must raise
``ProcFailedError`` naming rank 1 and revoke; the others must raise
``RevokedError``; both within 3 x ``fault_detect_timeout_s`` + 8 s.  The
survivors ``shrink`` (membership epoch 1), ``agree(True)``, run a ring
allreduce checked against a float64 sum and bitwise across ranks, and
``accept_rejoin``; the joiner's ``membership.rejoin`` takes slot 1 at
epoch 1, and the full world's ring allreduce is checked the same way.
Each process writes ``DIR/rank<r>.json`` (the joiner ``joiner.json``); the
driver prints the launcher's per-rank exit summary and fails on any
unexpected exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

DEAD = 1


def _args(argv=None):
    p = argparse.ArgumentParser(prog="host_ft")
    p.add_argument("--out", required=True)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--mib", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None)
    p.add_argument("--detect", type=float, default=2.0,
                   help="fault_detect_timeout_s")
    p.add_argument("--heartbeat", type=float, default=0.2,
                   help="fault_heartbeat_interval_s")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--backend", choices=("socket", "shm"), default="socket")
    p.add_argument("--role", choices=("drive", "rank", "joiner"),
                   default="drive")
    return p.parse_args(argv)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _write(args, name: str, rec: dict) -> None:
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(rec, f)


def _configure(args) -> None:
    from mpi_tpu_torch import mpit

    mpit.cvar_write("fault_detect_timeout_s", args.detect)
    mpit.cvar_write("fault_heartbeat_interval_s", args.heartbeat)


def _timed_allreduce(comm, x):
    _sync(x.device)
    t0 = time.perf_counter()
    out = comm.allreduce(x, algorithm="ring")
    _sync(x.device)
    return out, time.perf_counter() - t0


def rank_main(args) -> int:
    import mpi_tpu_torch
    from mpi_tpu_torch import mpit
    from mpi_tpu_torch.errors import ProcFailedError, RevokedError
    from mpi_tpu_torch.examples.host_allreduce import check_allreduce, rank_input

    _configure(args)
    comm = mpi_tpu_torch.init()
    numel = (args.mib << 20) // 4
    x = rank_input(comm.rank, numel, args.seed, comm.device)
    comm.barrier()
    if comm.rank == DEAD:
        time.sleep(0.5)  # the survivors block first
        os._exit(42)
    bound = 3.0 * args.detect + 8.0
    rec = {"rank": comm.rank, "device": str(comm.device), "bound_s": bound}
    t0 = time.monotonic()
    try:
        if comm.rank == 0:
            comm.allreduce(x, algorithm="ring")  # blocked on the corpse
        else:
            comm.recv(source=0, tag=9)  # rank 0 never sends this
        raise RuntimeError(f"rank {comm.rank}: completed impossibly")
    except ProcFailedError as e:
        rec.update(outcome="ProcFailedError", failed=list(e.failed),
                   collective=e.collective, segment=e.segment)
        if comm.rank != 0 or DEAD not in e.failed:
            raise
        comm.revoke()
    except RevokedError:
        rec["outcome"] = "RevokedError"
        if comm.rank == 0:
            raise
    rec["detect_s"] = time.monotonic() - t0
    if rec["detect_s"] > bound:
        raise RuntimeError(f"rank {comm.rank}: detection took "
                           f"{rec['detect_s']:.1f} s (> {bound:.0f} s)")
    t = time.monotonic()
    new = comm.shrink()
    rec["shrink_s"] = time.monotonic() - t
    survivors = [r for r in range(comm.size) if r != DEAD]
    if new.size != len(survivors) or comm.membership_epoch != 1:
        raise RuntimeError(f"shrink: size {new.size}, epoch {comm.membership_epoch}")
    t = time.monotonic()
    if not new.agree(True):
        raise RuntimeError("agree(True) after shrink returned False")
    rec["agree_s"] = time.monotonic() - t
    out, rec["shrunk_allreduce_s"] = _timed_allreduce(new, x)
    rec["shrunk_err_vs_f64"] = check_allreduce(new, out, numel, args.seed, survivors)
    del out
    t = time.monotonic()
    full = new.accept_rejoin(timeout=args.timeout)
    rec["accept_rejoin_s"] = time.monotonic() - t
    if (full.size, full.rank, full.membership_epoch) != (comm.size, comm.rank, 1):
        raise RuntimeError(f"rejoined world: size {full.size}, rank {full.rank}, "
                           f"epoch {full.membership_epoch}")
    out, rec["full_allreduce_s"] = _timed_allreduce(full, x)
    rec["full_err_vs_f64"] = check_allreduce(full, out, numel, args.seed,
                                             range(comm.size))
    rec["pvars"] = {n: mpit.pvar_read(n) for n in (
        "proc_failures_detected", "revokes_delivered", "shrinks_completed",
        "rejoins_completed", "nbc_threads_spawned", "progress_wakeups")}
    rec["total_s"] = time.monotonic() - t0
    _write(args, f"rank{comm.rank}.json", rec)
    full.barrier()
    _sync(comm.device)
    full.close_transport()  # joins the engine, detector and readers
    return 0


def joiner_main(args) -> int:
    from mpi_tpu_torch import membership, mpit
    from mpi_tpu_torch.examples.host_allreduce import check_allreduce, rank_input

    _configure(args)
    t = time.monotonic()
    world = membership.rejoin(timeout=args.timeout)
    rec = {"rank": world.rank, "device": str(world.device),
           "rejoin_wait_s": time.monotonic() - t,
           "epoch": world.membership_epoch}
    if (world.rank, world.membership_epoch) != (DEAD, 1):
        raise RuntimeError(f"joiner took slot {world.rank} at epoch "
                           f"{world.membership_epoch}")
    numel = (args.mib << 20) // 4
    x = rank_input(world.rank, numel, args.seed, world.device)
    out, rec["full_allreduce_s"] = _timed_allreduce(world, x)
    rec["full_err_vs_f64"] = check_allreduce(world, out, numel, args.seed,
                                             range(world.size))
    rec["rejoins_completed"] = mpit.pvar_read("rejoins_completed")
    _write(args, "joiner.json", rec)
    world.barrier()
    _sync(world.device)
    world.close_transport()
    return 0


def drive(out: str, ranks: int = 4, mib: int = 256, seed: int = 0,
          device=None, detect: float = 2.0, heartbeat: float = 0.2,
          timeout: float = 300.0, backend: str = "socket") -> dict:
    """Run the story in ``ranks`` + 1 processes; returns the per-process
    records and the exit summary.  Raises on any failed check."""
    from mpi_tpu_torch import launcher, membership
    from mpi_tpu_torch.membership import (ENV_BACKEND, ENV_DEVICE, ENV_RANK,
                                          ENV_RDV, ENV_SIZE)

    if ranks < 3:
        raise ValueError("the story needs at least 3 ranks")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        if f.endswith(".json"):
            os.remove(os.path.join(out, f))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if backend == "shm":
        from mpi_tpu_torch.native import ensure_built

        ensure_built()  # once, before the ranks race to the build lock
    rdv = membership.new_rendezvous_dir()
    common = ["--out", out, "--ranks", str(ranks), "--mib", str(mib),
              "--seed", str(seed), "--detect", str(detect),
              "--heartbeat", str(heartbeat), "--timeout", str(timeout)]
    base = dict(os.environ)
    base.update({ENV_RDV: rdv, ENV_BACKEND: backend, "MPI_TPU_FT": "1",
                 "MPI_TPU_PROGRESS": "thread",
                 "PYTHONPATH": os.pathsep.join(
                     p for p in (root, os.environ.get("PYTHONPATH")) if p)})
    if device is not None:
        base[ENV_DEVICE] = device
    procs = []
    t0 = time.monotonic()
    try:
        for r in range(ranks):
            env = dict(base, **{ENV_RANK: str(r), ENV_SIZE: str(ranks)})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mpi_tpu_torch.examples.host_ft",
                 "--role", "rank", *common], env=env, cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        joiner = subprocess.Popen(
            [sys.executable, "-m", "mpi_tpu_torch.examples.host_ft",
             "--role", "joiner", *common], env=base, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(joiner)
        logs = []
        for p in procs:
            try:
                o, e = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                launcher._kill_all(procs)
                o, e = p.communicate()
            logs.append((o, e))
    finally:
        launcher._kill_all(procs)
        membership.cleanup_rendezvous(rdv)
    wall = time.monotonic() - t0
    summary = launcher._exit_summary(procs[:-1]) + \
        f"  joiner: exit code {procs[-1].poll()}\n"
    want = [42 if r == DEAD else 0 for r in range(ranks)] + [0]
    got = [p.poll() for p in procs]
    if got != want:
        tails = "\n".join(f"--- process {i} (rc {c}) ---\n{e[-3000:]}"
                          for i, (c, (_, e)) in enumerate(zip(got, logs)))
        raise RuntimeError(f"host_ft: exit codes {got}, wanted {want}\n"
                           f"{summary}{tails}")
    recs = {}
    for r in range(ranks):
        if r != DEAD:
            with open(os.path.join(out, f"rank{r}.json")) as f:
                recs[r] = json.load(f)
    with open(os.path.join(out, "joiner.json")) as f:
        recs["joiner"] = json.load(f)
    return {"records": recs, "exit_summary": summary, "wall_s": wall}


def main(argv=None) -> int:
    args = _args(argv)
    if args.role == "rank":
        return rank_main(args)
    if args.role == "joiner":
        return joiner_main(args)
    res = drive(args.out, args.ranks, args.mib, args.seed, args.device,
                args.detect, args.heartbeat, args.timeout, args.backend)
    sys.stdout.write(res["exit_summary"])
    print(json.dumps(res["records"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
