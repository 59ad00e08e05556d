"""Socket ranks under the runtime verifier: a clean ring, a wildcard race,
device work that must not read as a deadlock, and a real deadlock, in one
world.  Run under the launcher with ``--verify`` and at least 3 ranks:

    python -m mpi_tpu_torch.launcher -n 4 --verify mpi_tpu_torch/examples/host_verify.py --out DIR
    python -m mpi_tpu_torch.launcher -n 4 --verify --device cpu mpi_tpu_torch/examples/host_verify.py --out DIR --mib 4 --products-s 1

With ``verify_stall_timeout_s`` set to ``--stall``:

1. clean: a ring allreduce of ``--mib`` MiB of float32 per rank, checked
   against a float64 sum and bitwise across ranks.  Its pickled bytes are
   the signature tuples alone (those of a 1 KiB ring, up to the digits of
   the shape), its raw bytes the tensor's, and no ``verify_*`` event
   fires;
2. wildcard race: ranks 1 and 2 send a tensor to rank 0 under one tag,
   rank 0 waits until both are queued and receives both with
   ``ANY_SOURCE``: the race is named in its report, with both senders;
3. no false positive: rank 0 first runs bfloat16 products for
   ``--products-s`` seconds (more than 3 x ``--stall``; its host thread
   waits on the device after each batch), while every other rank is
   already inside a ring allreduce of ``--small-mib`` MiB waiting for it.
   The allreduce completes with the right sum and no deadlock is found;
4. deadlock: every rank first receives from its right neighbour (a cycle
   through every process): each rank raises ``DeadlockError`` naming every
   rank, diagnosed through the ``pending.<rank>`` files of the rendezvous
   directory.

Each rank writes ``DIR/rank<r>.json`` with the seconds of each part; any
failed check raises, so the rank (and the launcher) exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

import mpi_tpu_torch
from mpi_tpu_torch import mpit, verify
from mpi_tpu_torch.errors import DeadlockError
from mpi_tpu_torch.examples.host_allreduce import _sync, check_allreduce, rank_input

_EVENTS = ("verify_deadlocks_detected", "verify_collective_mismatches",
           "verify_requests_leaked", "verify_double_waits",
           "verify_buffer_overlaps", "verify_comms_unfreed",
           "verify_wildcard_races")
_WIRE = ("bytes_pickled_sent", "bytes_raw_sent", "verify_clock_bytes")


def busy_products(device, seconds: float):
    """bfloat16 products until ``seconds`` have passed, the host waiting on
    the device after every batch; returns (products, seconds)."""
    n = 8192 if device.type == "cuda" else 256
    gen = torch.Generator(device=device).manual_seed(7)
    a = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            c = a @ a
            k += 1
        float(c[0, 0])  # the host thread waits on the device here
    return k, time.perf_counter() - t0


def _deltas(names, fn):
    base = {k: mpit.pvar_read(k) for k in names}
    out = fn()
    return out, {k: mpit.pvar_read(k) - base[k] for k in names}


def clean_ring(comm, args, rec) -> None:
    numel = (args.mib << 20) // 4
    x = rank_input(comm.rank, numel, args.seed, comm.device)
    tiny = rank_input(comm.rank, 256, args.seed, comm.device)
    _, small = _deltas(_WIRE, lambda: comm.allreduce(tiny, algorithm="ring"))
    comm.barrier()
    _sync(comm.device)
    t0 = time.perf_counter()
    out, wire = _deltas(_WIRE + _EVENTS,
                        lambda: comm.allreduce(x, algorithm="ring"))
    _sync(comm.device)
    secs = time.perf_counter() - t0
    err = check_allreduce(comm, out, numel, args.seed, range(comm.size))
    if abs(wire["bytes_pickled_sent"] - small["bytes_pickled_sent"]) > 64:
        raise RuntimeError(f"the payload went through pickle: {wire} vs "
                           f"{small} for 1 KiB")
    if any(wire[k] for k in _EVENTS):
        raise RuntimeError(f"verify events on a clean ring: {wire}")
    rec["clean_ring"] = {"s": secs, "bytes_per_rank": numel * 4,
                         "max_abs_err_vs_f64": err, "wire": wire,
                         "wire_1KiB": small}


def wildcard_race(comm, rec) -> None:
    t0 = time.perf_counter()
    verify.take_report()
    if comm.rank == 0:
        while not (comm.iprobe(source=1, tag=7) and comm.iprobe(source=2, tag=7)):
            time.sleep(0.001)
        a = comm.recv(source=-1, tag=7)  # mpilint: ok (the race under test)
        b = comm.recv(source=-1, tag=7)  # mpilint: ok
        got = sorted([float(a[0]), float(b[0])])
        if got != [1.0, 2.0]:
            raise RuntimeError(f"wildcard receives got {got}")
        race = [ln for ln in verify.take_report() if "wildcard race" in ln]
        if not race or "from rank 1" not in race[0] or "rank 2" not in race[0]:
            raise RuntimeError(f"the race was not named: {race}")
        rec["wildcard_race"] = {"line": race[0]}
    elif comm.rank in (1, 2):
        comm.send(torch.full((4,), float(comm.rank), device=comm.device), 0, tag=7)
    comm.barrier()
    rec.setdefault("wildcard_race", {})["s"] = time.perf_counter() - t0


def no_false_positive(comm, args, rec) -> None:
    numel = (args.small_mib << 20) // 4
    x = rank_input(comm.rank, numel, args.seed + 1, comm.device)
    comm.barrier()
    t0 = time.perf_counter()

    def body():
        if comm.rank == 0:
            rec["products"], rec["products_s"] = busy_products(
                comm.device, args.products_s)
        return comm.allreduce(x, algorithm="ring")

    out, ev = _deltas(_EVENTS, body)
    _sync(comm.device)
    secs = time.perf_counter() - t0
    err = check_allreduce(comm, out, numel, args.seed + 1, range(comm.size))
    if any(ev.values()):
        raise RuntimeError(f"device work read as a verifier finding: {ev}")
    rec["no_false_positive"] = {"s": secs, "bytes_per_rank": numel * 4,
                                "max_abs_err_vs_f64": err}


def deadlock(comm, rec) -> None:
    comm.barrier()
    t0 = time.perf_counter()
    try:
        comm.recv(source=(comm.rank + 1) % comm.size, tag=4)  # mpilint: ok
    except DeadlockError as e:
        if sorted(e.ranks) != list(range(comm.size)) or "tag=4" not in str(e):
            raise RuntimeError(f"wrong deadlock diagnosis: {e}") from e
        rec["deadlock"] = {"s": time.perf_counter() - t0, "ranks": list(e.ranks),
                           "message": str(e)}
        verify.take_report()  # diagnosed and handled: not for finalize
    else:
        raise RuntimeError("the receive cycle completed")
    # the published entries stay until each rank moves on: leave every peer
    # time to confirm the same closed picture before this rank sends again
    # (detections land within one check slice of each other, 0.25 s)
    time.sleep(2 * float(mpit.cvar_read("verify_stall_timeout_s")))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="directory for rank<r>.json")
    ap.add_argument("--mib", type=int, default=256, help="MiB per rank of the clean ring")
    ap.add_argument("--small-mib", type=int, default=16,
                    help="MiB per rank of the ring after the products")
    ap.add_argument("--stall", type=float, default=1.0,
                    help="verify_stall_timeout_s")
    ap.add_argument("--products-s", type=float, default=None,
                    help="seconds of products on rank 0 (default 3.5 x --stall)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.products_s is None:
        args.products_s = 3.5 * args.stall
    mpit.cvar_write("verify_stall_timeout_s", args.stall)
    comm = mpi_tpu_torch.init()
    if comm._verify is None or comm.size < 3:
        raise RuntimeError("run under the launcher with --verify and -n >= 3")
    rec = {"rank": comm.rank, "size": comm.size, "device": str(comm.device),
           "stall_s": args.stall}
    clean_ring(comm, args, rec)
    wildcard_race(comm, rec)
    no_false_positive(comm, args, rec)
    deadlock(comm, rec)
    rec["pvars"] = {k: mpit.pvar_read(k) for k in _EVENTS + _WIRE}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{comm.rank}.json"), "w") as f:
        json.dump(rec, f)
    mpi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
