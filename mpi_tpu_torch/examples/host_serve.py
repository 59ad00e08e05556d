"""A client of the resident world server, checked and timed: the README's
serve usage.  Start a server, then lease worlds from it::

    python -m mpi_tpu_torch.launcher serve --pool-size 4 --addr-file F &
    python -m mpi_tpu_torch.examples.host_serve --addr-file F \\
        --nranks 4 --mib 256 --require cuda --shutdown

    python -m mpi_tpu_torch.launcher serve --pool-size 2 --device cpu \\
        --addr-file F &
    python -m mpi_tpu_torch.examples.host_serve --addr-file F \\
        --nranks 2 --mib 1 --require cpu --shutdown

``connect(F)`` reaches the server through its address file, ``acquire``
leases ``--nranks`` warm workers as a world, and ``lease.run`` runs
:func:`job_allreduce_checked` on them: every rank fills ``--mib`` MiB of
float32 with ``rank + 1`` on its device and the ring allreduce must give
exactly ``P (P + 1) / 2`` everywhere (checked on the workers).  Then the
built-in ``serve.job_allreduce`` on the same lease, and with
``--shutdown`` the server is asked to stop.  ``--require`` names the
device type every worker must report.  The result is printed as one JSON
line (and written to ``--out``); a failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

TIMEOUT_S = 120.0  # the acquire's and each job's bound


def job_devices(comm) -> list:
    """Every leased worker's device, in lease rank order."""
    return comm.allgather(str(comm.device))


def job_allreduce_checked(comm, mib: int = 256) -> dict:
    """Ring allreduce of ``mib`` MiB of float32 a rank, each rank's input
    ``rank + 1`` on its device; every rank checks that each element is
    exactly ``P (P + 1) / 2``.  Returns each rank's device, whether its
    check passed and the ms of its collective (a barrier and a
    synchronize before the clock starts, a synchronize before it stops),
    and rank 0's first four results as a tensor on its device (the server
    hands it to the client on the CPU)."""
    dev = comm.device
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    numel = (int(mib) << 20) // 4
    x = torch.full((numel,), comm.rank + 1.0, dtype=torch.float32,
                   device=dev)
    want = comm.size * (comm.size + 1) / 2.0
    sync()
    comm.barrier()
    t0 = time.perf_counter()
    out = comm.allreduce(x, algorithm="ring")
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    ok = bool((out == want).all())
    return {"bytes_per_rank": numel * 4, "want": want,
            "devices": comm.allgather(str(dev)),
            "ok": comm.allgather(ok), "ms": comm.allgather(ms),
            "head": out[:4].clone()}


def main(argv=None) -> int:
    from mpi_tpu_torch import connect, serve
    # the job by its import path: run as __main__, this module's own
    # names would pickle as __main__.*, which no worker can import
    from mpi_tpu_torch.examples.host_serve import job_allreduce_checked

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--addr-file", required=True,
                    help="the server's address file (launcher serve "
                         "--addr-file)")
    ap.add_argument("--nranks", type=int, default=4)
    ap.add_argument("--mib", type=int, default=256,
                    help="float32 MiB a rank of the checked allreduce")
    ap.add_argument("--require", default=None, choices=("cuda", "cpu"),
                    help="the device type every worker must report")
    ap.add_argument("--shutdown", action="store_true",
                    help="ask the server to stop at the end")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    client = connect(args.addr_file)
    connect_s = time.perf_counter() - t0
    try:
        t1 = time.perf_counter()
        with client.acquire(args.nranks, timeout=TIMEOUT_S) as lease:
            acquire_ms = (time.perf_counter() - t1) * 1e3
            big = lease.run(job_allreduce_checked, args.mib, timeout=TIMEOUT_S)
            small = lease.run(serve.job_allreduce, 256, timeout=TIMEOUT_S)
        stats = client.stats()
        if args.shutdown:
            client.shutdown()
    finally:
        client.close()
    want_small = args.nranks * (args.nranks + 1) / 2.0
    devices_ok = (args.require is None or all(
        d.split(":")[0] == args.require for d in big["devices"]))
    head = big.pop("head")  # a tensor, on the client's CPU
    big["head"] = head.tolist()
    res = {"nranks": args.nranks, "connect_s": connect_s,
           "acquire_ms": acquire_ms, "allreduce": big,
           "job_allreduce": small,
           "ok": (all(big["ok"]) and small == want_small and devices_ok
                  and head.device.type == "cpu"
                  and big["head"] == [big["want"]] * 4),
           "epoch": stats["epoch"], "backend": stats["backend"],
           "lease_acquire_p50_ms": stats["lease_acquire_p50_ms"],
           "lease_acquire_p99_ms": stats["lease_acquire_p99_ms"]}
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    if not res["ok"]:
        print(f"host_serve: check failed: devices {big['devices']} "
              f"(required {args.require}), per-rank checks {big['ok']}, "
              f"job_allreduce {small} (want {want_small})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
