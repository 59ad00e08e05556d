"""MPI-IO, steered receives and dynamic processes as rank processes,
checked and timed.  Run under the launcher, one process per rank, on the
socket transport::

    python -m mpi_tpu_torch.launcher -n 4 --backend socket \\
        mpi_tpu_torch/examples/host_dynamic.py --out DIR --require cuda
    python -m mpi_tpu_torch.launcher -n 4 --backend socket --device cpu \\
        mpi_tpu_torch/examples/host_dynamic.py --out DIR --mib 4 --n 256

Every rank draws its float32 input of ``--mib`` MiB from ``(--seed,
rank)`` on its device (``--require`` names the device type every rank
must have) and runs, each leg timed (a barrier and a synchronize before,
a synchronize before the clock stops):

1. MPI-IO (``io.py``) on one file in the launcher's rendezvous directory:
   ``write_at_all`` of each rank's tensor at offset ``rank * numel`` (4 x
   the input in all: above the 8 MiB limit, the independent branch),
   ``read_at_all`` back onto the device, bitwise; ``parallel_io``'s
   column-block subarray view at ``--n`` x ``--n`` float32 (1024: 4 MiB,
   the two-phase aggregated branch), its file against a numpy oracle on
   rank 0; shared-pointer appends and ``write_ordered`` lines, their
   order and content checked on rank 0; an ``external32`` round trip of
   the input's first 1 MiB, its bytes on disk big-endian;
2. a steered receive on the socket reader: rank 1 posts
   ``irecv(source=0, buf=<its device tensor>)`` before rank 0 sends its
   input (a handshake orders them); the result is the buffer itself (same
   ``data_ptr``), bitwise rank 0's input, ``recv_user_inplace`` +1 and
   ``recv_user_fallbacks`` +0; and the same receive with the
   ``recv_steering`` cvar off (the completion's copy path), the two in
   turns (steered, copy, copy, steered) after one untimed steered
   receive;
3. spawn: the 4 ranks collectively ``comm_spawn`` ``--children`` workers
   of ``examples/spawn_workers.py`` (their device: the card, or
   ``MPI_TPU_DEVICE``), scatter ``--samples`` points a worker over the
   intercommunicator and reduce the counts; each worker reports its
   device, and the counts and the estimate equal the float64 numpy
   oracle.

Each rank writes ``DIR/rank<r>.json``; a failed check raises, so the rank
(and the launcher) exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import mpi_tpu_torch
from mpi_tpu_torch import io as mio
from mpi_tpu_torch import mpit
from mpi_tpu_torch.examples import parallel_io, spawn_workers
from mpi_tpu_torch.examples.host_allreduce import rank_input

PVARS = ("recv_user_inplace", "recv_user_fallbacks", "recv_bytes_steered")


def steer_receive(comm, x: torch.Tensor, want, tag: int,
                  steering: int):
    """Rank 0 sends ``x`` to rank 1, which posted ``irecv(source=0,
    buf=<a tensor like x>)`` first (a handshake on ``tag + 1`` orders the
    two), with the ``recv_steering`` cvar at ``steering`` on every rank.
    Returns on rank 1 ``{"ms", "in_place", "equal", "ok", <PVARS>}`` — the
    receive's wall from the barrier, whether the result is the buffer
    itself at its own address, whether the buffer holds ``want`` bitwise,
    and the pvar deltas; ``ok`` is the check: steered, one in-place
    landing and no fallback; the copy path (``steering=0``), a fresh
    tensor copied into the buffer with the fallback counted once.  None
    on the other ranks."""
    dev, r = comm.device, comm.rank
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    old = mpit.cvar_read("recv_steering")
    mpit.cvar_write("recv_steering", steering)
    try:
        buf = torch.empty_like(x) if r == 1 else None
        base = {p: mpit.pvar_read(p) for p in PVARS}
        comm.barrier()
        sync()
        t0 = time.perf_counter()
        if r == 0:
            comm.recv(1, tag + 1)
            comm.send(x, dest=1, tag=tag)
        elif r == 1:
            ptr = buf.data_ptr()
            req = comm.irecv(0, tag, buf=buf)
            comm.send(b"posted", dest=0, tag=tag + 1)
            got = req.wait()
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {p: mpit.pvar_read(p) - base[p] for p in PVARS}
        comm.barrier()
    finally:
        mpit.cvar_write("recv_steering", old)
    if r != 1:
        return None
    out = {"ms": ms, "in_place": got is buf and buf.data_ptr() == ptr,
           "equal": buf.data_ptr() == ptr and bool(torch.equal(buf, want)),
           **delta}
    counts = (delta["recv_user_inplace"], delta["recv_user_fallbacks"])
    out["ok"] = out["equal"] and (
        (out["in_place"], counts) == ((True, (1, 0)) if steering
                                      else (False, (0, 1))))
    return out


def steer_turns(comm, x: torch.Tensor, want, tag: int):
    """One untimed steered receive (the first use of the pinned staging,
    a 256 MiB host allocation on the card, lands there), then
    :func:`steer_receive` in turns — steered, copy path, copy path,
    steered.  Returns on rank 1 ``{"warmup": ..., "steered": ...,
    "copy_path": ...}``, each side the mean ``ms`` of its two turns,
    ``ms_turns``, ``ok`` of both turns and the pvar deltas of each turn
    (``turns``); None elsewhere."""
    warmup = steer_receive(comm, x, want, tag, 1)
    got = {"steered": [], "copy_path": []}
    for i, side in enumerate(("steered", "copy_path", "copy_path",
                              "steered")):
        got[side].append(steer_receive(comm, x, want, tag + 2 * (i + 1),
                                       int(side == "steered")))
    if comm.rank != 1:
        return None
    return {"warmup": warmup} | {
        side: {"ms": sum(t["ms"] for t in ts) / len(ts),
                   "ms_turns": [t["ms"] for t in ts],
                   "ok": all(t["ok"] for t in ts),
                   "in_place": all(t["in_place"] for t in ts),
                   "turns": ts}
            for side, ts in got.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--children", type=int, default=2)
    ap.add_argument("--samples", type=int, default=1 << 20)
    ap.add_argument("--require", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    comm = mpi_tpu_torch.init()
    n, r, dev = comm.size, comm.rank, comm.device
    if n != 4:
        raise SystemExit("run with -n 4")
    if args.require is not None and dev.type != args.require:
        raise RuntimeError(f"rank {r}: device {dev}, not {args.require}")
    card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if card else (lambda: None)
    numel = (args.mib << 20) // 4
    x = rank_input(r, numel, args.seed, dev)
    info = {"rank": r, "device": str(dev), "bytes_per_rank": numel * 4,
            "legs": {}}
    scratch = os.environ.get("MPI_TPU_RDV") or args.out

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

    # 1. MPI-IO
    path = os.path.join(scratch, "host_dynamic.bin")
    f = mio.file_open(comm, path, mio.MODE_CREATE | mio.MODE_RDWR
                      | mio.MODE_DELETE_ON_CLOSE)
    f.set_view(etype=torch.float32)
    timed("io write_at_all", lambda: f.write_at_all(r * numel, x))
    check("io write_at_all", f.get_size() == n * numel * 4,
          seconds=info["legs"]["io write_at_all"]["ms"] / 1e3,
          branch="independent" if n * numel * 4 > mio._COLLECTIVE_BUFFER_LIMIT
          else "two-phase")
    back = timed("io read_at_all", lambda: f.read_at_all(r * numel, numel))
    check("io read_at_all", back.device == dev and torch.equal(back, x),
          seconds=info["legs"]["io read_at_all"]["ms"] / 1e3)
    del back
    f.close()

    mat = os.path.join(scratch, "matrix.bin")
    log = timed("io subarray view", lambda: parallel_io.run(comm, args.n, mat))
    if r == 0:
        cols = args.n // n
        want = np.repeat(np.arange(1.0, n + 1, dtype=np.float32), cols)
        disk = np.fromfile(mat, dtype=np.float32, count=args.n * args.n)
        check("io subarray view",
              np.array_equal(disk.reshape(args.n, args.n),
                             np.broadcast_to(want, (args.n, args.n)))
              and sorted(log.split(";")[:-1]) == [f"rank{q} ok"
                                                  for q in range(n)],
              bytes=args.n * args.n * 4)
        os.unlink(mat)
    else:
        check("io subarray view", log == "")

    logp = os.path.join(scratch, "log.txt")

    def shared_and_ordered():
        g = mio.file_open(comm, logp, mio.MODE_CREATE | mio.MODE_RDWR,
                          shared=True)
        g.write_shared(np.frombuffer(f"shared {r};".encode(), np.uint8))
        comm.barrier()
        g.write_ordered(np.frombuffer(f"line {r}\n".encode() * (r + 1),
                                      np.uint8))
        comm.barrier()
        text = bytes(g.read_at(0, g.get_size()).cpu().numpy()).decode()
        g.close()
        return text

    text = timed("io shared and ordered", shared_and_ordered)
    head = text[:text.rindex(";") + 1]
    check("io shared and ordered",
          sorted(head.split(";")[:-1]) == [f"shared {q}" for q in range(n)]
          and text[len(head):] == "".join(f"line {q}\n" * (q + 1)
                                          for q in range(n)))
    comm.barrier()
    if r == 0:
        os.unlink(logp)

    e32 = os.path.join(scratch, "e32.bin")
    k = min(numel, (1 << 20) // 4)

    def external32():
        g = mio.file_open(comm, e32, mio.MODE_CREATE | mio.MODE_RDWR)
        g.set_view(etype=torch.float32, datarep="external32")
        g.write_at_all(r * k, x[:k])
        got = g.read_at_all(r * k, k)
        disk = np.fromfile(e32, dtype=">f4", count=k, offset=r * k * 4)
        g.close()
        return got, disk

    got, disk = timed("io external32", external32)
    check("io external32", got.device == dev and torch.equal(got, x[:k])
          and np.array_equal(disk.astype(np.float32), x[:k].cpu().numpy()))
    comm.barrier()
    if r == 0:
        os.unlink(e32)

    # 2. steered receive on the socket reader, then the copy path
    src = rank_input(0, numel, args.seed, dev) if r == 1 else None
    got = steer_turns(comm, x, src, 40)
    for name, side in (("steered recv", "steered"),
                       ("copy-path recv", "copy_path")):
        info["legs"][name] = got[side] if r == 1 else {"ms": 0.0}
        check(name, r != 1 or got[side]["ok"])
    if r == 1:
        info["steer_warmup"] = got["warmup"]
        check("steered recv", got["warmup"]["ok"])

    # 3. spawn a worker world and reduce its counts
    got = timed("spawn", lambda: spawn_workers.master(
        comm, args.children, args.samples))
    if r == 0:
        hits = sum(spawn_workers.reference_hits(j, args.samples)
                   for j in range(args.children))
        total = args.children * args.samples
        want_devices = [args.require or dev.type] * args.children
        check("spawn", got["hits"] == got["world_total"] == hits
              and got["total"] == total
              and got["pi"] == 4.0 * np.float64(hits) / total
              and got["devices"] == want_devices,
              children=args.children, devices=got["devices"], pi=got["pi"])
    else:
        check("spawn", got is None)

    with open(os.path.join(args.out, f"rank{r}.json"), "w") as fh:
        json.dump(info, fh)
    mpi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
