"""The same-host data plane on shm rank processes: the native rings, the
collective arena, compressed slot writes and the windows.  Run under the
launcher, one process per rank:

    python -m mpi_tpu_torch.launcher -n 4 --backend shm mpi_tpu_torch/examples/host_shm.py --out DIR
    python -m mpi_tpu_torch.launcher -n 4 --backend shm --device cpu mpi_tpu_torch/examples/host_shm.py --out DIR --mib 4
    python -m mpi_tpu_torch.launcher -n 4 --backend shm --verify mpi_tpu_torch/examples/host_shm.py --out DIR

Every rank draws its float32 inputs from ``(--seed, rank)`` on its device:

1. a ``--mib`` MiB ring allreduce over the rings (one call, whose pickled
   bytes are recorded, then 1 warm-up and ``--iters`` timed calls, the
   slowest rank's seconds), bitwise against rank 0's and within rtol
   1e-5, atol 1e-5 of a float64 sum of every rank's regenerated input;
2. every arena collective with ``algorithm="sm"`` at 1 KiB (the flat
   path), 32 KiB (the eager edge) and 1 MiB (the block in-place path):
   allreduce, reduce, bcast, allgather, alltoall, scan, reduce_scatter and
   barrier, each against a float64 (or exact) oracle, with the
   ``coll_sm_hits`` and ``coll_sm_bytes`` pvars they moved (above the
   eager gate, 32 KiB, reduce declines to the binomial tree on every rank,
   as in the reference);
3. a 16 MiB allreduce (above a slot at 4 ranks) that the arena declines on
   every rank together (``coll_sm_fallbacks`` moves by one) and that the
   wire algorithms still sum right;
4. ``compressed:bf16`` through the arena's encoded slots (one hit; within
   one bf16 rounding of each input of the float64 sum);
5. a ``SharedWindow``: each rank writes its region, a barrier, each reads
   every peer's region;
6. a ``P2PWindow`` over a tensor on the rank's device: put, get and
   accumulate in one fence epoch, a passive-target ``lock`` / ``unlock``
   and ``fetch_and_op``, each against its oracle; the window's buffer stays
   on the device;
7. a steered receive (``examples/host_dynamic.py steer_turns``): rank 1
   posts ``irecv(source=0, buf=<a --mib MiB float32 tensor on its
   device>)`` before rank 0 sends its input, and the shm drain lands the
   frame in the buffer itself (on the card through pinned staging and one
   host-to-device copy): bitwise, the same ``data_ptr``,
   ``recv_user_inplace`` +1, ``recv_user_fallbacks`` +0; and the same
   receive with the ``recv_steering`` cvar off (the completion's copy
   path), the two in turns (steered, copy, copy, steered) after one
   untimed steered receive.

With ``--profile-dir DIR`` rank 0 runs one more ring call and the 1 KiB
arena collectives (the arena's first use) under ``profiling.trace``
(``DIR/ring``, ``DIR/arena_1024``) and records what each trace says of
the device (``profiling.trace_summary``) and the torch ops' own host time.

Under ``--verify`` the verifier must report nothing and every ``verify_*``
pvar but ``verify_clock_bytes`` must read 0; its signature frames are the
only messages of the arena collectives, and the ring's pickled bytes are
those signatures alone.  Each rank writes
``DIR/rank<r>.json``; any failed check raises, so the rank (and the
launcher) exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import time

import torch

import mpi_tpu_torch
from mpi_tpu_torch import coll_sm, mpit, ops, profiling


def rank_input(rank: int, numel: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + rank)
    return torch.randn(numel, generator=gen, device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _digest(t: torch.Tensor) -> str:
    host = t.detach().cpu().contiguous().view(torch.uint8)
    return hashlib.sha1(host.numpy().tobytes()).hexdigest()


def _pvars(names):
    return {k: mpit.pvar_read(k) for k in names}


def _delta(before):
    return {k: mpit.pvar_read(k) - v for k, v in before.items()}


def _profiled(comm, args, name: str, fn):
    """``fn()``; with ``--profile-dir``, rank 0 runs it under
    ``profiling.trace`` and returns (result, the trace's summary)."""
    if not args.profile_dir or comm.rank != 0:
        return fn(), None
    trace_dir = os.path.join(args.profile_dir, name)
    t0 = time.perf_counter()
    with profiling.trace(trace_dir) as prof:
        out = fn()
        _sync(comm.device)
    wall = time.perf_counter() - t0
    summary = profiling.trace_summary(os.path.join(trace_dir,
                                                   profiling.TRACE_FILE))
    summary["by_name"] = summary["by_name"][:8]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    summary["host_ops"] = [[e.key, e.count, e.self_cpu_time_total / 1e3]
                           for e in host[:8]]
    summary["wall_ms"] = wall * 1e3
    return out, summary


def ring_leg(comm, args, rec) -> None:
    dev = comm.device
    numel = (args.mib << 20) // 4
    x = rank_input(comm.rank, numel, args.seed, dev)
    before = mpit.pvar_read("bytes_pickled_sent")
    comm.allreduce(x, algorithm="ring")
    pickled = mpit.pvar_read("bytes_pickled_sent") - before
    secs = []
    out = None
    for i in range(args.iters + 1):
        comm.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        out = comm.allreduce(x, algorithm="ring")
        _sync(dev)
        if i:
            secs.append(time.perf_counter() - t0)
    secs = [max(ts[i] for ts in comm.allgather(secs))
            for i in range(len(secs))]
    want = torch.zeros(numel, dtype=torch.float64, device=dev)
    for r in range(comm.size):
        want += rank_input(r, numel, args.seed, dev).double()
    err = float((out.double() - want).abs().max())
    if not torch.allclose(out.double(), want, rtol=1e-5, atol=1e-5):
        raise RuntimeError(f"ring allreduce off the float64 sum by {err}")
    digests = comm.allgather(_digest(out))
    if len(set(digests)) != 1:
        raise RuntimeError(f"ring allreduce differs across ranks: {digests}")
    rec["ring"] = {"bytes_per_rank": numel * 4, "s": secs,
                   "median_ms": statistics.median(secs) * 1e3,
                   "pickled_bytes": pickled, "max_abs_err_vs_f64": err,
                   "device": str(out.device)}
    if args.profile_dir:
        comm.barrier()
        _sync(dev)
        again, rec["ring"]["profile"] = _profiled(
            comm, args, "ring", lambda: comm.allreduce(x, algorithm="ring"))
        if not torch.equal(again, out):
            raise RuntimeError("the profiled ring call differs")


def arena_leg(comm, args, rec) -> None:
    dev, p, r = comm.device, comm.size, comm.rank
    names = ("coll_sm_hits", "coll_sm_bytes", "coll_sm_fallbacks",
             "msgs_sent")
    rec["arena"] = {}
    for nbytes in (1 << 10, 32 << 10, 1 << 20):
        n = nbytes // 4
        xs = [rank_input(q, n, args.seed + 11, dev) for q in range(p)]
        x = xs[r]
        want = sum(v.double() for v in xs)
        calls = {
            "allreduce": lambda: comm.allreduce(x, algorithm="sm"),
            "reduce": lambda: comm.reduce(x, root=p - 1, algorithm="sm"),
            "bcast": lambda: comm.bcast(x if r == 0 else None, root=0,
                                        algorithm="sm"),
            "allgather": lambda: comm.allgather(x, algorithm="sm"),
            "alltoall": lambda: comm.alltoall(x.view(p, -1), algorithm="sm"),
            "scan": lambda: comm.scan(x, algorithm="sm"),
            "reduce_scatter": lambda: comm.reduce_scatter(x.view(p, -1),
                                                          algorithm="sm"),
            "barrier": lambda: comm.barrier(algorithm="sm")}

        def run_all():
            got, ms = {}, {}
            for name, call in calls.items():
                t = time.perf_counter()
                got[name] = call()
                _sync(dev)
                ms[name] = (time.perf_counter() - t) * 1e3
            return got, ms

        b0 = _pvars(names)
        t0 = time.perf_counter()
        (got, ms), profile = _profiled(comm, args, f"arena_{nbytes}", run_all) \
            if nbytes == 1 << 10 else (run_all(), None)
        wall = time.perf_counter() - t0
        d = _delta(b0)
        checks = {
            "allreduce": torch.allclose(got["allreduce"].double(), want,
                                        rtol=1e-5, atol=1e-5),
            "reduce": (got["reduce"] is None if r != p - 1 else
                       torch.allclose(got["reduce"].double(), want,
                                      rtol=1e-5, atol=1e-5)),
            "bcast": torch.equal(got["bcast"], xs[0]),
            "allgather": torch.equal(got["allgather"], torch.stack(xs)),
            "alltoall": torch.equal(got["alltoall"], torch.stack(
                [v.view(p, -1)[r] for v in xs])),
            "scan": torch.allclose(got["scan"].double(),
                                   sum(v.double() for v in xs[:r + 1]),
                                   rtol=1e-5, atol=1e-5),
            "reduce_scatter": torch.allclose(
                got["reduce_scatter"].double(), want.view(p, -1)[r],
                rtol=1e-5, atol=1e-5)}
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise RuntimeError(f"arena at {nbytes} bytes: {bad} wrong")
        # above the eager gate reduce takes the binomial tree (declined
        # inside the arena on every rank), the other seven stay
        eager = nbytes <= coll_sm._EAGER_BYTES
        if (d["coll_sm_hits"] != (8 if eager else 7)
                or d["coll_sm_fallbacks"] != (0 if eager else 1)
                or (eager and comm._verify is None and d["msgs_sent"])):
            raise RuntimeError(f"arena at {nbytes} bytes: {d}")
        if not all(v.device == x.device for v in (
                got["allreduce"], got["bcast"], got["scan"],
                got["reduce_scatter"], got["alltoall"])):
            raise RuntimeError("an arena result left the payload's device")
        rec["arena"][str(nbytes)] = dict(d, wall_ms=wall * 1e3, ms=ms)
        if profile is not None:
            rec["arena"][str(nbytes)]["profile"] = profile
    # a payload above a slot declines on every rank together
    n = (16 << 20) // 4
    xs = [rank_input(q, n, args.seed + 12, dev) for q in range(p)]
    b0 = _pvars(names)
    out = comm.allreduce(xs[r], algorithm="sm")
    d = _delta(b0)
    if d["coll_sm_fallbacks"] != 1 or d["coll_sm_hits"]:
        raise RuntimeError(f"16 MiB decline not counted once: {d}")
    want = sum(v.double() for v in xs)
    if not torch.allclose(out.double(), want, rtol=1e-5, atol=1e-5):
        raise RuntimeError("the declined 16 MiB allreduce summed wrong")
    rec["decline_16MiB"] = d
    # compressed:bf16 through the arena's encoded slots
    n = 1024
    xs = [rank_input(q, n, args.seed + 13, dev) for q in range(p)]
    b0 = _pvars(names + ("bytes_compressed_saved",))
    out = comm.allreduce(xs[r], algorithm="compressed:bf16")
    d = _delta(b0)
    want = sum(v.double() for v in xs)
    bound = 2 * 2.0 ** -8 * float(want.abs().max()) + p * 2.0 ** -8 * max(
        float(v.abs().max()) for v in xs)
    err = float((out.double() - want).abs().max())
    if (d["coll_sm_hits"] != 1 or err > bound
            or (comm._verify is None and d["msgs_sent"])):
        raise RuntimeError(f"compressed arena allreduce: {d}, err {err} > "
                           f"{bound}?")
    rec["compressed_bf16_arena"] = dict(d, max_abs_err_vs_f64=err,
                                        bound=bound)


def window_leg(comm, args, rec) -> None:
    dev, p, r = comm.device, comm.size, comm.rank
    # shared window: host memory every rank maps
    win = mpi_tpu_torch.win_allocate_shared(comm, 4, torch.float32)
    shared_path = win._path
    win.local.copy_(torch.arange(4.0) + 10 * r)
    win.fence()
    peers = [win.remote(q).clone() for q in range(p)]
    win.free()
    if not all(torch.equal(peers[q], torch.arange(4.0) + 10 * q)
               for q in range(p)):
        raise RuntimeError(f"shared window regions read wrong: {peers}")
    # one-sided window over a tensor on the rank's device
    w = comm.win_create(torch.zeros(4, device=dev))
    right, left = (r + 1) % p, (r - 1) % p
    w.put(torch.full((4,), float(r + 1), device=dev), right)
    fut = w.get(right)
    w.accumulate(torch.ones(4, device=dev), right, op=ops.SUM)
    w.fence()
    got = fut.value
    if not (torch.equal(w.local, torch.full((4,), left + 2.0, device=dev))
            and torch.equal(got, torch.full((4,), r + 2.0, device=dev))
            and w.local.device == torch.device(dev)):
        raise RuntimeError(f"fence epoch wrong: local {w.local}, got {got}")
    comm.barrier()
    w.lock(0)
    w.accumulate_at(0, torch.full((4,), 1.0, device=dev))
    w.unlock(0)
    comm.barrier()
    old = w.fetch_and_op(0, torch.full((4,), 100.0, device=dev))
    comm.barrier()
    olds = sorted(float(v) for v in comm.allgather(float(old[0])))
    base = 2.0 + (p - 1) + p  # epoch value at rank 0, plus the locked adds
    if olds != [base + 100.0 * i for i in range(p)]:
        raise RuntimeError(f"fetch_and_op pre-images {olds}")
    final = float(w.local[0]) if r == 0 else None
    comm.barrier()
    w.free()
    if r == 0 and final != base + 100.0 * p:
        raise RuntimeError(f"rank 0's window ended at {final}")
    rec["windows"] = {"shared": "ok", "shared_path": shared_path,
                      "p2p_device": str(got.device),
                      "fetch_and_op_pre_images": olds}


def steer_leg(comm, args, rec) -> None:
    from mpi_tpu_torch.examples.host_dynamic import steer_turns

    numel = (args.mib << 20) // 4
    x = rank_input(comm.rank, numel, args.seed, comm.device)
    want = rank_input(0, numel, args.seed, comm.device) \
        if comm.rank == 1 else None
    got = steer_turns(comm, x, want, 60)
    if comm.rank == 1:
        # the warm-up receive is held to the steered check too
        bad = [side for side, g in got.items() if not g["ok"]]
        if bad:
            raise RuntimeError(f"{bad} receive failed its check: {got}")
        rec["steer"] = got


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for rank<r>.json")
    ap.add_argument("--mib", type=int, default=256,
                    help="MiB per rank of the ring allreduce")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-dir", default=None,
                    help="rank 0 profiles a ring call and the 1 KiB arena "
                         "collectives into this directory")
    args = ap.parse_args(argv)
    marks = {"main": time.time()}  # wall-clock marks of this process's life
    comm = mpi_tpu_torch.init()
    marks["init"] = time.time()
    if type(comm._t).__name__ != "ShmTransport":
        raise RuntimeError("run under the launcher's --backend shm")
    # the session names every /dev/shm segment of this world
    rec = {"rank": comm.rank, "size": comm.size, "device": str(comm.device),
           "session": comm._t._session, "verify": comm._verify is not None}
    t0 = time.perf_counter()
    ring_leg(comm, args, rec)
    arena_leg(comm, args, rec)
    window_leg(comm, args, rec)
    steer_leg(comm, args, rec)
    rec["wall_s"] = time.perf_counter() - t0
    marks["work"] = time.time()
    if comm._verify is not None:
        from mpi_tpu_torch import verify

        problems = verify.finalize_report()
        rec["verify_problems"] = problems
        hot = {p: mpit.pvar_read(p) for p in mpit.pvar_list()
               if p.startswith("verify_") and p != "verify_clock_bytes"
               and mpit.pvar_read(p)}
        if problems or hot:
            raise RuntimeError(f"verifier not clean: {problems} {hot}")
    mpi_tpu_torch.finalize()
    marks["finalize"] = time.time()
    rec["marks"] = marks
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main()
