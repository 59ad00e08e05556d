"""One SPMD world across processes, checked and timed: the program each
simulated host runs.  Start it through the simulated-host launcher::

    python -m mpi_tpu_torch.gpu.multihost -n 2 --devices-per-host 4 \\
        mpi_tpu_torch/examples/multihost_world.py --out DIR --mib 256

    python -m mpi_tpu_torch.gpu.multihost -n 2 --devices-per-host 2 \\
        --device cpu mpi_tpu_torch/examples/multihost_world.py --out DIR \\
        --mib 0.015625 --save-rows

Every process holds L = ``--devices-per-host`` ranks of a world of
P = hosts x L ranks and checks, for its own ranks:

(a) the reference's multi-host program (``tests/test_multihost.py:17-64``)
    on ``global_mesh()``: the fused allreduce of the rank, the ring
    allreduce of ``zeros(8) + rank``, the wrapped ``shift`` and the even/odd
    ``split_by``, exact, every result on this process's device;
(b) the ring kernel across processes (``algorithm="pallas_ring"``):
    allreduce, reduce_scatter and allgather (float32 SUM, ``--mib`` MiB a
    rank) and a bfloat16 MAX allreduce (``--half-mib``).  Every process
    makes the whole P-rank input from ``--seed`` on its device (or reads
    ``--inputs``, an ``.npz`` of ``x`` [P, n] and ``xh`` [P, m] float32);
    its rows must equal, bitwise, the one-process ``run_spmd`` over all P
    ranks on the same device, and the plain version (the gathered world
    through ``ring.*_plain``).  Launch counters are zeroed just before the
    main path and read just after; on the card every peer-pointer mode
    must have launched.  On the card each mode is then timed (median of
    ``--reps``): the call's wall with its barriers, the kernel alone by
    CUDA events, the plain version, and on process 0 (the others wait) the
    one-process kernel over the whole world;
(c) ``hybrid_mesh((1, L), (hosts, 1), ("dcn", "ici"))``: the placement of
    ``tests/test_multihost.py:114-120`` and a fused allreduce over ``dcn``
    equal to the column sums;
(d) with ``--rdv DIR`` (a directory shared by the processes): a host world
    of P socket ranks, L rank threads in each process, where
    ``topology.multihost_node_key`` must give process ids
    (``[0] * L + [1] * L + ...``) and ``split_hierarchical`` intra groups of
    L and a leaders communicator of ``hosts``;
(e) the gradient of a fused SUM across the processes
    (``torch.func.grad`` through ``comm.localize``) and a ring-attention
    forward, each equal to the one-process run's rows; after
    ``multihost.shutdown()`` no IPC mapping is open.

Each process writes ``DIR/proc<q>.json`` (and with ``--save-rows`` its
result rows, ``DIR/proc<q>.pt``); a failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import threading
import time

import numpy as np
import torch

from mpi_tpu_torch import ops, topology
from mpi_tpu_torch.communicator import P2PCommunicator
from mpi_tpu_torch.gpu import multihost, peers, ring, run_spmd
from mpi_tpu_torch.gpu.attention import ring_attention
from mpi_tpu_torch.transport.socket import SocketTransport

HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet
MODES = ("allreduce", "reduce_scatter", "allgather", "allreduce_bf16_max")


def worker_program(comm):
    """``tests/test_multihost.py`` WORKER's ``prog``, in the port's spelling."""
    r = comm.rank
    total = comm.allreduce(r, algorithm="fused")
    ring_sum = comm.allreduce(torch.zeros(8, device=comm.device) + r,
                              algorithm="ring")
    nbr = comm.shift((r * 10.0)[None], offset=1, wrap=True)
    sub = comm.split_by(lambda i: i % 2)
    subtotal = sub.allreduce(r, algorithm="fused")
    return total, ring_sum.sum(), nbr, subtotal[None]


def k1_program(comm, x, xh):
    """The ring kernel's three modes on rank r's row of ``x`` and a
    bfloat16 MAX allreduce of its row of ``xh``."""
    mine = x[comm.rank]
    block = mine.numel() // comm.size
    return (comm.allreduce(mine, algorithm="pallas_ring"),
            comm.reduce_scatter(mine.view(comm.size, block), algorithm="pallas_ring"),
            comm.allgather(mine[:block], algorithm="pallas_ring"),
            comm.allreduce(xh[comm.rank], op=ops.MAX, algorithm="pallas_ring"))


def grad_program(comm, x, w):
    """d/dw of |allreduce(localize(w) * x_r)|^2: the replicated w's
    gradient sums over the ranks (JAX's pvary transpose)."""
    def loss(v):
        s = comm.allreduce(comm.localize(v) * x[comm.rank], algorithm="fused")
        return torch.sum(s * s)
    return torch.func.grad(loss)(w)


def attention_program(comm, q, k, v):
    return ring_attention(q[comm.rank], k[comm.rank], v[comm.rank], comm,
                          causal=True)


def small_inputs(seed, nranks):
    """The gradient's ``x`` [P, 3] and ``w`` [3], and ring attention's
    q [P, 4, 16, 128], k and v [P, 2, 16, 128], from ``seed``."""
    rs = np.random.RandomState(seed)
    gx = torch.from_numpy(rs.randn(nranks, 3).astype(np.float32))
    gw = torch.from_numpy(rs.randn(3).astype(np.float32))
    qkv = [torch.from_numpy(rs.randn(nranks, h, 16, 128).astype(np.float32))
           for h in (4, 2, 2)]
    return gx, gw, qkv


def spread(n_rows, n, gen, device):
    """Random signs and magnitudes from 1e-4 to 1e8: the fold order shows."""
    mag = torch.pow(10.0, torch.empty((n_rows, n), device=device).uniform_(
        -4, 8, generator=gen))
    return torch.randn((n_rows, n), device=device, generator=gen) * mag


def host_world(fn, first, count, size, rdv, device, timeout=120.0):
    """Run ``fn(comm)`` on this process's ranks ``[first, first + count)``
    of a ``size``-rank host world of socket transports (one thread a
    rank), the others living in the other processes."""
    results, errors, transports = [None] * count, [], [None] * count

    def runner(i):
        try:
            t = SocketTransport(first + i, size, rdv, device=device)
            transports[i] = t
            results[i] = fn(P2PCommunicator(t, range(size)))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=runner, args=(i,), daemon=True)
               for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    for t in transports:
        if t is not None:
            t.close()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError("host-world ranks did not finish")
    return results


def same(a, b):
    """Equal shapes and values, NaN where the other has NaN."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_wall(fn, dev, reps):
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _median_events(fn, reps):
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--mib", type=float, default=1.0,
                    help="MiB of float32 a rank for the ring modes")
    ap.add_argument("--half-mib", type=float, default=None,
                    help="MiB of bfloat16 a rank for the MAX allreduce "
                         "(default: a quarter of --mib)")
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rdv", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--save-rows", action="store_true")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    check(multihost.auto_init(), "the simulated-host launcher's environment is missing")
    dev = multihost.device()
    nprocs, q = multihost.process_count(), multihost.process_index()
    L = multihost.local_rank_count()
    P = nprocs * L
    mesh = multihost.global_mesh()
    comm = mesh.comm("world")
    first, count = comm.span
    mine = slice(first, first + count)
    ranks = torch.arange(first, first + count)
    rec = {"process": q, "processes": nprocs, "ranks": P, "first": first,
           "count": count, "device": str(dev), "init_s": time.perf_counter() - t_start}
    rows = {}

    # (a) the reference's multi-host program ---------------------------------
    total, ring_sum, nbr, subtotal = run_spmd(worker_program, comm=comm)
    check(all(t.device.type == dev.type for t in (total, ring_sum, nbr, subtotal)),
          "a result left the process's device")
    check(total.shape[0] == count and total.cpu().eq(P * (P - 1) // 2).all(),
          f"fused allreduce of the rank: {total.tolist()}")
    check(ring_sum.cpu().eq(8 * P * (P - 1) // 2).all(), f"ring allreduce: {ring_sum.tolist()}")
    check(torch.equal(nbr.cpu()[:, 0], ((ranks - 1) % P) * 10.0), f"shift: {nbr.tolist()}")
    parity = [sum(r for r in range(P) if r % 2 == w % 2) for w in range(first, first + count)]
    check(subtotal.cpu()[:, 0].tolist() == parity, f"split_by: {subtotal.tolist()}")
    rows["worker"] = [t.cpu() for t in (total, ring_sum, nbr, subtotal)]
    rec["worker"] = {"total": total.tolist(), "ring_sum": ring_sum.tolist(),
                     "shift": nbr[:, 0].tolist(), "split_total": subtotal[:, 0].tolist()}

    # (b) the ring kernel across processes -----------------------------------
    if args.inputs:
        data = np.load(args.inputs)
        x = torch.from_numpy(data["x"]).to(dev)
        xh = torch.from_numpy(data["xh"]).to(dev, torch.bfloat16)
    else:
        n = int(args.mib * (1 << 20)) // 4 // P * P
        m = int((args.half_mib if args.half_mib is not None else args.mib / 4)
                * (1 << 20)) // 2
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        x = spread(P, n, gen, dev)
        xh = spread(P, m, gen, dev).to(torch.bfloat16)
    _sync(dev)
    rec["inputs_s"] = time.perf_counter() - t_start - rec["init_s"]
    ring.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    got = run_spmd(k1_program, x, xh, comm=comm)
    _sync(dev)
    rec["main_path_s"] = time.perf_counter() - t0
    rec["launches"] = {f"ring_{k}_ptrs": c for k, c in ring.PEER_LAUNCHES.items()}
    if dev.type == "cuda":
        check(all(rec["launches"].values()),
              f"the main path never launched a peer-pointer mode: {rec['launches']}")
    one = run_spmd(k1_program, x, xh, nranks=P, device=dev)
    block = x.shape[1] // P
    ex = peers.exchange(dev)
    local_in = {"allreduce": x[mine].contiguous(),
                "reduce_scatter": x[mine].reshape(count, P, block).contiguous(),
                "allgather": x[mine, :block].contiguous(),
                "allreduce_bf16_max": xh[mine].contiguous()}
    plain_of = {
        "allreduce": lambda: ring.peers_plain(local_in["allreduce"], ex, first, "allreduce"),
        "reduce_scatter": lambda: ring.peers_plain(local_in["reduce_scatter"], ex, first,
                                                   "reduce_scatter"),
        "allgather": lambda: ring.peers_plain(local_in["allgather"], ex, first, "allgather"),
        "allreduce_bf16_max": lambda: ring.peers_plain(local_in["allreduce_bf16_max"], ex,
                                                       first, "allreduce", op="max")}
    k1 = {}
    for mode, g_rows, o_rows in zip(MODES, got, one):
        check(g_rows.shape[0] == count, f"{mode}: {tuple(g_rows.shape)} rows")
        check(same(g_rows, o_rows[mine]), f"{mode}: rows differ from the one-process run")
        plain = plain_of[mode]()
        check(same(g_rows, plain), f"{mode}: rows differ from the plain version")
        k1[mode] = {"shape": list(g_rows.shape), "dtype": str(g_rows.dtype).split(".")[-1],
                    "max_abs_err": float((g_rows.float() - plain.float()).nan_to_num(0.0)
                                         .abs().max()),
                    "staging_bytes": local_in[mode].numel() * local_in[mode].element_size()}
        rows[mode] = g_rows.cpu()
        del plain
    del got, one

    if dev.type == "cuda":
        import torch.distributed as dist

        one_process_of = {
            "allreduce": lambda: ring.allreduce_world(x),
            "reduce_scatter": lambda: ring.reduce_scatter_world(x.view(P, P, block)),
            "allgather": lambda: ring.allgather_world(x[:, :block].contiguous()),
            "allreduce_bf16_max": lambda: ring.allreduce_world(xh, op="max")}
        for mode, one_process in one_process_of.items():
            loc = local_in[mode]
            kmode, op = mode.split("_bf16")[0], "max" if "max" in mode else "sum"
            wall = _median_wall(lambda: ring.peers_world(loc, ex, first, kmode, op=op),
                                dev, args.reps)
            with ex.peer_rows(loc) as ptrs:
                kern = _median_events(lambda: ring.launch_peers(
                    ptrs, loc, first, None, kmode, op), args.reps)
            plain_ms = _median_wall(plain_of[mode], dev, 1)
            one_ms = None
            if q == 0:
                one_ms = _median_events(one_process, args.reps)
            dist.barrier()
            item = loc.element_size()
            elems = loc[0].numel()
            if kmode == "allreduce":   # one group: g reads per element, count rows out
                reads, writes = P * elems, count * elems
            elif kmode == "reduce_scatter":  # g blocks per owned chunk
                reads, writes = P * count * block, count * block
            else:                      # every block once, g blocks per row out
                reads, writes = P * elems, count * P * elems
            nbytes = (reads + writes) * item
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            k1[mode].update({"wall_ms": wall, "kernel_ms": kern, "plain_ms": plain_ms,
                             "one_process_ms": one_ms, "bytes": nbytes,
                             "bound_ms": bound, "pct_of_bound": 100.0 * bound / kern})
    rec["k1"] = k1

    # (c) the hybrid mesh ------------------------------------------------------
    hmesh = multihost.hybrid_mesh((1, L), (nprocs, 1), ("dcn", "ici"))
    check(hmesh.shape == {"dcn": nprocs, "ici": L}, f"hybrid shape {hmesh.shape}")
    procs = hmesh.process_index
    for d in range(nprocs):
        check(all(procs[d, 0] == procs[d, i] for i in range(L)), f"ici line {d}: {procs}")
    for i in range(L):
        check(len(set(procs[:, i].tolist())) == nprocs, f"dcn line {i}: {procs}")
    # the rank at grid position (d, i) takes x[d, i]: along dcn its rank is
    # d, and its group (the dcn line) is column i
    grid = np.arange(P, dtype=np.float32).reshape(nprocs, L)
    cols = run_spmd(lambda c, x: c.allreduce(x[c.rank, c.group_id], algorithm="fused"),
                    grid, comm=hmesh.comm("dcn"))
    col_of = {int(w): i for (_, i), w in np.ndenumerate(hmesh.ranks)}
    want = [float(grid[:, col_of[w]].sum()) for w in range(first, first + count)]
    check(cols.cpu().tolist() == want, f"dcn allreduce {cols.tolist()} != {want}")
    rec["hybrid"] = {"ranks": hmesh.ranks.tolist(), "process_index": procs.tolist(),
                     "dcn_allreduce": cols.tolist()}

    # (d) the node key of a host world across the processes -------------------
    if args.rdv:
        def keys(c):
            key = topology.multihost_node_key(c)
            intra, leaders, node_of = topology.split_hierarchical(c, key)
            return ([key(r) for r in range(c.size)], intra.size,
                    None if leaders is None else leaders.size, node_of)
        got_keys = host_world(keys, first, count, P, args.rdv, dev)
        expect = [r // L for r in range(P)]
        for i, (table, intra, leaders, node_of) in enumerate(got_keys):
            check(table == expect and node_of == expect, f"node key {table} != {expect}")
            check(intra == L, f"intra group of {intra}")
            check(leaders == (nprocs if i == 0 else None), f"leaders {leaders}")
        rec["node_key"] = got_keys[0][0]

    # (e) a gradient and ring attention across the processes -------------------
    gx, gw, qkv = small_inputs(args.seed, P)
    grad = run_spmd(grad_program, gx, gw, comm=comm)
    grad_one = run_spmd(grad_program, gx, gw, nranks=P, device=dev)
    check(torch.equal(grad, grad_one[mine]), "the gradient differs from one process")
    rows["grad"] = grad.cpu()
    att = run_spmd(attention_program, *qkv, comm=comm)
    att_one = run_spmd(attention_program, *qkv, nranks=P, device=dev)
    check(torch.equal(att, att_one[mine]), "ring attention differs from one process")
    rows["attention"] = att.cpu()
    rec["stats"] = peers.stats(dev)
    rec["stats"]["open_mappings"] = peers.open_mappings()
    multihost.shutdown()
    rec["open_mappings_after"] = peers.open_mappings()
    check(rec["open_mappings_after"] == 0, "an IPC mapping is still open")
    rec["seconds"] = time.perf_counter() - t_start
    os.makedirs(args.out, exist_ok=True)
    if args.save_rows:
        torch.save(rows, os.path.join(args.out, f"proc{q}.pt"))
    tmp = os.path.join(args.out, f".proc{q}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, os.path.join(args.out, f"proc{q}.json"))
    print(f"MULTIHOST-OK proc={q} ranks={first}..{first + count - 1} of {P} "
          f"on {dev} in {rec['seconds']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
