"""The port's shared-memory collective arena (``mpi_tpu_torch/coll_sm.py``)
against the reference's (``mpi_tpu/coll_sm.py``): every arena collective
on shm rank threads (``transport.shm.run_shm``) bitwise against the
reference's shm world on the same seeded inputs, across group sizes, ops
and the flat / block-in-place boundary; the group-coherent decline
(object, ragged, oversized and mismatched payloads); the compressed slot
path; the copy contract (zero frames, zero pickled bytes, at most two
copies per rank); and the arena's lifecycle, gate and fault tolerance.
The checklist is ``tests/test_coll_sm.py``; ``:517`` (hierarchical
splits) is held in ``tests/test_torch_hierarchical.py``, and the pooled
lease arenas (``:414``) here and through a serve pool in
``tests/test_torch_host_ref_serve.py``."""

import glob
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from mpi_tpu import mpit as ref_mpit
from mpi_tpu import ops as ref_ops
from mpi_tpu_torch import coll_sm, ft, mpit, ops
from mpi_tpu_torch.communicator import P2PCommunicator
from mpi_tpu_torch.errors import ProcFailedError
from mpi_tpu_torch.native import load_shmring
from mpi_tpu_torch.transport.local import run_local
from mpi_tpu_torch.transport.shm import ShmTransport, run_shm
from tests.test_shm_backend import run_shm_world as ref_run_shm
from tests.test_torch_host_local import assert_same, to_torch

NRANKS = [2, 3, 4, 5]


def port_shm(fn, p, **kw):
    kw.setdefault("timeout", 60)
    return run_shm(fn, p, device="cpu", ring_bytes=256 * 1024, **kw)


def both(prog, n):
    """``prog(comm, mk, ops)`` in both packages' shm worlds, bitwise."""
    ref = ref_run_shm(lambda c: prog(c, np.array, ref_ops), n)
    got = port_shm(lambda c: prog(c, to_torch, ops), n)
    assert_same(ref, got)
    return got


def deltas(names, fn):
    base = {k: mpit.pvar_read(k) for k in names}
    out = fn()
    return out, {k: mpit.pvar_read(k) - base[k] for k in names}


# -- parity ------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["sm", "auto"])
@pytest.mark.parametrize("n", NRANKS)
def test_allreduce_flat_and_block_bitwise(algo, n):
    for nelem in (1, 7, 1 << 10, (coll_sm._EAGER_BYTES // 8) + 13):
        data = [np.random.RandomState(100 * n + i).randn(nelem)
                for i in range(n)]
        both(lambda c, mk, o: c.allreduce(mk(data[c.rank]), o.SUM,
                                          algorithm=algo), n)


@pytest.mark.parametrize("opname", ["max", "min", "prod", "band"])
def test_allreduce_ops_bitwise(opname):
    rng = np.random.RandomState(4)
    data = (rng.randint(0, 100, (3, 300)) if opname == "band"
            else rng.randn(3, 300).astype(np.float32))
    both(lambda c, mk, o: c.allreduce(mk(data[c.rank]), o.BY_NAME[opname],
                                      algorithm="sm"), 3)


def test_scalars_ride_the_arena():
    got = port_shm(lambda c: (c.allreduce(float(c.rank), ops.MAX,
                                          algorithm="sm"),
                              c.allreduce(float(c.rank + 1), algorithm="sm")),
                   4)
    for mx, s in got:
        assert float(mx) == 3.0 and float(s) == 10.0 and mx.dim() == 0


def test_bcast_reduce_allgather_barrier_reduce_scatter_bitwise():
    n = 4
    data = np.random.RandomState(5).randn(n, 9)

    def prog(c, mk, o):
        out = [c.bcast(mk(data[0]) if c.rank == 0 else None, root=0,
                       algorithm="sm"),
               c.reduce(mk(data[c.rank]), o.SUM, root=2, algorithm="sm"),
               c.allgather(mk(data[c.rank]), algorithm="sm")]
        c.barrier(algorithm="sm")
        out.append(c.reduce_scatter(mk(np.tile(data[c.rank], (c.size, 1))),
                                    o.SUM, algorithm="sm"))
        return out

    h0 = mpit.pvar_read("coll_sm_hits")
    both(prog, n)
    assert mpit.pvar_read("coll_sm_hits") - h0 == 5 * n


@pytest.mark.parametrize("algo", ["sm", "auto"])
@pytest.mark.parametrize("n", NRANKS)
def test_alltoall_and_scan_bitwise(algo, n):
    data = [np.random.RandomState(30 * n + i).randn(17) for i in range(n)]

    def prog(c, mk, o):
        blocks = [mk(np.full(9, c.rank * 100.0 + d)) for d in range(c.size)]
        stacked = mk(np.stack([np.full(9, c.rank * 100.0 + d)
                               for d in range(c.size)]))
        return [c.alltoall(blocks, algorithm=algo),
                c.alltoall(stacked, algorithm=algo),
                c.scan(mk(data[c.rank]), o.SUM, algorithm=algo)]

    both(prog, n)


def test_arena_results_live_on_the_payloads_device():
    got = port_shm(lambda c: c.allreduce(torch.ones(3, dtype=torch.float64),
                                         algorithm="sm"), 2)
    assert all(g.dtype == torch.float64 and g.device.type == "cpu"
               for g in got)


# -- the group-coherent decline --------------------------------------------


def test_allgather_ragged_rides_object_declines():
    def prog(c, mk, o):
        return [c.allgather(mk(np.arange(c.rank + 1.0)), algorithm="sm"),
                c.allgather({"r": c.rank}, algorithm="sm")]

    f0 = mpit.pvar_read("coll_sm_fallbacks")
    both(prog, 3)
    assert mpit.pvar_read("coll_sm_fallbacks") - f0 == 3  # object leg


def test_alltoall_object_and_ragged_fall_back():
    def prog(c, mk, o):
        got = c.alltoall([{"from": c.rank, "to": d} for d in range(c.size)])
        ragged = c.alltoall([mk(np.arange(d + 1.0)) for d in range(c.size)])
        return [g["from"] for g in got], ragged

    both(prog, 3)


def test_mismatched_geometry_and_oversized_payloads_decline():
    def prog(c, mk, o):
        arena_cap = (8 << 20) // c.size
        big = mk(np.ones(arena_cap // 8 + 64))
        drift = mk(np.arange(1.0, 5.0) * (c.rank + 1)
                   if c.rank == 0 else np.arange(1, 5) * (c.rank + 1))
        return [c.allreduce(big, algorithm="sm")[:3],
                c.allgather(drift, algorithm="sm")]

    f0 = mpit.pvar_read("coll_sm_fallbacks")
    both(prog, 2)
    assert mpit.pvar_read("coll_sm_fallbacks") - f0 == 2  # the big one


def test_reduce_scatter_dtype_drift_declines_together():
    def prog(c):
        dtype = torch.float64 if c.rank == 0 else torch.int64
        blocks = [torch.arange(1, 5, dtype=dtype) * (c.rank + 1)
                  for _ in range(c.size)]
        return c.reduce_scatter(blocks, op=ops.SUM, algorithm="sm")

    f0 = mpit.pvar_read("coll_sm_fallbacks")
    for res in port_shm(prog, 2):
        assert torch.equal(res.to(torch.float64),
                           torch.arange(1, 5, dtype=torch.float64) * 3)
    assert mpit.pvar_read("coll_sm_fallbacks") - f0 == 2


# -- the compressed slot path --------------------------------------------------


@pytest.mark.parametrize("algo", ["compressed:bf16", "compressed:int8"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_allreduce_wire_slot_path_bitwise(algo, n):
    data = [np.random.RandomState(7 * n + i).randn(600).astype(np.float32)
            for i in range(n)]
    names = ("coll_sm_hits", "msgs_sent", "bytes_raw_sent")
    _, d = deltas(names, lambda: both(
        lambda c, mk, o: c.allreduce(mk(data[c.rank]), algorithm=algo), n))
    assert d["coll_sm_hits"] == n
    assert d["msgs_sent"] == 0 and d["bytes_raw_sent"] == 0


def test_allreduce_wire_mixed_encodings_decline_together():
    def prog(c):
        algo = "compressed:bf16" if c.rank == 0 else "compressed:int8"
        return c.allreduce(torch.full((8,), 1.0 + c.rank), algorithm=algo)

    f0 = mpit.pvar_read("coll_sm_fallbacks")
    with pytest.raises(RuntimeError, match="wire frame"):
        # the arena declines on every rank together; the wire ring then
        # refuses the other rank's encoding with a typed error
        port_shm(prog, 2, timeout=30)
    assert mpit.pvar_read("coll_sm_fallbacks") - f0 == 2


# -- the copy contract --------------------------------------------------------


def test_flat_path_zero_frames_zero_pickle_two_copies():
    n, nelem = 4, 1 << 9
    data = [np.random.RandomState(i).randn(nelem) for i in range(n)]
    names = ("msgs_sent", "bytes_pickled_sent", "payload_copies",
             "coll_sm_hits", "coll_sm_bytes", "bytes_raw_sent")
    _, d = deltas(names, lambda: port_shm(
        lambda c: c.allreduce(to_torch(data[c.rank]), algorithm="sm"), n))
    assert d["msgs_sent"] == d["bytes_pickled_sent"] == d["bytes_raw_sent"] == 0
    assert d["coll_sm_hits"] == n
    assert d["coll_sm_bytes"] >= n * nelem * 8
    assert d["payload_copies"] <= 2 * n


def test_block_path_and_alltoall_scan_copy_contract():
    n = 3
    nelem = coll_sm._EAGER_BYTES // 8 * 4  # 4x eager: the block path

    def prog(c):
        c.allreduce(torch.ones(nelem, dtype=torch.float64), algorithm="sm")
        c.alltoall([torch.full((64,), float(c.rank * 10 + d))
                    for d in range(c.size)], algorithm="sm")
        c.scan(torch.full((64,), float(c.rank)), algorithm="sm")
        return True

    names = ("msgs_sent", "bytes_pickled_sent", "payload_copies",
             "coll_sm_hits")
    _, d = deltas(names, lambda: port_shm(prog, n))
    assert d["msgs_sent"] == 0 and d["bytes_pickled_sent"] == 0
    assert d["coll_sm_hits"] == 3 * n
    assert d["payload_copies"] <= 2 * 3 * n


def test_barrier_is_message_free():
    def prog(c):
        for _ in range(10):
            c.barrier()
        return True

    _, d = deltas(("msgs_sent",), lambda: port_shm(prog, 3))
    assert d["msgs_sent"] == 0


# -- gate and lifecycle --------------------------------------------------------


def test_local_rejects_sm_with_the_references_gate_error():
    from mpi_tpu.transport.local import run_local as ref_run_local

    def prog(c, mk):
        msgs = {}
        for coll, call in {
            "allreduce": lambda: c.allreduce(mk(np.ones(4)), algorithm="sm"),
            "bcast": lambda: c.bcast(mk(np.ones(4)), algorithm="sm"),
            "reduce": lambda: c.reduce(mk(np.ones(4)), algorithm="sm"),
            "allgather": lambda: c.allgather(mk(np.ones(4)), algorithm="sm"),
            "barrier": lambda: c.barrier(algorithm="sm"),
            "scan": lambda: c.scan(mk(np.ones(4)), algorithm="sm"),
            "alltoall": lambda: c.alltoall([mk(np.ones(1))] * c.size,
                                           algorithm="sm"),
            "reduce_scatter": lambda: c.reduce_scatter(
                mk(np.ones((c.size, 2))), algorithm="sm"),
        }.items():
            try:
                call()
            except ValueError as e:
                msgs[coll] = str(e)
        return msgs

    ref = ref_run_local(lambda c: prog(c, np.array), 2)
    got = run_local(lambda c: prog(c, to_torch), 2, device="cpu")
    assert len(got[0]) == 8 and got == ref


def test_disjoint_split_children_get_distinct_arenas():
    def prog(c):
        half = c.split(c.rank // 2, key=c.rank)
        out = half.allreduce(torch.full((4,), float(c.rank)), algorithm="sm")
        return float(out[0]), half._coll_sm_arena.name

    res = port_shm(prog, 4)
    assert [r[0] for r in res] == [1.0, 1.0, 5.0, 5.0]
    assert res[0][1] == res[1][1] and res[2][1] == res[3][1]
    assert res[0][1] != res[2][1]
    assert res[0][1].startswith("/mtt_")


def test_arena_refcount_and_unlink_at_finalize():
    seen = {}

    def prog(c):
        c.allreduce(torch.ones(8), algorithm="sm")
        if c.rank == 0:
            seen["live"] = dict(coll_sm.live_arenas())
            seen["file"] = glob.glob("/dev/shm" + c._coll_sm_arena.name)
        c.barrier()
        return True

    assert all(port_shm(prog, 3))
    assert list(seen["live"].values()) == [3]
    assert len(seen["file"]) == 1
    assert coll_sm.live_arenas() == {}
    assert glob.glob(seen["file"][0]) == []


def test_cvar_kill_switch_and_eager_gate():
    old = mpit.cvar_read("coll_sm_arena_bytes")
    try:
        mpit.cvar_write("coll_sm_arena_bytes", 0)
        h0 = mpit.pvar_read("coll_sm_hits")
        for a, b in port_shm(lambda c: (float(c.allreduce(torch.ones(4))[0]),
                                        float(c.allreduce(torch.ones(4),
                                                          algorithm="sm")[0])),
                             2):
            assert a == b == 2.0
        assert mpit.pvar_read("coll_sm_hits") == h0
    finally:
        mpit.cvar_write("coll_sm_arena_bytes", old)
    msgs = []
    for mod in (ref_mpit, mpit):
        for name in ("coll_sm_arena_bytes", "coll_sm_eager_bytes",
                     "shm_write_timeout_s"):
            with pytest.raises(ValueError) as ei:
                mod.cvar_write(name, -1)
            msgs.append(str(ei.value))
    assert msgs[:3] == msgs[3:]


def test_nonblocking_collectives_skip_the_arena():
    def prog(c):
        req = c.iallreduce(torch.full((4,), float(c.rank + 1)))
        c.allreduce(torch.ones(2), algorithm="sm")
        return float(req.wait()[0])

    before = len(coll_sm.live_arenas())
    assert port_shm(prog, 2) == [3.0, 3.0]
    assert len(coll_sm.live_arenas()) == before


def test_retire_pooled_sweeps_lease_arenas_at_finalize():
    """``tests/test_coll_sm.py:414`` with tensors: a communicator stamped
    with the serve lease's ``_coll_sm_pool_ctx`` rides a pooled arena;
    ``retire_pooled`` retires exactly the pooled arenas (every handle
    unlinks) and leaves the per-communicator one to its refcounted close;
    a second sweep finds nothing."""
    seen = {}

    def prog(comm):
        comm.allreduce(torch.ones(4), algorithm="sm")  # per-comm arena
        lease = comm.split(0, key=comm.rank)
        lease._coll_sm_pool_ctx = ("lease-pool", 0)  # the serve stamp
        out = lease.allreduce(torch.full((2,), float(comm.rank)), algorithm="sm")
        pooled = lease._coll_sm_arena
        assert pooled._pooled and not comm._coll_sm_arena._pooled
        if comm.rank == 0:
            seen["file"] = glob.glob("/dev/shm" + pooled.name)
        comm.barrier()
        retired = coll_sm.retire_pooled(comm._t)
        comm.barrier()  # every handle closed before the unlink check
        if comm.rank == 0:
            seen["gone"] = glob.glob("/dev/shm" + pooled.name)
            seen["live"] = dict(coll_sm.live_arenas())
            seen["names"] = (pooled.name, comm._coll_sm_arena.name)
        return float(out[0]), retired, coll_sm.retire_pooled(comm._t)

    res = port_shm(prog, 3)
    assert [r[0] for r in res] == [3.0, 3.0, 3.0]
    assert [r[1] for r in res] == [1, 1, 1], "sweep missed a pooled arena"
    assert [r[2] for r in res] == [0, 0, 0]
    pooled_name, world_name = seen["names"]
    assert len(seen["file"]) == 1 and seen["gone"] == []
    assert world_name in seen["live"] and pooled_name not in seen["live"]
    assert world_name not in coll_sm.live_arenas()  # pruned at finalize


def test_pooled_arena_is_reused_and_retired_by_an_epoch_bump():
    """``coll_sm._pooled_arena``: two lease communicators of one worker set
    under one epoch share one arena (no per-lease segment); a lease under a
    bumped epoch closes and unlinks the stale one and maps a fresh one."""
    def prog(comm):
        names = []
        for job, epoch in ((1, 0), (2, 0), (3, 1)):
            lease = P2PCommunicator(comm._t, comm._group, ("lease", job))
            lease._coll_sm_pool_ctx = ("lease-pool", epoch)
            out = lease.allreduce(torch.ones(2), algorithm="sm")
            names.append((lease._coll_sm_arena.name, float(out[0])))
            comm.barrier()
        stale = glob.glob("/dev/shm" + names[0][0])
        comm.barrier()
        return names, stale, coll_sm.retire_pooled(comm._t)

    for names, stale, retired in port_shm(prog, 2):
        assert names[0] == names[1] != names[2]
        assert [v for _, v in names] == [2.0, 2.0, 2.0]
        assert stale == [] and retired == 1


def test_stale_arena_from_crashed_run_is_not_opened():
    rdv = tempfile.mkdtemp(prefix="mpi_tpu_torch_stale_arena_")
    session = os.path.basename(rdv)
    name = coll_sm._arena_name(session, 0, (0, 1))
    lib = load_shmring()
    stale = lib.shmarena_create(name.encode(), 1 << 16)
    assert stale
    lib.shmflag_post(int(lib.shmarena_addr(stale)) + 64, 999)
    lib.shmarena_close(stale)
    results, errors, transports = [None, None], [], [None, None]

    def runner(r):
        try:
            t = ShmTransport(r, 2, rdv, ring_bytes=256 * 1024, device="cpu")
            transports[r] = t
            comm = P2PCommunicator(t, range(2))
            results[r] = comm.allreduce(torch.full((4,), float(r + 1)),
                                        algorithm="sm")
        except BaseException as e:  # noqa: BLE001
            errors.append((r, e))

    threads = [threading.Thread(target=runner, args=(r,), daemon=True)
               for r in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30.0)
    alive = any(th.is_alive() for th in threads)
    for t in transports:
        if t is not None:
            t.close()
    assert not errors and not alive
    for res in results:
        assert torch.equal(res, torch.full((4,), 3.0))


def test_kill_mid_barrier_raises_proc_failed_within_bound():
    liveness = ft.MemoryLiveness(3)
    outcomes = {}

    def prog(c):
        ft.enable(c, liveness=liveness, detect_timeout_s=1.0,
                  heartbeat_s=0.1)
        c.allreduce(torch.ones(4), algorithm="sm")
        if c.rank == 2:
            c._t.killed = True  # crash-stop: stops beating
            return "died"
        t0 = time.monotonic()
        try:
            c.barrier(algorithm="sm")
        except ProcFailedError as e:
            outcomes[c.rank] = (time.monotonic() - t0, e)
            return "detected"
        return "hung?"

    res = port_shm(prog, 3, timeout=30.0)
    assert res == ["detected", "detected", "died"]
    for took, exc in outcomes.values():
        assert took < 10.0 and 2 in exc.failed
        assert exc.collective == "barrier"


def test_host_shm_example_on_shm_processes_with_its_profile(tmp_path):
    """``examples/host_shm.py`` (the card's phase 23 program) on 4 shm rank
    processes on the CPU: every leg's checks pass, the records name the
    session whose segments are gone after exit, and ``--profile-dir``
    leaves rank 0's profiles of a ring call and the 1 KiB arena leg."""
    import json

    from mpi_tpu_torch import launcher
    from mpi_tpu_torch.transport.shm import shm_prefix

    out, prof = tmp_path / "out", tmp_path / "prof"
    example = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "mpi_tpu_torch", "examples", "host_shm.py")
    # one intra-op thread a rank: 4 processes' thread pools would
    # oversubscribe the cores while the rings spin
    assert launcher.launch(4, [example, "--out", str(out), "--mib", "1",
                               "--iters", "1", "--profile-dir", str(prof)],
                           timeout=240.0, backend="shm", device="cpu",
                           env_extra={"OMP_NUM_THREADS": "1"}) == 0
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    assert len({d["session"] for d in ranks}) == 1
    assert not glob.glob("/dev/shm/" + shm_prefix(ranks[0]["session"]) + "*")
    assert not os.path.exists(ranks[0]["windows"]["shared_path"])
    assert all(d["ring"]["pickled_bytes"] == 0 for d in ranks)
    for d in ranks:
        assert set(d["arena"]["1024"]["ms"]) == {
            "allreduce", "reduce", "bcast", "allgather", "alltoall", "scan",
            "reduce_scatter", "barrier"}
    for rec in (ranks[0]["ring"]["profile"], ranks[0]["arena"]["1024"]["profile"]):
        assert rec["wall_ms"] > 0 and rec["host_ops"]
        assert rec["kernel_launches"] == 0  # no card: host ops only
    assert ranks[1]["ring"]["profile"] is None  # rank 0 alone profiles
    # the steered leg (1 MiB into rank 1's posted tensor, in turns with the
    # copy path): in place and counted on every steered turn
    steer = ranks[1]["steer"]
    assert steer["steered"]["ok"] and steer["steered"]["in_place"]
    assert [(t["recv_user_inplace"], t["recv_user_fallbacks"])
            for t in steer["steered"]["turns"]] == [(1, 0), (1, 0)]
    assert steer["copy_path"]["ok"] and not steer["copy_path"]["in_place"]
    assert (prof / "ring" / "trace.json").is_file()
    assert (prof / "arena_1024" / "trace.json").is_file()
