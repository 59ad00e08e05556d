"""The port's same-host data plane against the reference's: its own native
ring (``mpi_tpu_torch/native/shmring.cpp``, built into
``mpi_tpu_torch/_build/``), ``ShmTransport`` worlds in rank threads
(``transport.shm.run_shm``) against the reference's
(``tests.test_shm_backend.run_shm_world``) on the same seeded inputs,
bitwise, the shm cases of the reference's membership, progress and fault
tolerance tests, and the launcher's ``--backend shm`` end to end with its
segment cleanup.  The port's segments are ``/mtt_<session>_*`` and its
test rings ``/mtt_test_*``, so neither package's cleanup touches the
other's.  The checklist is ``tests/test_shm_backend.py``."""

import ctypes
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from mpi_tpu import ops as ref_ops
from mpi_tpu.transport.shm import ShmTransport as RefShm
from mpi_tpu_torch import membership, mpit, ops, progress
from mpi_tpu_torch.errors import EpochSkewError
from mpi_tpu_torch.native import build as native_build
from mpi_tpu_torch.native import load_shmring
from mpi_tpu_torch.transport.shm import ShmTransport, run_shm, shm_prefix
from tests.test_shm_backend import run_shm_world as ref_run_shm
from tests.test_torch_host_local import assert_same, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_shm(fn, p, **kw):
    kw.setdefault("ring_bytes", 256 * 1024)
    return run_shm(fn, p, device="cpu", timeout=60, **kw)


def _session_segments(rdv):
    prefix = shm_prefix(os.path.basename(rdv.rstrip("/")))
    return [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


# -- the native ring ----------------------------------------------------------


def test_ring_builds_from_the_ports_source_into_its_build_dir():
    so = native_build.ensure_built()
    assert os.path.dirname(so) == str(native_build.BUILD_DIR)
    assert native_build.BUILD_DIR.parent.name == "mpi_tpu_torch"
    assert os.path.basename(so).startswith("shmring-")
    assert native_build.ensure_built() == so  # cached: no rebuild
    lib = load_shmring()
    assert lib is load_shmring()
    with open(f"/proc/{os.getpid()}/maps") as f:
        assert so in f.read()  # (test_torch_isolation.py: and nothing else)


def test_unknown_sanitizer_mode_is_the_references_message(monkeypatch):
    from mpi_tpu.native import build as ref_build

    monkeypatch.setenv("MPI_TPU_SANITIZE", "memory")
    msgs = []
    for mod in (ref_build, native_build):
        with pytest.raises(mod.NativeBuildError) as ei:
            mod.sanitize_mode()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    monkeypatch.setenv("MPI_TPU_SANITIZE", "address")
    assert native_build.so_path("address").name.endswith(".asan.so")


def test_ring_roundtrip_small():
    lib = load_shmring()
    name = b"/mtt_test_ring_rt"
    ring_c = lib.shmring_create(name, 4096)
    ring_p = lib.shmring_open(name, 5.0)
    assert ring_c and ring_p
    msg = b"hello, ring"
    assert lib.shmring_write(ring_p, msg, len(msg), 5.0) == 0
    assert lib.shmring_avail(ring_c) == len(msg)
    buf = ctypes.create_string_buffer(len(msg))
    assert lib.shmring_read(ring_c, buf, len(msg), 5.0) == 0
    assert buf.raw == msg
    lib.shmring_close(ring_p)
    lib.shmring_close(ring_c)
    lib.shmring_unlink(name)


@pytest.mark.parametrize("extra", [0, 12345])
def test_ring_wraps_and_streams_frames_larger_than_capacity(extra):
    lib = load_shmring()
    name = f"/mtt_test_ring_big_{extra}".encode()
    cap = 64 * 1024
    ring_c = lib.shmring_create(name, cap)
    ring_p = lib.shmring_open(name, 5.0)
    payload = np.random.RandomState(0).bytes(cap * 4 + extra)
    out = ctypes.create_string_buffer(len(payload))
    err = []

    def reader():
        if lib.shmring_read(ring_c, out, len(payload), 30.0) != 0:
            err.append("read timeout")

    t = threading.Thread(target=reader)
    t.start()
    assert lib.shmring_write(ring_p, payload, len(payload), 30.0) == 0
    t.join(30.0)
    assert not err and not t.is_alive()
    assert out.raw == payload
    lib.shmring_close(ring_p)
    lib.shmring_close(ring_c)
    lib.shmring_unlink(name)


def test_ring_write_timeout_when_full():
    lib = load_shmring()
    name = b"/mtt_test_ring_full"
    ring_c = lib.shmring_create(name, 1024)
    ring_p = lib.shmring_open(name, 5.0)
    assert lib.shmring_write(ring_p, bytes(1024), 1024, 5.0) == 0
    assert lib.shmring_write(ring_p, b"x", 1, 0.2) == -1  # nobody drains
    lib.shmring_close(ring_p)
    lib.shmring_close(ring_c)
    lib.shmring_unlink(name)


# -- the transport in rank threads, against the reference's -------------------


def test_p2p_roundtrip_and_self_send():
    def prog(c, mk):
        c.send("to-myself", dest=c.rank, tag=1)
        me = c.recv(source=c.rank, tag=1)
        if c.rank == 0:
            c.send(mk(np.arange(1000)), dest=1, tag=3)
            return me, c.recv(source=1, tag=4)
        got = c.recv(source=0, tag=3)
        c.send(got.sum(), dest=0, tag=4)
        return me, None

    ref = ref_run_shm(lambda c: prog(c, np.asarray), 2)
    got = port_shm(lambda c: prog(c, to_torch), 2)
    assert_same(ref, got)


@pytest.mark.parametrize("nbytes", [1, 100, 8191, 8192, 8193, 100_000,
                                    256 * 1024 - 8, 256 * 1024,
                                    256 * 1024 + 1, 3 * 1024 * 1024])
def test_frames_of_every_size_roundtrip(nbytes):
    """Sizes straddling the one-write threshold, the ring capacity and
    multiples of it: raw tensor frames and pickled bytes alike."""
    rng = np.random.RandomState(nbytes % 1000)
    blob = rng.bytes(nbytes)
    arr = np.frombuffer(rng.bytes(nbytes - nbytes % 4 or 4), np.float32)

    def prog(c, mk):
        if c.rank == 0:
            c.send(blob, dest=1)
            c.send(mk(arr), dest=1)
            c.send([mk(arr[:7]), mk(arr)], dest=1)
            return None
        return [c.recv(source=0) == blob, c.recv(source=0),
                c.recv(source=0)]

    ref = ref_run_shm(lambda c: prog(c, np.array), 2)
    got = port_shm(lambda c: prog(c, to_torch), 2)
    assert got[1][0] is True
    assert_same(ref, got)


def test_bf16_and_non_contiguous_tensors_ride_raw_frames():
    x = torch.arange(3000, dtype=torch.float32).to(torch.bfloat16)

    def prog(c):
        if c.rank == 0:
            c.send(x, dest=1)
            c.send(torch.arange(40.0).view(8, 5)[:, 1], dest=1)
            return None
        return c.recv(source=0), c.recv(source=0)

    b0 = mpit.pvar_read("bytes_pickled_sent")
    got = port_shm(prog, 2)
    assert mpit.pvar_read("bytes_pickled_sent") == b0
    assert torch.equal(got[1][0], x)
    assert torch.equal(got[1][1], torch.arange(40.0).view(8, 5)[:, 1])


@pytest.mark.parametrize("algo", ["ring", "recursive_halving", "rabenseifner",
                                  "reduce_bcast"])
def test_allreduce_bitwise(algo):
    data = np.random.RandomState(1).randn(4, 50_000)
    ref = ref_run_shm(lambda c: c.allreduce(data[c.rank], op=ref_ops.SUM,
                                            algorithm=algo), 4)
    got = port_shm(lambda c: c.allreduce(to_torch(data[c.rank]), op=ops.SUM,
                                         algorithm=algo), 4)
    assert_same(ref, got)


def test_collective_family_bitwise_with_steering_counts():
    """The wire collectives over the rings (arena disabled), with the
    rendezvous steering of large copy spans counted alike."""
    data = np.random.RandomState(2).randn(3, 3, 200_000).astype(np.float32)

    def prog(c, mk, mod):
        mod.cvar_write("coll_sm_arena_bytes", 0)
        return [c.bcast(mk(data[0, 0]) if c.rank == 0 else None, 0),
                c.allgather(mk(data[c.rank, 0]), algorithm="ring"),
                c.reduce_scatter(mk(data[c.rank]), algorithm="ring"),
                c.alltoall(mk(data[c.rank])),
                c.scan(mk(data[c.rank, 1])),
                c.reduce(mk(data[c.rank, 2]), root=1),
                c.allreduce(mk(data[c.rank, 0]), algorithm="ring")]

    from mpi_tpu import mpit as ref_mpit

    old = (ref_mpit.cvar_read("coll_sm_arena_bytes"),
           mpit.cvar_read("coll_sm_arena_bytes"))
    try:
        ref = ref_run_shm(lambda c: prog(c, np.array, ref_mpit), 3)
        s0 = mpit.pvar_read("recv_pool_rendezvous")
        got = port_shm(lambda c: prog(c, to_torch, mpit), 3)
        assert mpit.pvar_read("recv_pool_rendezvous") > s0
    finally:
        ref_mpit.cvar_write("coll_sm_arena_bytes", old[0])
        mpit.cvar_write("coll_sm_arena_bytes", old[1])
    assert_same(ref, got)


def test_split_and_rma():
    def prog(c, mk):
        sub = c.split(color=c.rank % 2, key=c.rank)
        win = c.win_create(mk(np.zeros(1)))
        if c.rank != 0:
            win.accumulate(mk(np.array([1.0])), 0)
        win.fence()
        return sub.allreduce(c.rank), float(win.local[0])

    ref = ref_run_shm(lambda c: prog(c, np.array), 4)
    got = port_shm(lambda c: prog(c, to_torch), 4)
    assert [r[0] for r in got] == [2, 4, 2, 4]
    assert [r[1] for r in ref] == [r[1] for r in got] == [3.0, 0.0, 0.0, 0.0]


def test_symmetric_big_sendrecv_no_deadlock():
    big = np.arange(300_000, dtype=np.float64)  # ~2.4 MB through 256 KB rings

    def prog(c, mk):
        got = c.sendrecv(mk(big * (c.rank + 1)), 1 - c.rank)
        return got[-1]

    assert_same(ref_run_shm(lambda c: prog(c, np.array), 2),
                port_shm(lambda c: prog(c, to_torch), 2))


def test_segments_cleaned_up_and_names_are_the_ports():
    rdv = tempfile.mkdtemp(prefix="mpi_tpu_torch_shm_gc_")
    t0 = ShmTransport(0, 2, rdv, ring_bytes=64 * 1024, device="cpu")
    t1 = ShmTransport(1, 2, rdv, ring_bytes=64 * 1024, device="cpu")
    try:
        segs = _session_segments(rdv)
        assert len(segs) == 4  # 2 directed rings + 2 doorbells
        assert all(s.startswith("mtt_") for s in segs)
    finally:
        t0.close()
        t1.close()
    assert not _session_segments(rdv)


def test_crash_path_cleanup_unlinks_the_sessions_segments():
    rdv = membership.new_rendezvous_dir()
    t = ShmTransport(0, 2, rdv, ring_bytes=64 * 1024, device="cpu")
    assert _session_segments(rdv)
    t._in_rings.clear()  # a crashed rank: nobody unlinks its segments
    t.close()
    assert _session_segments(rdv)
    ref = RefShm(0, 2, rdv, ring_bytes=64 * 1024)  # the reference's, same dir
    try:
        membership.cleanup_rendezvous(rdv)
        assert not _session_segments(rdv)
        # the reference's segments of the same session are not the port's
        assert [f for f in os.listdir("/dev/shm")
                if f.startswith(f"mt_{os.path.basename(rdv)}_")]
    finally:
        ref.close()


# -- membership (the reference's test_membership.py shm cases) ----------------


def test_shm_stale_straggler_diagnosed(tmp_path):
    rdv = str(tmp_path)
    survivor = ShmTransport(0, 2, rdv, epoch=3, device="cpu")
    straggler = ShmTransport(1, 2, rdv, epoch=1, device="cpu")
    old = mpit.cvar_read("epoch_grace_s")
    mpit.cvar_write("epoch_grace_s", 0.2)
    try:
        with pytest.raises(EpochSkewError) as ei:
            straggler.send(0, 0, 5, b"stale open")
        assert ei.value.peer_epoch == 3 and ei.value.local_epoch == 1
    finally:
        mpit.cvar_write("epoch_grace_s", old)
        survivor.close()
        straggler.close()


def test_shm_transition_recreates_inbound_rings(tmp_path):
    rdv = str(tmp_path)
    survivor = ShmTransport(0, 2, rdv, device="cpu")
    first = ShmTransport(1, 2, rdv, device="cpu")
    try:
        first.send(0, 0, 7, b"from the first incarnation")
        assert survivor.recv(1, 0, 7)[0] == b"from the first incarnation"
        survivor._dead_srcs.add(1)
        first.send(0, 0, 7, b"leftover garbage from the corpse")
        membership.survivor_transition(survivor, 1, [1])
        assert survivor._lib.shmring_avail(survivor._in_rings[1]) == 0
        assert 1 not in survivor._dead_srcs
        with open(os.path.join(rdv, "shm.0")) as f:
            assert f.read() == "1"  # re-stamped at the new epoch
        first.close()
        replacement = ShmTransport(1, 2, rdv, epoch=1, device="cpu")
        replacement.min_peer_epoch[0] = 1
        try:
            replacement.send(0, 0, 8, b"fresh generation")
            assert survivor.recv(1, 0, 8)[0] == b"fresh generation"
        finally:
            replacement.close()
    finally:
        survivor.close()


# -- progress (the reference's test_progress.py shm case) ---------------------


def test_irecv_completes_in_background_shm():
    def prog(comm):
        progress.enable(comm)
        comm.barrier()
        if comm.rank == 0:
            comm.send(torch.arange(1 << 15, dtype=torch.float64), 1, tag=9)
            comm.barrier(algorithm="dissemination")
            return "sent"
        req = comm.irecv(0, 9)
        deadline = time.time() + 10
        while not req._done and time.time() < deadline:
            time.sleep(0.01)  # deliberately no wait()/test()
        assert req._done, "shm engine did not drain/complete in background"
        got = req.wait()
        comm.barrier(algorithm="dissemination")
        return float(got[-1])

    out = port_shm(prog, 2)
    assert out[1] == float((1 << 15) - 1)


# -- rank processes --------------------------------------------------------


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, **kw)
    return env


def test_launcher_end_to_end_leaves_no_segment(tmp_path):
    script = tmp_path / "prog.py"
    out = tmp_path / "out"
    out.mkdir()
    script.write_text(textwrap.dedent(f"""
        import torch
        import mpi_tpu_torch
        from mpi_tpu_torch import mpit

        comm = mpi_tpu_torch.init()
        got = comm.allreduce(torch.full((10,), comm.rank + 1.0))
        big = comm.allreduce(torch.ones(1 << 20), algorithm="ring")
        with open({str(out)!r} + f"/rank{{comm.rank}}.txt", "w") as f:
            f.write(f"{{float(got.sum())}} {{float(big[0])}} "
                    f"{{type(comm._t).__name__}} "
                    f"{{mpit.pvar_read('coll_sm_hits')}}")
        mpi_tpu_torch.finalize()
    """))
    from mpi_tpu_torch import launcher

    rdvs = []
    real = membership.new_rendezvous_dir

    def recorded():
        rdvs.append(real())
        return rdvs[-1]

    launcher.membership.new_rendezvous_dir = recorded
    try:
        assert launcher.main(["-n", "3", "--backend", "shm", "--device",
                              "cpu", "--timeout", "120", str(script)]) == 0
    finally:
        launcher.membership.new_rendezvous_dir = real
    for r in range(3):
        total, big, kind, hits = (out / f"rank{r}.txt").read_text().split()
        assert float(total) == 60.0 and float(big) == 3.0
        assert kind == "ShmTransport" and int(hits) >= 1
    assert len(rdvs) == 1 and not _session_segments(rdvs[0])


_RING_FULL_PROG = """
import os, sys, time
import torch
import mpi_tpu_torch
from mpi_tpu_torch import mpit
from mpi_tpu_torch.errors import ProcFailedError

mpit.cvar_write("fault_detect_timeout_s", 2.0)
mpit.cvar_write("fault_heartbeat_interval_s", 0.2)
comm = mpi_tpu_torch.init()
if comm.rank == 1:
    os._exit(9)  # endpoints up, nothing ever draining
payload = torch.ones(1 << 20)  # 4 MB frames: one whole ring each
BOUND = 3.0 * 2.0 + (25.0 if (os.cpu_count() or 1) < 4 else 8.0)
t0 = time.monotonic()
try:
    for i in range(50):
        comm.send(payload, 1, tag=5)
    sys.exit(7)
except ProcFailedError as e:
    took = time.monotonic() - t0
    assert 1 in e.failed, e.failed
    assert took < BOUND, f"sender stuck {took:.1f}s"
    assert "dead" in str(e), e
print(f"sender unstuck in {time.monotonic() - t0:.1f}s", flush=True)
sys.exit(0)
"""


def test_sender_unstuck_from_dead_consumers_full_ring(tmp_path):
    """The reference's ``test_shm_sender_unstuck_from_dead_consumers_full_ring``:
    a sender mid-write into a dead consumer's full ring surfaces
    ProcFailedError within the detection bound, not the ring's stall
    bound."""
    native_build.ensure_built()
    script = tmp_path / "ringfull.py"
    script.write_text(_RING_FULL_PROG)
    rdv = tempfile.mkdtemp(prefix="mtt_ringfull_", dir=tmp_path)
    procs = [subprocess.Popen(
        [sys.executable, str(script)],
        env=_env(MPI_TPU_RANK=str(r), MPI_TPU_SIZE="2", MPI_TPU_RDV=str(rdv),
                 MPI_TPU_BACKEND="shm", MPI_TPU_FT="1", MPI_TPU_DEVICE="cpu"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=90.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        membership.cleanup_rendezvous(rdv)
    assert procs[1].returncode == 9
    assert procs[0].returncode == 0, outs[0][1][-900:]
    assert "sender unstuck" in outs[0][0]
