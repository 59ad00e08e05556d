"""The port's socket transport against the reference's: socket ranks as
threads of this process over real loopback TCP (p2p, large-message
framing, self-send, every allreduce algorithm, bcast, alltoall, barrier,
split), bitwise against ``mpi_tpu``'s socket backend on the same seeded
inputs; and the launcher end to end — a 3-rank run, a failing rank's exit
code, and rank processes that refuse to import ``jax`` / ``mpi_tpu``."""

import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from mpi_tpu import mpit as ref_mpit
from mpi_tpu import ops as ref_ops
from mpi_tpu_torch import mpit, ops
from mpi_tpu_torch.communicator import P2PCommunicator
from mpi_tpu_torch.transport.base import TransportError
from mpi_tpu_torch.transport.socket import SocketTransport
from tests.test_socket_backend import run_socket_world as ref_socket_world
from tests.test_torch_host_local import assert_same, seeded, to_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def port_socket_world(fn, nranks, timeout=120.0):
    """Run ``fn(comm)`` on ``nranks`` port socket transports living in
    threads of this process (real TCP), on the CPU."""
    rdv = tempfile.mkdtemp(prefix="mpi_tpu_torch_test_rdv_")
    results = [None] * nranks
    errors = []
    transports = [None] * nranks

    def runner(r):
        try:
            t = SocketTransport(r, nranks, rdv, device="cpu")
            transports[r] = t
            results[r] = fn(P2PCommunicator(t, range(nranks)))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            import traceback

            errors.append((r, e, traceback.format_exc()))

    threads = [threading.Thread(target=runner, args=(r,), daemon=True)
               for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    alive = [i for i, t in enumerate(threads) if t.is_alive()]
    for t in transports:
        if t is not None:
            t.close()
    if errors:
        r, e, tb = errors[0]
        raise RuntimeError(f"rank {r} failed:\n{tb}") from e
    if alive:
        raise TimeoutError(f"socket ranks did not finish: {alive}")
    return results


def both_socket(prog, n, data, **kw):
    ref = ref_socket_world(lambda c: prog(c, data, ref_ops, **kw), n)
    tdata = [to_torch(d) for d in data]
    got = port_socket_world(lambda c: prog(c, tdata, ops, **kw), n)
    for r in range(n):
        assert_same(ref[r], got[r], f"rank {r}")
    return got


def _p2p(c, data, o):
    p, r = c.size, c.rank
    c.send(data[r], (r + 1) % p, tag=3)
    c.send({"from": r, "t": (1, 2)}, (r + 1) % p, tag=4)
    return [c.recv((r - 1) % p, tag=4), c.recv((r - 1) % p, tag=3)]


def test_socket_p2p():
    both_socket(_p2p, 3, seeded(3, (5, 7), np.int32))


def _large(c, data, o):
    if c.rank == 0:
        c.send(data[0], 1, tag=0)
        return None
    return c.recv(0, tag=0)


def test_socket_large_message_framing():
    # 24 MiB: many recv_into calls for one frame body
    both_socket(_large, 2, seeded(1, (3 << 20,), np.float64, seed=2))


def _self_send(c, data, o):
    c.send(data[c.rank], c.rank, tag=1)
    return c.recv(c.rank, tag=1)


def test_socket_self_send():
    both_socket(_self_send, 2, seeded(2, (9,)))


@pytest.fixture(params=["default", "small"])
def segments(request):
    if request.param == "default":
        yield request.param
        return
    old = (ref_mpit.cvar_read("collective_segment_bytes"),
           mpit.cvar_read("collective_segment_bytes"))
    ref_mpit.cvar_write("collective_segment_bytes", 64)
    mpit.cvar_write("collective_segment_bytes", 64)
    yield request.param
    ref_mpit.cvar_write("collective_segment_bytes", old[0])
    mpit.cvar_write("collective_segment_bytes", old[1])


def _allreduce(c, data, o, algo):
    return c.allreduce(data[c.rank], o.SUM, algorithm=algo)


@pytest.mark.parametrize("n,algo", [
    (4, "ring"), (4, "recursive_halving"), (4, "rabenseifner"),
    (4, "reduce_bcast"), (3, "ring"), (3, "rabenseifner"), (3, "auto")])
def test_socket_allreduce(n, algo, segments):
    both_socket(_allreduce, n, seeded(n, (301,), np.float32, seed=n), algo=algo)


def _colls(c, data, o):
    p, r = c.size, c.rank
    b = c.bcast(data[0] if r == 0 else None, root=0)
    a2a = c.alltoall([data[r][d] for d in range(p)])
    c.barrier()
    sub = c.split(r % 2, key=r)
    return [b, a2a, sub.rank, sub.size, sub.allreduce(data[r])]


@pytest.mark.parametrize("n", [3, 4])
def test_socket_bcast_alltoall_barrier_split(n, segments):
    both_socket(_colls, n, seeded(n, (n, 5), np.float64))


def test_socket_bcast_segmented_tree():
    """A 1 MiB tensor over 3 socket ranks: the segmented tree, header
    frames pickled, every payload byte raw."""
    data = seeded(3, (1 << 18,), np.float32)

    def prog(c, d, o):
        return c.bcast(d[2] if c.rank == 2 else None, root=2)

    both_socket(prog, 3, data)


def test_socket_steering_lands_in_the_working_buffer():
    """The ring's allgather-phase segments pair with posted receives and
    land in the working buffer directly (recv_pool_rendezvous)."""
    before = mpit.pvar_read("recv_pool_rendezvous")
    n = 3
    both_socket(_allreduce, n, seeded(n, (3 << 18,), np.float32), algo="ring")
    assert mpit.pvar_read("recv_pool_rendezvous") > before


# -- the launcher (each run starts rank processes that import torch) --------

_RANK_PROG = """
import sys
{block}
import torch
import mpi_tpu_torch
from mpi_tpu_torch import ops

def prog(comm):
    x = torch.full((10,), comm.rank + 1.0)
    total = comm.allreduce(x)
    big = torch.arange(1 << 18, dtype=torch.float32) * (comm.rank + 1)
    ring = comm.allreduce(big, algorithm="ring")
    return float(total.sum()), float(ring[7]), str(ring.device), comm.size

res = mpi_tpu_torch.run(prog)
comm = mpi_tpu_torch.COMM_WORLD
with open({out!r} + f"/rank{{comm.rank}}.txt", "w") as f:
    f.write(repr(res))
mpi_tpu_torch.finalize()
{check}
"""

_BLOCK = """
import importlib.abc
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mpi_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, _Block())
"""

_CHECK = """
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mpi_tpu")]
"""


def _launch(args, timeout=240):
    env = dict(os.environ)
    env.pop("MPI_TPU_RANK", None)
    return subprocess.run([sys.executable, "-m", "mpi_tpu_torch.launcher",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("blocked", [False, True])
def test_launcher_three_ranks_end_to_end(tmp_path, blocked):
    """Three socket rank processes on the CPU; with ``blocked`` every rank
    refuses to import jax / jaxlib / mpi_tpu (the isolation rule of
    test_torch_isolation.py, extended to rank processes)."""
    out = tmp_path / "out"
    out.mkdir()
    script = tmp_path / "prog.py"
    script.write_text(textwrap.dedent(_RANK_PROG).format(
        block=_BLOCK if blocked else "", check=_CHECK if blocked else "",
        out=str(out)))
    res = _launch(["-n", "3", "--device", "cpu", "--timeout", "200",
                   str(script)])
    assert res.returncode == 0, res.stderr[-4000:]
    want_ring = 7.0 * (1 + 2 + 3)
    for r in range(3):
        total, ring7, dev, size = eval((out / f"rank{r}.txt").read_text())
        assert total == 10 * (1 + 2 + 3) and ring7 == want_ring
        assert dev == "cpu" and size == 3


def test_launcher_propagates_failing_rank_exit_code(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["MPI_TPU_RANK"] == "1":
            sys.exit(7)
        time.sleep(60)
    """))
    res = _launch(["-n", "2", "--device", "cpu", str(script)], timeout=60)
    assert res.returncode == 7
    assert "rank 1: exit code 7" in res.stderr
    assert "rank 0: killed by SIGTERM" in res.stderr


def test_socket_link_heals_and_replays_after_a_dropped_connection():
    """A connection torn between frames is rebuilt: the resume handshake
    replays the unacked frames and the receiver's sequence gate drops
    the duplicates — every message arrives once, in order."""
    before = mpit.pvar_read("link_reconnects")

    def prog(c):
        if c.rank == 0:
            for k in range(5):
                c.send(torch.full((3,), float(k)), 1, tag=0)
            c._t._drop_conn(1)  # the link dies; the window keeps the frames
            for k in range(5, 10):
                c.send(torch.full((3,), float(k)), 1, tag=0)
            return None
        return [float(c.recv(0, tag=0)[0]) for _ in range(10)]

    assert port_socket_world(prog, 2)[1] == [float(k) for k in range(10)]
    assert mpit.pvar_read("link_reconnects") == before + 1


def test_a_closing_transport_registers_no_reconnect():
    """Once a transport begins to close it dials no more, whoever dials
    (the ack flusher's and the keepalive's dials pass no abort): a dial
    that found a listener, its peer's or another world's on a reused port,
    would count a reconnect and a masked fault in this process while
    another test reads them (the port's test_link_stall_is_not_a_fault
    under load; ROADMAP Queue 3)."""
    def prog(c):
        c.barrier()
        if c.rank == 0:
            t = c._t
            with t._send_lock(1):
                t._drop_conn(1)
                before = mpit.pvar_read("link_reconnects")
                t._closing = True  # close() has begun
                try:
                    with pytest.raises(TransportError, match="transport closed"):
                        t._establish_locked(1, time.monotonic() + 2.0, iter(lambda: 0.01, None))
                finally:
                    t._closing = False  # let the world's close() run in full
            return mpit.pvar_read("link_reconnects") - before, 1 in t._conns
        return None

    assert port_socket_world(prog, 2)[0] == (0, False)


def test_retained_frame_is_copied_before_an_in_place_write():
    """A CPU tensor retained by reference in a replay window is
    snapshotted by ``bufpool.touch`` before an in-place fold rewrites it,
    so a replay sends the bytes as they were sent."""
    from mpi_tpu_torch import bufpool

    work = torch.arange(8.0)
    ref = bufpool.BufRef([b"meta", work[2:6]])
    try:
        assert not ref.snapshotted and bufpool.live_refs() >= 1
        before = ref.tobytes()
        ops.SUM.combine_into(work[3:5], torch.ones(2))  # touches the range
        assert ref.snapshotted
        assert ref.tobytes() == before
        assert torch.equal(work[3:5], torch.tensor([4.0, 5.0]))
    finally:
        ref.release()
