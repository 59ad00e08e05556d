"""Receives steered into user buffers on the port's byte-stream
transports (``mpi_tpu_torch/recvpool.py``, the communicator's
``_arm_user_recv``), after ``tests/test_zero_copy_user.py``.

Each leg sends a TENSOR (the port's raw frames carry tensors; numpy
payloads ride pickle) from rank 0 to rank 1 over real socket or shm
transports in threads, on the CPU, and holds the received bytes against
the numpy-seeded payload and the ``recv_user_inplace`` /
``recv_user_fallbacks`` pvars against the reference's counts for the same
program (``tests/test_zero_copy_user.py``): one in-place landing, no
fallback, the destination's own storage (same ``data_ptr``).
"""

import numpy as np
import pytest
import torch

from mpi_tpu_torch import mpit
from mpi_tpu_torch.transport.shm import run_shm
from tests.test_torch_host_socket import port_socket_world

_NAMES = ("recv_user_inplace", "recv_user_fallbacks", "recv_bytes_steered",
          "recv_pool_hits", "recv_pool_misses")


def _world(kind):
    if kind == "socket":
        return lambda prog, n: port_socket_world(prog, n, timeout=60.0)
    return lambda prog, n: run_shm(prog, n, timeout=60.0, device="cpu")


def _deltas(kind, prog, nranks=2):
    base = {n: mpit.pvar_read(n) for n in _NAMES}
    res = _world(kind)(prog, nranks)
    return res, {n: mpit.pvar_read(n) - base[n] for n in _NAMES}


def _addr(buf):
    return buf.data_ptr() if isinstance(buf, torch.Tensor) \
        else buf.ctypes.data


@pytest.mark.parametrize("dest", ["tensor", "ndarray"])
@pytest.mark.parametrize("kind", ["socket", "shm"])
def test_user_irecv_lands_in_place(kind, dest):
    """The receiver posts BEFORE the sender fires (tag-99 handshake), so
    the frame is paired with the posted buffer and read into its bytes."""
    payload = np.random.RandomState(7).randn(1 << 17)

    def prog(comm):
        if comm.rank == 0:
            comm.recv(1, 99)
            comm.send(torch.from_numpy(payload.copy()), dest=1, tag=21)
            return True
        buf = (torch.zeros(payload.shape, dtype=torch.float64)
               if dest == "tensor" else np.zeros_like(payload))
        ptr = _addr(buf)
        req = comm.irecv(0, 21, buf=buf)
        comm.send(b"posted", dest=0, tag=99)
        got = req.wait()
        assert got is buf and _addr(buf) == ptr
        np.testing.assert_array_equal(np.asarray(buf), payload)
        return True

    res, d = _deltas(kind, prog)
    assert all(res)
    assert d["recv_user_inplace"] == 1 and d["recv_user_fallbacks"] == 0
    assert d["recv_bytes_steered"] >= payload.nbytes
    assert d["recv_pool_hits"] + d["recv_pool_misses"] == 0


@pytest.mark.parametrize("kind", ["socket", "shm"])
def test_user_irecv_beaten_by_frame_takes_the_counted_fallback(kind):
    """The frame is already queued when the irecv posts: the activation
    backlog keeps the pairing aligned, nothing is steered, and the
    completion copies into the buffer with the fallback counted once."""
    payload = np.random.RandomState(9).randn(1 << 14).astype(np.float32)

    def prog(comm):
        if comm.rank == 0:
            comm.send(torch.from_numpy(payload.copy()), dest=1, tag=41)
            comm.send(b"sent", dest=1, tag=42)
            return True
        comm.recv(0, 42)                   # the tag-41 frame is queued
        buf = torch.zeros(payload.shape)
        got = comm.irecv(0, 41, buf=buf).wait()
        assert got is not buf
        np.testing.assert_array_equal(buf.numpy(), payload)
        np.testing.assert_array_equal(got.numpy(), payload)
        return True

    res, d = _deltas(kind, prog)
    assert all(res)
    assert d["recv_user_fallbacks"] == 1 and d["recv_user_inplace"] == 0


@pytest.mark.parametrize("kind", ["socket", "shm"])
def test_recv_init_user_buffer_refires_in_place(kind):
    """A persistent receive re-arms the SAME buffer at every start():
    each round's frame lands in it, none allocated per round."""
    rounds = 3
    payloads = [np.random.RandomState(30 + i).randn(1 << 14)
                for i in range(rounds)]

    def prog(comm):
        if comm.rank == 0:
            comm.recv(1, 99)
            for p in payloads:
                comm.send(torch.from_numpy(p.copy()), dest=1, tag=23)
            return True
        buf = torch.zeros(1 << 14, dtype=torch.float64)
        ptr = buf.data_ptr()
        h = comm.recv_init(0, 23, buf=buf)
        comm.send(b"armed", dest=0, tag=99)
        for p in payloads:
            got = h.start().wait()
            np.testing.assert_array_equal(np.asarray(got), p)
            np.testing.assert_array_equal(buf.numpy(), p)
        assert buf.data_ptr() == ptr
        return True

    res, d = _deltas(kind, prog)
    assert all(res)
    assert d["recv_user_inplace"] >= 1
    assert d["recv_user_inplace"] + d["recv_user_fallbacks"] == rounds


@pytest.mark.parametrize("kind", ["socket", "shm"])
def test_scatter_gather_irecv(kind):
    """A list of tensors ships as one multi-segment frame and lands
    segment by segment in a posted list of buffers (one vectored read on
    socket)."""
    segs = [np.random.RandomState(1).randn(1 << 15),
            np.random.RandomState(2).randn(1 << 14).astype(np.float32),
            np.random.RandomState(3).randn(1 << 13)]

    def prog(comm):
        if comm.rank == 0:
            comm.recv(1, 99)
            comm.send([torch.from_numpy(s.copy()) for s in segs], dest=1,
                      tag=31)
            return True
        bufs = [torch.zeros(s.shape, dtype=torch.from_numpy(s).dtype)
                for s in segs]
        req = comm.irecv(0, 31, buf=bufs)
        comm.send(b"posted", dest=0, tag=99)
        got = req.wait()
        assert got is bufs
        for b, s in zip(bufs, segs):
            np.testing.assert_array_equal(b.numpy(), s)
        return True

    res, d = _deltas(kind, prog)
    assert all(res)
    assert d["recv_user_inplace"] == 1 and d["recv_user_fallbacks"] == 0
    assert d["recv_bytes_steered"] == sum(s.nbytes for s in segs)


def test_wildcard_pop_of_a_steered_buffer_gets_a_private_copy():
    """A wildcard receive that pops the steered destination before its
    owner is handed a copy, and the owner still ends with its frame."""
    a = np.random.RandomState(5).randn(1 << 12)
    b = np.random.RandomState(6).randn(1 << 12)

    def prog(comm):
        if comm.rank == 0:
            comm.recv(1, 99)
            comm.send(torch.from_numpy(a.copy()), dest=1, tag=7)
            comm.send(torch.from_numpy(b.copy()), dest=1, tag=7)
            return True
        buf = torch.zeros(1 << 12, dtype=torch.float64)
        req = comm.irecv(0, 7, buf=buf)
        comm.send(b"posted", dest=0, tag=99)
        first = comm.recv()                 # wildcard: takes frame one
        second = req.wait()                 # the owner: frame two
        assert first is not buf
        np.testing.assert_array_equal(np.asarray(first), a)
        np.testing.assert_array_equal(np.asarray(second), b)
        np.testing.assert_array_equal(buf.numpy(), b)
        return True

    res, d = _deltas("socket", prog)
    assert all(res)
    assert d["recv_user_inplace"] + d["recv_user_fallbacks"] == 1
