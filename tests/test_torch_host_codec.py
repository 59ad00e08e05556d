"""The port's payload framing (``transport/codec.py``): raw frames carry
every dtype (bfloat16 included, which numpy cannot name), 0-d, empty and
non-contiguous tensors; tensor subclasses take the pickle path; messages
have value semantics; and a tensor of 1 MiB or more crosses a socket with
zero pickled payload bytes (the reference's invariant,
``tests/test_segmented_collectives.py``), read through the port's
``bytes_pickled_sent`` pvar."""

import numpy as np
import pytest
import torch

import mpi_tpu_torch
from mpi_tpu import mpit as ref_mpit
from mpi_tpu import ops as ref_ops
from mpi_tpu_torch import mpit, ops
from mpi_tpu_torch.bufpool import byte_view
from mpi_tpu_torch.transport import codec
from tests.test_socket_backend import run_socket_world as ref_socket_world
from tests.test_torch_host_socket import port_socket_world

DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
          torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
          torch.bool, torch.complex64]


def _sample(dtype, shape=(3, 5), seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 40
    if dtype == torch.bool:
        return x > 0
    if dtype == torch.complex64:
        return torch.complex(x, -x).to(dtype)
    return x.to(dtype)


def _bits(t):
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8) if t.numel() else t


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_raw_frame_round_trip_every_dtype(dtype):
    x = _sample(dtype)
    head, bufs = codec.pack_raw_frame(("ctx", 1), -2, x)
    body = head + b"".join(bytes(byte_view(b)) if isinstance(b, torch.Tensor)
                           else bytes(b) for b in bufs)
    ctx, tag, got = codec.parse_raw_body(body)
    assert (ctx, tag) == (("ctx", 1), -2)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(x))


@pytest.mark.parametrize("make", [
    lambda: torch.tensor(3.5),                                 # 0-d
    lambda: torch.empty(0, 4, dtype=torch.int32),              # empty
    lambda: torch.arange(24.0).reshape(4, 6)[:, ::2],          # strided
    lambda: torch.arange(24.0).reshape(4, 6).t(),              # transposed
    lambda: torch.tensor(True),
], ids=["0d", "empty", "strided", "transposed", "0d-bool"])
def test_odd_shapes_round_trip_over_a_socket(make):
    x = make()

    def prog(c):
        if c.rank == 0:
            c.send(x, 1, tag=0)
            c.send([x, x + 1 if x.dtype != torch.bool else ~x], 1, tag=1)
            return None
        return c.recv(0, tag=0), c.recv(0, tag=1)

    got, seg = port_socket_world(prog, 2)[1]
    assert type(got) is torch.Tensor and got.shape == x.shape
    assert got.dtype == x.dtype and torch.equal(got, x) and got.is_contiguous()
    assert isinstance(seg, list) and torch.equal(seg[0], x)


def test_non_contiguous_payload_counts_one_compaction():
    x = torch.arange(20.0).reshape(4, 5)[:, 1:3]
    before = mpit.pvar_read("payload_copies")
    assert codec.as_raw_array(x).is_contiguous()
    assert mpit.pvar_read("payload_copies") == before + 1


def test_subclasses_take_the_pickle_path():
    """Exact-type rule: ``nn.Parameter`` carries state a raw frame cannot
    (it arrives as a Parameter, requires_grad kept), as ndarray subclasses
    do in the reference; a list holding the same tensor twice keeps its
    aliasing through pickle's memo."""
    p = torch.nn.Parameter(torch.arange(4.0))
    assert not codec.raw_eligible(p)
    assert codec.pack_raw_frame(0, 0, p) is None
    shared = torch.ones(3)

    def prog(c):
        if c.rank == 0:
            c.send(p, 1, tag=0)
            c.send([shared, shared], 1, tag=1)
            return None
        return c.recv(0, tag=0), c.recv(0, tag=1)

    before = mpit.pvar_read("bytes_pickled_sent")
    got, pair = port_socket_world(prog, 2)[1]
    assert mpit.pvar_read("bytes_pickled_sent") > before
    assert type(got) is torch.nn.Parameter and got.requires_grad
    assert torch.equal(got.detach(), p.detach())
    assert pair[0] is pair[1]


@pytest.mark.parametrize("where", ["local", "socket", "self-send"])
def test_value_semantics(where):
    """Changing the sent tensor after the send never changes what the
    receiver got."""
    def prog(c):
        x = torch.arange(6.0)
        dest = c.rank if where == "self-send" else 1 - c.rank
        c.send(x, dest, tag=0)
        x.mul_(-1.0)
        got = c.recv(dest if where == "self-send" else 1 - c.rank, tag=0)
        c.barrier()
        return got

    run = (port_socket_world if where != "local" else
           lambda f, n: mpi_tpu_torch.run(f, backend="local", nranks=n,
                                          device="cpu"))
    for got in run(prog, 2):
        assert torch.equal(got, torch.arange(6.0))


def test_local_copy_detaches_and_clones():
    x = torch.ones(3, requires_grad=True) * 2  # a non-leaf
    y = codec.local_copy(x)
    assert not y.requires_grad and torch.equal(y, x.detach())
    assert y.data_ptr() != x.data_ptr()


def _pickled_bytes_during(run, prog, n, counters):
    before = counters()
    results = run(prog, n)
    return counters() - before, results


@pytest.mark.parametrize("algo", ["ring", "recursive_halving", "rabenseifner"])
def test_zero_pickled_payload_bytes_at_1mib(algo):
    """At 1 MiB every tensor byte of an allreduce rides raw frames: zero
    pickled bytes, as in the reference on the same schedule."""
    n = 4
    data = [np.random.RandomState(i).randn(1 << 17) for i in range(n)]  # 1 MiB
    tdata = [torch.from_numpy(d) for d in data]

    ref_pickled, ref_res = _pickled_bytes_during(
        ref_socket_world,
        lambda c: c.allreduce(data[c.rank], ref_ops.SUM, algorithm=algo), n,
        lambda: ref_mpit.pvar_read("bytes_pickled_sent"))
    raw0 = mpit.pvar_read("bytes_raw_sent")
    pickled, res = _pickled_bytes_during(
        port_socket_world,
        lambda c: c.allreduce(tdata[c.rank], ops.SUM, algorithm=algo), n,
        lambda: mpit.pvar_read("bytes_pickled_sent"))
    assert ref_pickled == 0 and pickled == 0
    assert mpit.pvar_read("bytes_raw_sent") - raw0 >= data[0].nbytes
    for a, b in zip(ref_res, res):
        assert a.tobytes() == b.numpy().tobytes()


def test_segmented_bcast_and_ring_allgather_pickle_only_headers():
    n = 4
    big = torch.from_numpy(np.random.RandomState(9).randn(1 << 17))  # 1 MiB

    def prog(c):
        got = c.bcast(big if c.rank == 0 else None, root=0)
        ag = c.allgather(got + c.rank, algorithm="ring")
        return torch.equal(got, big) and ag.shape == (n, big.numel())

    before = mpit.pvar_read("bytes_pickled_sent")
    assert all(port_socket_world(prog, n))
    # the _SegHeader pickles are O(100) bytes per tree edge
    assert mpit.pvar_read("bytes_pickled_sent") - before < 4096
