"""MPI-IO on the port (``mpi_tpu_torch/io.py``) held against the
reference's (``mpi_tpu/io.py``) byte for byte.

The same 4-rank program — each rank's numpy-seeded column block of a
row-major float32 matrix, written through a strided subarray view with
``write_at_all`` and read back with ``read_at_all`` — runs through both
packages on their local backends (the port's on the CPU, with tensors),
below and above the 8 MiB two-phase collective-buffering limit, under
``native`` and ``external32``.  The files must be identical, each rank's
read must equal its block, and a file either package wrote must read
bitwise in the other.
"""

import os

import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu_torch
from mpi_tpu import datatypes as ref_dt
from mpi_tpu import io as ref_io
from mpi_tpu_torch import datatypes as dt
from mpi_tpu_torch import io as mio

NR = 4


def _block(n: int, rank: int) -> np.ndarray:
    return np.random.RandomState(100 + rank).randn(n, n // NR).astype(
        np.float32)


def _program(io, dtm, path, n, datarep, as_payload):
    def prog(comm):
        ft = dtm.type_create_subarray([n, n], [n, n // NR],
                                      [0, comm.rank * (n // NR)], np.float32)
        f = io.file_open(comm, path, io.MODE_CREATE | io.MODE_RDWR)
        f.set_view(etype=np.float32, filetype=ft, datarep=datarep)
        mine = _block(n, comm.rank)
        assert f.write_at_all(0, as_payload(mine.reshape(-1))) == mine.size
        back = f.read_at_all(0, mine.size)
        f.close()
        return np.asarray(back).reshape(mine.shape)

    return prog


# 256: 256 KiB in all, the aggregated two-phase branch; 1536: 9 MiB, above
# the 8 MiB limit, the independent branch
@pytest.mark.parametrize("datarep", ["native", "external32"])
@pytest.mark.parametrize("n", [256, 1536])
def test_same_program_writes_the_same_bytes(tmp_path, n, datarep):
    assert (n * n * 4 > mio._COLLECTIVE_BUFFER_LIMIT) == (n == 1536)
    ref_path, port_path = str(tmp_path / "ref.bin"), str(tmp_path / "port.bin")
    ref = mpi_tpu.run_local(
        _program(ref_io, ref_dt, ref_path, n, datarep, lambda a: a), NR)
    port = mpi_tpu_torch.run_local(
        _program(mio, dt, port_path, n, datarep, torch.from_numpy), NR,
        device="cpu")
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        ref_bytes, port_bytes = a.read(), b.read()
    assert len(port_bytes) == n * n * 4
    assert port_bytes == ref_bytes
    for r in range(NR):
        np.testing.assert_array_equal(port[r], _block(n, r))
        np.testing.assert_array_equal(ref[r], _block(n, r))
    whole = np.frombuffer(port_bytes, dtype=">f4" if datarep == "external32"
                          else "<f4").reshape(n, n)
    np.testing.assert_array_equal(
        whole, np.concatenate([_block(n, r) for r in range(NR)], axis=1))


def _reader(io, dtm, path, n, datarep):
    def prog(comm):
        ft = dtm.type_create_subarray([n, n], [n, n // NR],
                                      [0, comm.rank * (n // NR)], np.float32)
        f = io.file_open(comm, path, io.MODE_RDONLY)
        f.set_view(etype=np.float32, filetype=ft, datarep=datarep)
        out = f.read_at_all(0, n * (n // NR))
        f.close()
        return np.asarray(out).reshape(n, n // NR)

    return prog


@pytest.mark.parametrize("datarep", ["native", "external32"])
def test_cross_package_reads_are_bitwise(tmp_path, datarep):
    n = 256
    ref_path, port_path = str(tmp_path / "ref.bin"), str(tmp_path / "port.bin")
    mpi_tpu.run_local(
        _program(ref_io, ref_dt, ref_path, n, datarep, lambda a: a), NR)
    mpi_tpu_torch.run_local(
        _program(mio, dt, port_path, n, datarep, torch.from_numpy), NR,
        device="cpu")
    port_reads_ref = mpi_tpu_torch.run_local(
        _reader(mio, dt, ref_path, n, datarep), NR, device="cpu")
    ref_reads_port = mpi_tpu.run_local(
        _reader(ref_io, ref_dt, port_path, n, datarep), NR)
    for r in range(NR):
        want = _block(n, r)
        assert port_reads_ref[r].tobytes() == want.tobytes()
        assert ref_reads_port[r].tobytes() == want.tobytes()


def test_a_write_stages_a_tensor_once_per_call(tmp_path, monkeypatch):
    """A tensor is coerced to host memory once per write call — never once
    per byte run of a strided view (the card's copy is the same call)."""
    calls = []
    real = mio._stage
    monkeypatch.setattr(mio, "_stage", lambda t: calls.append(t) or real(t))
    path = str(tmp_path / "stage.bin")
    data = torch.arange(64, dtype=torch.float32)

    def prog(comm):
        f = mio.file_open(comm, path, mio.MODE_CREATE | mio.MODE_RDWR,
                          shared=True)
        f.set_view(etype=np.float32,
                   filetype=dt.type_vector(64, 1, 2, np.float32))
        assert len(f._byte_runs(0, 64)) == 64     # one run per element
        n0 = len(calls)
        f.write_at(0, data)
        f.write_at_all(0, data + comm.rank)
        f.write_ordered(data[:4])
        f.close()
        return len(calls) - n0

    assert mpi_tpu_torch.run_local(prog, 1, device="cpu") == [3]


def test_reads_return_tensors_on_the_comm_device(tmp_path):
    path = str(tmp_path / "dev.bin")
    with mio.file_open(mpi_tpu_torch.comm_self(device="cpu"), path,
                       mio.MODE_CREATE | mio.MODE_RDWR) as f:
        f.set_view(etype=torch.float64)
        f.write_at(0, np.arange(5.0))
        out = f.read_at(1, 3)
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        assert out.dtype == torch.float64 and out.tolist() == [1.0, 2.0, 3.0]


def test_short_reads_and_ordered_reads_count_elements(tmp_path):
    """``tests/test_io.py`` ``test_short_read_at_eof`` and
    ``test_write_read_ordered_rank_order`` with ``.numel()``."""
    path = str(tmp_path / "b.bin")
    with mio.file_open(mpi_tpu_torch.comm_self(device="cpu"), path,
                       mio.MODE_CREATE | mio.MODE_RDWR) as f:
        f.set_view(etype=np.int32)
        f.write_at(0, np.arange(4, dtype=np.int32))
        assert f.read_at(2, 10).numel() == 2  # short, not an error
        assert f.read_at(9, 5).numel() == 0
    path = str(tmp_path / "ordered.bin")

    def prog(comm):
        f = mio.file_open(comm, path, mio.MODE_CREATE | mio.MODE_RDWR,
                          shared=True)
        n = comm.rank + 1  # ragged: 1, 2, 3 elements
        f.write_ordered(torch.full((n,), comm.rank, dtype=torch.uint8))
        comm.barrier()
        back = f.read_ordered(n)  # the second epoch starts after the first
        f.close()
        return back.numel()

    assert mpi_tpu_torch.run_local(prog, 3, device="cpu") == [0, 0, 0]
    assert np.fromfile(path, dtype=np.uint8).tolist() == [0, 1, 1, 2, 2, 2]


def test_io_rejects_the_spmd_comm():
    def prog(comm):
        with pytest.raises(NotImplementedError, match="checkpoint"):
            mio.file_open(comm, os.devnull, mio.MODE_CREATE | mio.MODE_RDWR)
        return torch.zeros(())

    mpi_tpu_torch.run(prog, nranks=2, device="cpu")
