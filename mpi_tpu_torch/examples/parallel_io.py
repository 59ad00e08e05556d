"""MPI-IO: ranks cooperatively write one matrix file.

The port's copy of ``examples/parallel_io.py``.  Each rank owns a column
block of an N x N float32 matrix (N = 8 as the reference's; ``--n`` scales
it), described by a subarray filetype view, and holds it as a tensor on
its device; a collective ``write_at_all`` assembles the file (below the
8 MiB collective-buffering limit, in one aggregated sweep at rank 0);
every rank then reads the whole matrix back — a tensor on its device —
and checks every block, and appends a log line through the shared file
pointer.  Run::

    python -m mpi_tpu_torch.launcher -n 4 mpi_tpu_torch/examples/parallel_io.py
    python -m mpi_tpu_torch.launcher -n 4 --device cpu mpi_tpu_torch/examples/parallel_io.py

The file is ``matrix.bin`` in the launcher's rendezvous directory (removed
with it), or ``--path``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import mpi_tpu_torch
from mpi_tpu_torch import datatypes as dt
from mpi_tpu_torch import io as mio


def run(comm, n: int, path: str) -> str:
    """Write, read back and check the ``n`` x ``n`` matrix at ``path``
    (collective); returns the shared-pointer log on rank 0, '' elsewhere.
    A failed check raises."""
    cols = n // comm.size
    ft = dt.type_create_subarray([n, n], [n, cols], [0, cols * comm.rank],
                                 np.float32)
    f = mio.file_open(comm, path, mio.MODE_CREATE | mio.MODE_RDWR,
                      shared=True)
    f.set_view(etype=np.float32, filetype=ft)
    mine = torch.full((n * cols,), float(comm.rank + 1), dtype=torch.float32,
                      device=comm.device)
    f.write_at_all(0, mine)

    # read the whole matrix back through a plain view, check every block
    f.set_view(etype=np.float32)
    m = f.read_at_all(0, n * n).reshape(n, n)
    assert m.device == comm.device
    for r in range(comm.size):
        assert bool((m[:, r * cols:(r + 1) * cols] == r + 1).all()), m
    comm.barrier()

    # shared-pointer log records: disjoint by construction, any order
    f.set_view(disp=n * n * 4, etype=np.uint8)
    f.write_shared(np.frombuffer(f"rank{comm.rank} ok;".encode(), np.uint8))
    comm.barrier()
    tail = ""
    if comm.rank == 0:
        tail = bytes(f.read_at(0, f.get_size() - n * n * 4).cpu().numpy()
                     ).decode()
        assert tail.count("ok;") == comm.size
    f.close()
    return tail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--path", default=None)
    args = ap.parse_args(argv)
    comm = mpi_tpu_torch.COMM_WORLD
    path = args.path or os.path.join(os.environ.get("MPI_TPU_RDV", "/tmp"),
                                     "matrix.bin")
    tail = run(comm, args.n, path)
    if comm.rank == 0:
        print(f"matrix verified by all ranks; log = {tail}")


if __name__ == "__main__":
    main()
