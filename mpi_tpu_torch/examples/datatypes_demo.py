"""Derived-datatypes demo: matrix-column exchange with MPI_Type_vector —
the port's copy of ``examples/datatypes_demo.py``.

Rank 0 owns a matrix and sends its column 2 (a strided layout: no copy
loop in user code, the datatype describes it); rank 1 receives it into
column 0 of a zero matrix by the typed-recv unpack.  The matrices are
float64 tensors on the ranks' device (``api.MPI_Send`` gathers with
``Datatype.pack_torch`` there, ``MPI_Recv`` scatters in place).  Run::

    python -m mpi_tpu_torch.launcher -n 2 mpi_tpu_torch/examples/datatypes_demo.py
    python -m mpi_tpu_torch.launcher -n 2 --device cpu mpi_tpu_torch/examples/datatypes_demo.py
"""

import numpy as np
import torch

from mpi_tpu_torch import datatypes as dt
from mpi_tpu_torch.api import MPI_Recv, MPI_Send

NROWS, NCOLS = 4, 5


def demo(comm):
    """Rank 0 sends column 2 and returns its matrix; rank 1 returns the
    matrix it unpacked column 0 into."""
    col = dt.type_vector(NROWS, 1, NCOLS, np.float64).commit()
    if comm.rank == 0:
        a = torch.arange(NROWS * NCOLS, dtype=torch.float64,
                         device=comm.device).reshape(NROWS, NCOLS)
        col2 = dt.Datatype(col.base_dtype, col.indices + 2, col.extent)
        MPI_Send(a, dest=1, comm=comm, datatype=col2)
        return a
    out = torch.zeros((NROWS, NCOLS), dtype=torch.float64, device=comm.device)
    MPI_Recv(source=0, comm=comm, datatype=col, buf=out)
    return out


def main(comm) -> None:
    assert comm.size == 2, "run with -n 2"
    out = demo(comm)
    if comm.rank == 0:
        print(f"rank 0 sent column 2: {out[:, 2].tolist()}")
        return
    expect = torch.arange(2, NROWS * NCOLS, NCOLS, dtype=torch.float64)
    assert torch.equal(out[:, 0].cpu(), expect), out
    assert bool((out[:, 1:] == 0).all())
    print(f"rank 1 unpacked into column 0: {out[:, 0].tolist()} OK")


if __name__ == "__main__":
    import mpi_tpu_torch

    main(mpi_tpu_torch.COMM_WORLD)
    mpi_tpu_torch.finalize()
