"""MPI-4 sessions demo (``mpi4.Session``; MPI-4 ch.11) — the port's copy
of ``examples/session_library.py``.

Two independently written libraries inside one application each acquire
their OWN handle to the runtime, derive their own communicators and never
collide with each other's (or the application's) traffic, with nobody
calling MPI_Init or agreeing on tag ranges.  ``stats_lib`` and
``sum_lib`` both follow the sessions recipe (session, pset, group,
communicator) and exchange with the SAME tags at the same time; the
(group, stringtag) contexts keep every exchange private.  Their payloads
are tensors on the base communicator's device.

Run on any host backend::

    python -m mpi_tpu_torch.launcher -n 4 mpi_tpu_torch/examples/session_library.py
    python -m mpi_tpu_torch.launcher -n 4 --device cpu mpi_tpu_torch/examples/session_library.py
"""

import torch

from mpi_tpu_torch import mpi4


def stats_lib(base_comm):
    """A 'library': global mean of a per-rank value, on a private comm."""
    with mpi4.session_init(base_comm=base_comm) as s:
        g = s.group_from_pset("mpi://WORLD")
        c = s.comm_create_from_group(g, stringtag="example.stats")
        x = float(c.rank + 1)
        return c.allreduce(x) / c.size


def sum_lib(base_comm):
    """A second library, same group, different stringtag: its ring
    exchange (tag 0, like anything else) cannot cross-match stats_lib's."""
    with mpi4.session_init(base_comm=base_comm) as s:
        g = s.group_from_pset("mpi://WORLD")
        c = s.comm_create_from_group(g, stringtag="example.sum")
        left = c.shift(torch.tensor([c.rank], dtype=torch.float32,
                                    device=base_comm.device), offset=1)
        return float(c.allreduce(left[0]))


def session_program(comm):
    """The application: uses ITS communicator while both libraries run
    their session-derived exchanges.  Returns (mean, ringsum, app_token),
    identical on every rank."""
    mean = float(stats_lib(comm))
    ringsum = sum_lib(comm)
    token = comm.bcast("app", 0)  # application traffic, unaffected
    return mean, ringsum, token


def main(comm):
    mean, ringsum, token = session_program(comm)
    print(f"rank {comm.rank}: mean={mean} ringsum={ringsum} token={token}")
    return mean, ringsum, token


if __name__ == "__main__":
    import mpi_tpu_torch

    main(mpi_tpu_torch.COMM_WORLD)
