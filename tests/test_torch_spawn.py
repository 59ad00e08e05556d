"""Dynamic processes on the port (``mpi_tpu_torch/spawn.py``), after
``tests/test_spawn.py``: the reference's spawn cases whose child program
imports ``mpi_tpu`` (``WORKER``, :15, and the segments of :79-94), run
with the same child program on ``mpi_tpu_torch``.

``MPI_TPU_DEVICE=cpu`` in the parent's environment is how ``--device
cpu`` reaches spawned children: each child reports its device, ``cpu``
here (the card by default).  The port's spawn, port and name-service
directories carry a prefix of their own, so they never meet the
reference's under a shared temporary directory.
"""

import os
import textwrap

import pytest
import torch

import mpi_tpu_torch
from mpi_tpu import spawn as ref_spawn
from mpi_tpu_torch import spawn
from mpi_tpu_torch.transport.local import run_local

WORKER = textwrap.dedent("""\
    import mpi_tpu_torch
    from mpi_tpu_torch import spawn

    comm = mpi_tpu_torch.COMM_WORLD          # the CHILD world
    parent = spawn.comm_get_parent()
    assert parent is not None and parent.is_inter
    assert spawn.comm_get_parent() is parent  # cached
    assert parent.remote_size == {nparents}
    assert parent.size == comm.size
    x = parent.recv(source=0)          # work item from parent rank 0
    total = comm.allreduce(x + comm.rank)   # child-world collective works
    devices = comm.allgather(comm.device.type)
    if comm.rank == 0:
        parent.send(("result", int(total), devices), dest=0)
    """)


@pytest.fixture(autouse=True)
def _children_on_the_cpu(monkeypatch):
    monkeypatch.setenv("MPI_TPU_DEVICE", "cpu")


def _worker_script(tmp_path, nparents: int) -> str:
    path = tmp_path / "spawn_worker.py"
    path.write_text(WORKER.format(nparents=nparents))
    return str(path)


def test_spawn_from_standalone_parent(tmp_path):
    script = _worker_script(tmp_path, nparents=1)
    parent = mpi_tpu_torch.comm_self(device="cpu")
    inter = spawn.comm_spawn([script], 2, comm=parent)
    assert inter.remote_size == 2 and inter.size == 1
    for j in range(2):
        inter.send(10, dest=j)
    kind, total, devices = inter.recv(source=0)
    # children allreduce (10 + rank) over their 2-rank world: 10+0 + 10+1
    assert (kind, total) == ("result", 21)
    assert devices == ["cpu", "cpu"]
    inter.free()


def test_spawn_from_multirank_parent(tmp_path):
    """Two rank threads spawn one shared child world; the children's
    bridge addressing reaches the right parent."""
    script = _worker_script(tmp_path, nparents=2)

    def prog(comm):
        inter = spawn.comm_spawn([script], 2, comm=comm, root=0)
        assert inter.remote_size == 2 and inter.size == 2
        if comm.rank == 0:
            inter.send(5, dest=0)
            inter.send(5, dest=1)
            out = inter.recv(source=0)
        else:
            out = None
        comm.barrier()
        inter.free()
        return out

    res = run_local(prog, 2, device="cpu")
    assert res[0] == ("result", 11, ["cpu", "cpu"])  # (5+0) + (5+1)


def test_spawn_multiple_segments(tmp_path):
    """spawn_multiple: two scripts share ONE child world with
    segment-ordered ranks."""
    a = tmp_path / "seg_a.py"
    b = tmp_path / "seg_b.py"
    common = textwrap.dedent("""\
        import mpi_tpu_torch
        from mpi_tpu_torch import spawn
        comm = mpi_tpu_torch.COMM_WORLD
        parent = spawn.comm_get_parent()
        """)
    a.write_text(common + textwrap.dedent("""\
        roles = comm.allgather("a")
        if comm.rank == 0:
            parent.send(roles, dest=0)
        """))
    b.write_text(common + 'comm.allgather("b")\n')
    parent = mpi_tpu_torch.comm_self(device="cpu")
    inter = spawn.comm_spawn_multiple([([str(a)], 1), ([str(b)], 2)],
                                      comm=parent)
    assert inter.remote_size == 3
    assert inter.recv(source=0) == ["a", "b", "b"]
    inter.free()


def test_spawn_bridge_transport_closed_on_free(tmp_path):
    """intercomm.free() on a spawn bridge closes its own socket transport
    (no listener or reader threads left per spawn)."""
    script = tmp_path / "noop_worker.py"
    script.write_text(
        "import mpi_tpu_torch\nfrom mpi_tpu_torch import spawn\n"
        "comm = mpi_tpu_torch.COMM_WORLD\n"
        "parent = spawn.comm_get_parent()\n"
        "parent.send(('done', comm.device.type), dest=0)\n")
    inter = spawn.comm_spawn([str(script)], 1,
                             comm=mpi_tpu_torch.comm_self(device="cpu"))
    assert inter.recv(source=0) == ("done", "cpu")
    t = inter._u._t
    inter.free()
    assert t._closing


def test_spawn_rejects_the_spmd_comm():
    def prog(comm):
        with pytest.raises(NotImplementedError, match="launcher"):
            spawn.comm_spawn(["x.py"], 1, comm=comm)
        return torch.zeros(())

    mpi_tpu_torch.run(prog, nranks=2, device="cpu")


def test_directories_never_meet_the_references(tmp_path, monkeypatch):
    """Ports, rendezvous and bridges are ``mtt_spawn_*`` and the default
    registry ``mtt_names_<uid>``; the reference's are ``mpi_tpu_*``."""
    port, ref_port = spawn.open_port(), ref_spawn.open_port()
    try:
        assert os.path.basename(port).startswith("mtt_spawn_port_")
        assert not os.path.basename(ref_port).startswith("mtt_")
    finally:
        spawn.close_port(port)
        ref_spawn.close_port(ref_port)
    monkeypatch.delenv(spawn.ENV_NAMESERVICE, raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert os.path.basename(spawn._name_dir()) == f"mtt_names_{os.getuid()}"
    assert spawn._name_dir() != ref_spawn._name_dir()
    script = tmp_path / "w.py"
    script.write_text("from mpi_tpu_torch import spawn\n"
                      "spawn.comm_get_parent().send('up', dest=0)\n")
    inter = spawn.comm_spawn([str(script)], 1,
                             comm=mpi_tpu_torch.comm_self(device="cpu"))
    assert inter.recv(source=0) == "up"
    inter.free()
    for d in spawn._bridge_dirs[-1:] + spawn._child_dirs[-1:]:
        assert os.path.basename(d).startswith(
            ("mtt_spawn_bridge_", "mtt_spawn_world_"))
