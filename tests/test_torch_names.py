"""The port's top-level names against the reference's ``__all__``
(ROADMAP Queue 3 item 2).

Every name of ``mpi_tpu.__all__`` is bound in ``mpi_tpu_torch`` except
those of modules still to be ported, each listed with its ROADMAP item,
so the list can only shrink (it is empty since the serve layer landed).
``COMM_WORLD`` and ``COMM_SELF`` are read lazily by both packages
(reading ``COMM_WORLD`` builds the world, which needs a card without
``device=``), and so is ``serve`` (the module is also the workers' ``-m``
entry point, so neither package imports it with itself): they are
checked as lazy names."""

import pytest
import torch

import mpi_tpu
import mpi_tpu_torch

UNPORTED: dict = {}
LAZY = ("COMM_WORLD", "COMM_SELF", "serve")


def test_every_reference_name_is_bound_or_listed_unported():
    missing = [n for n in mpi_tpu.__all__
               if n not in LAZY and n not in dir(mpi_tpu_torch)]
    assert sorted(missing) == sorted(UNPORTED), (
        f"missing and not listed: {sorted(set(missing) - set(UNPORTED))}; "
        f"listed but bound now (drop them): {sorted(set(UNPORTED) - set(missing))}")
    assert set(UNPORTED) <= set(mpi_tpu.__all__)
    assert set(UNPORTED.values()) <= {"16.3c"}


def test_the_ports_all_holds_the_references_less_the_unported():
    assert (set(mpi_tpu.__all__) - set(UNPORTED)) <= set(mpi_tpu_torch.__all__)
    for n in mpi_tpu_torch.__all__:
        if n not in LAZY:
            assert hasattr(mpi_tpu_torch, n), n


@pytest.mark.parametrize("name", ["SUM", "PROD", "MAX", "MIN", "LAND", "LOR",
                                  "LXOR", "BAND", "BOR", "BXOR"])
def test_op_constants_are_the_ops_modules(name):
    assert getattr(mpi_tpu_torch, name) is getattr(mpi_tpu_torch.ops, name)
    assert getattr(mpi_tpu_torch, name).name == getattr(mpi_tpu, name).name


def test_names_are_the_port_modules_objects():
    from mpi_tpu_torch import communicator, group, membership, window
    from mpi_tpu_torch.transport import base, local

    assert mpi_tpu_torch.P2PCommunicator is communicator.P2PCommunicator
    assert mpi_tpu_torch.Status is communicator.Status
    assert mpi_tpu_torch.Group is group.Group
    assert mpi_tpu_torch.P2PWindow is window.P2PWindow
    assert mpi_tpu_torch.GetFuture is window.GetFuture
    assert mpi_tpu_torch.rejoin is membership.rejoin
    assert mpi_tpu_torch.run_local is local.run_local
    assert (mpi_tpu_torch.ANY_SOURCE, mpi_tpu_torch.ANY_TAG) == (
        base.ANY_SOURCE, base.ANY_TAG) == (mpi_tpu.ANY_SOURCE, mpi_tpu.ANY_TAG)
    assert mpi_tpu_torch.__version__ == mpi_tpu.__version__
    for sub in ("checkpoint", "ft", "progress", "trace", "verify", "mpi4",
                "api", "membership", "profiling", "telemetry", "schedules",
                "checker", "errors", "io", "spawn", "serve"):
        assert getattr(mpi_tpu_torch, sub).__name__ == f"mpi_tpu_torch.{sub}"


def test_a_host_program_reads_the_same_names():
    """``import mpi_tpu as mpi; mpi.SUM`` style: one program, either
    package, the same results on rank threads."""
    def prog(c, m, arr):
        st = m.Status()
        if c.rank == 0:
            c.send(arr([1.0, 2.0]), 1, tag=3)
        got = c.recv(m.ANY_SOURCE, m.ANY_TAG, st) if c.rank == 1 else None
        return (float(c.allreduce(arr([float(c.rank)]), m.MAX)[0]),
                None if got is None else (st.source, st.tag))

    ref = mpi_tpu.run_local(lambda c: prog(c, mpi_tpu, lambda a: a), 2)
    got = mpi_tpu_torch.run_local(lambda c: prog(c, mpi_tpu_torch, torch.tensor),
                                  2, device="cpu")
    assert ref == got == [(1.0, None), (1.0, (0, 3))]


def test_run_keeps_its_spmd_default():
    out = mpi_tpu_torch.run(lambda c: c.allreduce(c.rank.float()), nranks=4,
                            device="cpu")
    assert out.tolist() == [6.0] * 4


def test_comm_self_and_is_initialized():
    def prog(c):
        s = mpi_tpu_torch.comm_self()
        assert s is mpi_tpu_torch.COMM_SELF  # per thread, created once
        return s.size, s.rank, s.device.type, float(s.allreduce(torch.tensor(
            float(c.rank) + 1.0)))

    assert mpi_tpu_torch.run_local(prog, 3, device="cpu") == [
        (1, 0, "cpu", 1.0), (1, 0, "cpu", 2.0), (1, 0, "cpu", 3.0)]
    # a rank thread's SELF is not the process world
    assert mpi_tpu_torch.is_initialized() == (mpi_tpu_torch._world is not None)

    def ident(c):
        s = mpi_tpu_torch.comm_self()
        c.barrier()  # every rank's SELF alive at once
        return id(s)

    selves = mpi_tpu_torch.run_local(ident, 3, device="cpu")
    assert len(set(selves)) == 3  # one per rank thread, as the reference's
