"""The port's multi-parallel training step (``mpi_tpu_torch.entry``) and its
differentiable fused allreduce against the JAX package on the CPU.

Tolerances: the step is held to the reference's ``_build_step`` at
``rtol=1e-5, atol=1e-6`` (``tests/test_dryrun.py:63-65``); the fused
allreduce's gradients at ``rtol=1e-5, atol=1e-6`` (XLA's psum and the
port's sum over the rank dimension add in different orders).
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as Pspec

import __graft_entry__ as ge
import mpi_tpu_torch
from mpi_tpu.tpu import TpuCommunicator, default_mesh
from mpi_tpu_torch import ops as tops
from mpi_tpu_torch.entry import _build_step, _shapes, _split_axes, dryrun_multichip

RTOL, ATOL = 1e-5, 1e-6


def _inputs(dp, mp, seed=0):
    """The inputs of tests/test_dryrun.py:47-50."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * (0.1 if i >= 2 else 1)).astype(np.float32)
            for i, s in enumerate(_shapes(dp, mp))]


def _jax_step(alg, args):
    """The reference's step on the 2 x 4 CPU mesh, as test_dryrun.py calls it."""
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("dp", "mp"))
    step, in_specs, out_specs = ge._build_step(mesh, 2, 4, dp_algorithm=alg)
    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs))
    with warnings.catch_warnings():
        # the reference's pallas_ring takes its loud ppermute fallback here
        warnings.simplefilter("ignore", RuntimeWarning)
        return [np.asarray(o) for o in f(*[jnp.asarray(a) for a in args])]


@pytest.mark.parametrize("alg", ["ring", "pallas_ring"])
def test_step_matches_reference_2x4(alg):
    args = _inputs(2, 4)
    want = _jax_step(alg, args)
    step = _build_step(2, 4, dp_algorithm=alg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = step(*[torch.from_numpy(a) for a in args])
    assert not caught, [str(w.message) for w in caught]
    for name, g, w in zip(("w1", "w2", "loss", "aux"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_step_spellings_agree_and_second_step_reuses_outputs():
    args = [torch.from_numpy(a) for a in _inputs(2, 4, seed=3)]
    outs = {alg: _build_step(2, 4, dp_algorithm=alg)(*args)
            for alg in ("ring", "pallas_ring")}
    for a, b in zip(outs["ring"], outs["pallas_ring"]):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    w1n, w2n, loss, _ = outs["ring"]
    w1nn, w2nn, loss2, _ = _build_step(2, 4)(args[0], args[1], w1n, w2n)
    assert torch.isfinite(w1nn).all() and torch.isfinite(w2nn).all()
    assert float(loss2) < float(loss)  # a gradient step lowers the loss


def test_step_gradients_equal_the_dense_step():
    """w1/w2 after the 2 x 4 step equal one SGD step (lr 0.1) on the sum
    over the dp shards of the shard losses (each the mean over its rows),
    computed densely in float64, and the step's loss is that sum: the
    reference's weights enter replicated over dp, so JAX sums their
    gradients over dp before the explicit dp mean."""
    x, y, w1, w2 = _inputs(2, 4, seed=5)
    got = _build_step(2, 4)(*[torch.from_numpy(a) for a in (x, y, w1, w2)])
    t = [torch.from_numpy(a).double() for a in (x, y, w1, w2)]
    xs, ys = t[0].reshape(2, -1, 8), t[1].reshape(2, -1, 8)

    def shard_losses(w1, w2):
        return torch.stack([torch.mean((torch.relu(xs[i] @ w1) @ w2 - ys[i]) ** 2)
                            for i in range(2)])

    g1, g2 = torch.func.grad(lambda a, b: shard_losses(a, b).sum(),
                             argnums=(0, 1))(t[2], t[3])
    want = (t[2] - 0.1 * g1, t[3] - 0.1 * g2, shard_losses(t[2], t[3]).sum())
    for g, w in zip(got[:3], want):
        torch.testing.assert_close(g.double(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip_on_cpu(n, capsys):
    dryrun_multichip(n, device="cpu")
    dp, mp = _split_axes(n)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip OK: mesh=({dp}x{mp}) loss=")
    assert ("plain(" in line) == (n >= 2)


def test_dryrun_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


# -- the fused allreduce's gradient --------------------------------------------


def _port_grads(comm, x, w):
    def prog(cm, x, w):
        def loss(w_):
            return torch.sum(comm.allreduce(x[cm.rank] * w_, algorithm="fused") ** 2)
        return torch.func.grad(loss)(w[cm.rank])

    return mpi_tpu_torch.run(prog, x, w, nranks=8, device="cpu").numpy()


def _jax_grads(comm, mesh, spec, x, w):
    """jax.grad of sum(psum(x·w)²) on each rank: a loss of the reduced
    (replicated) value alone."""
    def per(xb, wb):
        def loss(w_):
            return jnp.sum(comm.allreduce(xb.reshape(1, -1) * w_,
                                          algorithm="fused") ** 2)
        return jax.grad(loss)(wb.reshape(1, -1)).reshape(wb.shape)

    f = jax.jit(jax.shard_map(per, mesh=mesh, in_specs=(Pspec(*spec),) * 2,
                              out_specs=Pspec(*spec)))
    shape = tuple(mesh.devices.shape) + (x.shape[-1],)
    return np.asarray(f(*(a.reshape(shape) for a in (x, w)))).reshape(x.shape)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(8, 3).astype(np.float32), rng.randn(8, 3).astype(np.float32)


def test_fused_allreduce_gradient_whole_world():
    """Each rank's gradient of sum(psum(x·w)²) is its own cotangent 2·y·x,
    not 8 times it — as jax.grad through shard_map gives."""
    x, w = _data()
    mesh = default_mesh(8)
    want = _jax_grads(TpuCommunicator("world", mesh), mesh, ("world",), x, w)
    got = _port_grads(mpi_tpu_torch.TorchCommunicator(8), x, w)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    y = np.broadcast_to((x * w).sum(0), x.shape)
    np.testing.assert_allclose(got, 2 * y * x, rtol=RTOL, atol=ATOL)


def test_fused_allreduce_gradient_split_groups():
    """A split_by communicator of two groups of four equals the reference's
    'mp' axis of a 2 x 4 mesh (the groups of the dry run).  The
    reference's 1-D split_by spelling (psum_scatter + all_gather) instead
    transposes to the group sum of the cotangents: recorded here as the
    one case where the two packages differ, by the group size."""
    x, w = _data(1)
    halves = mpi_tpu_torch.TorchCommunicator(8).split_by(lambda i: i // 4)
    got = _port_grads(halves, x, w)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "mp"))
    want = _jax_grads(TpuCommunicator("mp", mesh), mesh, ("dp", "mp"), x, w)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    mesh1 = default_mesh(8)
    jhalves = TpuCommunicator("world", mesh1).split_by(lambda i: i // 4)
    summed = _jax_grads(jhalves, mesh1, ("world",), x, w)
    np.testing.assert_allclose(summed, 4 * got, rtol=RTOL, atol=ATOL)


def test_fused_allreduce_keeps_integer_and_bool_payloads():
    """The differentiable fused reduction still reduces payloads that have
    no gradient: integer SUM and MAX, and the masked bool broadcast."""
    world = mpi_tpu_torch.TorchCommunicator(8)
    halves = world.split_by(lambda i: i // 4)

    def prog(comm):
        r = comm.rank.to(torch.int32)
        return (halves.allreduce(r, algorithm="fused"),
                halves.allreduce(r, op=tops.MAX, algorithm="fused"),
                halves.bcast(r % 2 == 1, root=1, algorithm="fused"))

    s, m, b = mpi_tpu_torch.run(prog, comm=world, device="cpu")
    assert s.tolist() == [6] * 4 + [22] * 4 and s.dtype == torch.int32
    assert m.tolist() == [3] * 4 + [7] * 4
    assert b.tolist() == [True] * 8 and b.dtype == torch.bool


@pytest.mark.parametrize("op", ["MAX", "MIN"])
def test_fused_max_min_have_no_gradient(op):
    x = np.random.RandomState(4).randn(8, 3).astype(np.float32)

    def prog(comm, x):
        return torch.func.grad(lambda v: torch.sum(
            comm.allreduce(v, op=getattr(tops, op), algorithm="fused")))(x[comm.rank])

    with pytest.raises(RuntimeError, match=f"fused {op} allreduce has no gradient"):
        mpi_tpu_torch.run(prog, x, nranks=8, device="cpu")


# -- the SUM backward's rule where the reduced value meets varying values --------


def _mixed_port(comm, x, w, y, localize=False):
    """Each rank's gradient of sum(allreduce(x_r·w_r, fused) · y_r), the
    reduced value optionally marked by comm.localize."""
    def prog(cm, x, w, y):
        def loss(w_):
            r = comm.allreduce(x[cm.rank] * w_, algorithm="fused")
            return torch.sum((comm.localize(r) if localize else r) * y[cm.rank])
        return torch.func.grad(loss)(w[cm.rank])

    return mpi_tpu_torch.run(prog, x, w, y, nranks=8, device="cpu").numpy()


def _mixed_jax(comm, mesh, spec, x, w, y):
    def per(xb, wb, yb):
        def loss(w_):
            r = comm.allreduce(xb.reshape(1, -1) * w_, algorithm="fused")
            return jnp.sum(r * yb.reshape(1, -1))
        return jax.grad(loss)(wb.reshape(1, -1)).reshape(wb.shape)

    f = jax.jit(jax.shard_map(per, mesh=mesh, in_specs=(Pspec(*spec),) * 3,
                              out_specs=Pspec(*spec)))
    shape = tuple(mesh.devices.shape) + (x.shape[-1],)
    return np.asarray(f(*(a.reshape(shape) for a in (x, w, y)))).reshape(x.shape)


def test_fused_allreduce_gradient_meeting_varying_values():
    """The program of ROADMAP Queue 3 item 1: the reduced value times a
    rank-varying y.  JAX's pvary sums that branch's cotangents over the
    group (x·Σ_s y_s); the port gave x·y_r, a max difference of 11.9.  Now
    comm.localize on the reduced value is that pvary and gives JAX's
    result; without it the cotangents differ and the backward raises,
    naming comm.localize."""
    x, w = _data()
    y = np.random.RandomState(0).randn(8, 3).astype(np.float32)
    mesh = default_mesh(8)
    want = _mixed_jax(TpuCommunicator("world", mesh), mesh, ("world",), x, w, y)
    np.testing.assert_allclose(want, x * y.sum(0), rtol=RTOL, atol=ATOL)
    world = mpi_tpu_torch.TorchCommunicator(8)
    got = _mixed_port(world, x, w, y, localize=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(RuntimeError, match=r"comm\.localize"):
        _mixed_port(world, x, w, y)


def test_fused_allreduce_gradient_meeting_varying_values_per_group():
    """Two groups of four (the 2 x 4 mesh's mp axis): each group sums its
    own cotangents at the mark, and the unmarked program raises."""
    x, w = _data(2)
    y = np.random.RandomState(3).randn(8, 3).astype(np.float32)
    halves = mpi_tpu_torch.TorchCommunicator(8).split_by(lambda i: i // 4)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "mp"))
    want = _mixed_jax(TpuCommunicator("mp", mesh), mesh, ("dp", "mp"), x, w, y)
    got = _mixed_port(halves, x, w, y, localize=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(RuntimeError, match=r"comm\.localize"):
        _mixed_port(halves, x, w, y)


def _residual_port(comm, x, w, u, localize):
    """Each rank's gradient of sum(h2²) for the residual tensor-parallel
    block h1 = allreduce(x_r·w_r), h2 = h1 + allreduce(h1·u_r), with h1's
    varying use optionally marked by comm.localize."""
    def prog(cm, x, w, u):
        def loss(w_):
            h1 = comm.allreduce(x[cm.rank] * w_, algorithm="fused")
            h1v = comm.localize(h1) if localize else h1
            h2 = h1 + comm.allreduce(h1v * u[cm.rank], algorithm="fused")
            return torch.sum(h2 ** 2)
        return torch.func.grad(loss)(w[cm.rank])

    return mpi_tpu_torch.run(prog, x, w, u, nranks=8, device="cpu").numpy()


def _residual_jax(comm, mesh, spec, x, w, u):
    def per(xb, wb, ub):
        def loss(w_):
            h1 = comm.allreduce(xb.reshape(1, -1) * w_, algorithm="fused")
            h2 = h1 + comm.allreduce(h1 * ub.reshape(1, -1), algorithm="fused")
            return jnp.sum(h2 ** 2)
        return jax.grad(loss)(wb.reshape(1, -1)).reshape(wb.shape)

    f = jax.jit(jax.shard_map(per, mesh=mesh, in_specs=(Pspec(*spec),) * 3,
                              out_specs=Pspec(*spec)))
    shape = tuple(mesh.devices.shape) + (x.shape[-1],)
    return np.asarray(f(*(a.reshape(shape) for a in (x, w, u)))).reshape(x.shape)


@pytest.mark.parametrize("split", [False, True])
def test_residual_block_gradient(split):
    """The residual block sums only the varying branch's cotangents:
    h1's is c + Σ_s c·u_s (c = 2·h2), not Σ_s (c + c·u_s), which a rule
    summing every differing cotangent would give.  With comm.localize at
    h1's varying use the port equals jax.grad; without it, it raises."""
    x, w = _data(7)
    u = np.random.RandomState(8).randn(8, 3).astype(np.float32)
    if split:
        comm = mpi_tpu_torch.TorchCommunicator(8).split_by(lambda i: i // 4)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "mp"))
        want = _residual_jax(TpuCommunicator("mp", mesh), mesh, ("dp", "mp"), x, w, u)
    else:
        comm = mpi_tpu_torch.TorchCommunicator(8)
        mesh = default_mesh(8)
        want = _residual_jax(TpuCommunicator("world", mesh), mesh, ("world",), x, w, u)
    np.testing.assert_allclose(_residual_port(comm, x, w, u, True), want,
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(RuntimeError, match=r"comm\.localize"):
        _residual_port(comm, x, w, u, False)


def test_varying_values_equal_by_chance_need_localize():
    """Recorded difference: a y sharded over the ranks whose shards happen
    to be equal is still rank-varying to JAX, which sums the cotangents
    (8·x·y).  The port sees equal cotangents, as of replicated
    computation, and keeps them (x·y); comm.localize on the reduced value
    is the reference's pvary and gives JAX's sum."""
    x, w = _data(4)
    y = np.broadcast_to(np.random.RandomState(5).randn(3), (8, 3)).astype(np.float32)
    mesh = default_mesh(8)
    want = _mixed_jax(TpuCommunicator("world", mesh), mesh, ("world",), x, w, y)
    np.testing.assert_allclose(want, 8 * x * y, rtol=RTOL, atol=ATOL)
    world = mpi_tpu_torch.TorchCommunicator(8)
    np.testing.assert_allclose(_mixed_port(world, x, w, y), x * y, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_mixed_port(world, x, w, y, localize=True), want,
                               rtol=RTOL, atol=ATOL)


def test_localize_transposes_like_pvary():
    """comm.localize is the reference's pvary: the gradient through a value
    the same on every rank is summed over the group; through a value that
    already varies, it passes unchanged — in both packages."""
    x, w = _data(6)
    w0 = w[0]
    mesh = default_mesh(8)
    comm = TpuCommunicator("world", mesh)

    def tprog(cm, x, w, w0):
        grad = torch.func.grad(lambda v: torch.sum(cm.localize(v) * x[cm.rank]))
        return grad(w[cm.rank]), grad(w0)

    varying, replicated = (t.numpy() for t in mpi_tpu_torch.run(
        tprog, x, w, w0, nranks=8, device="cpu"))

    def per(xb, wb, v0):
        grad = jax.grad(lambda v: jnp.sum(comm.localize(v) * xb.reshape(-1)))
        return grad(wb.reshape(-1)).reshape(wb.shape), grad(v0)

    f = jax.jit(jax.shard_map(per, mesh=mesh,
                              in_specs=(Pspec("world"), Pspec("world"), Pspec()),
                              out_specs=(Pspec("world"), Pspec())))
    want_varying, want_replicated = (np.asarray(o) for o in f(x, w, w0))
    np.testing.assert_allclose(varying, want_varying, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(varying, x, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(replicated, np.broadcast_to(want_replicated, x.shape),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(want_replicated, x.sum(0), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("groups", [[[0, 1, 2, 3], [4, 5, 6, 7]], [[0, 4], [1, 5], [2, 6], [3, 7]],
                                    [[3, 0, 6, 5], [1, 7, 2, 4]]])
def test_group_cotangent_world_per_group(groups):
    """The SUM backward on the world, for contiguous, strided and shuffled
    groups: the cotangents pass unchanged where every group's are equal,
    and it raises where one group's differ; with localize's mask, the
    marked ranks take the group sum (in group-rank order, float32)."""
    from mpi_tpu_torch.gpu.primitives import _MISSING_LOCALIZE, group_cotangent_world

    assert len(_MISSING_LOCALIZE) < 255  # the card's aten._assert_async limit
    w = torch.from_numpy(np.random.RandomState(7).randn(8, 5).astype(np.float32))
    flat = [r for g in groups for r in g]
    size = len(groups[0])
    with pytest.raises(RuntimeError, match=r"comm\.localize"):
        group_cotangent_world(w, flat, size)
    for g in groups[:-1]:
        w[g] = w[g[0]].clone()
    with pytest.raises(RuntimeError, match=r"comm\.localize"):
        group_cotangent_world(w, flat, size)  # the last group's still differ
    eq = w.clone()
    eq[groups[-1]] = eq[groups[-1][0]].clone()
    assert torch.equal(group_cotangent_world(eq, flat, size), eq)
    mask = torch.zeros(8, dtype=torch.bool)
    mask[groups[1]] = True  # localize's transpose: the marked ranks sum
    got = group_cotangent_world(w, flat, size, mask)
    for gi, g in enumerate(groups):
        for r in g:
            want = sum(w[s] for s in g) if gi == 1 else w[r]
            torch.testing.assert_close(got[r], want, rtol=RTOL, atol=ATOL)
