"""The card's test tier — counterpart of ``tests/test_tpu_real.py``.

Run on a machine with the card (this file imports no JAX; the env var stops
``tests/conftest.py`` importing it)::

    MPI_TPU_TEST_TPU=1 python -m pytest -q -m gpu tests/test_torch_gpu_real.py

Two families, as the reference's:

* **P=1 degenerate semantics on the card** (``gpu`` marker; skip without
  a card): every collective by every algorithm runs on one rank and
  returns the degenerate result, exactly; ``entry.entry()`` runs there.
* **Ahead-of-time traces of the P=8 programs** (``test_tpu_real.py:103-266``,
  the ``AbstractMesh`` lowerings), each for two targets.  For the card
  (``gpu`` marker) the program is traced by ``mpi_tpu_torch.aot`` on fake
  CUDA tensors — nothing is built, allocated or launched — and each kernel
  launch must be its graph node (K1 ``ring_fold`` / ``ring_gather``, K2
  ``attn_fwd``, K3 ``attn_bwd_dq`` / ``attn_bwd_dkv``).  Fake CUDA tensors
  need a PyTorch built with CUDA, and a backward pass needs the card
  itself, so these skip elsewhere.  For the CPU (unmarked, run anywhere)
  the trace holds the plain versions and no kernel node, and the traced
  graph runs bitwise equal to the eager program on seeded inputs.
"""

import math

import pytest
import torch

import mpi_tpu_torch
from mpi_tpu_torch import aot, entry, ops
from mpi_tpu_torch.gpu.attention import ring_attention

P = 8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: MPI_TPU_TEST_TPU=1 pytest -m gpu "
                    "tests/test_torch_gpu_real.py on the card)")


def _run1(fn):
    """fn(comm, x) on the card, P = 1; returns (result of rank 0, x)."""
    _card()
    x = torch.arange(8.0)
    out = mpi_tpu_torch.run(fn, x, nranks=1)
    assert out.device.type == "cuda"
    return out[0].cpu(), x


# ---- P=1 degenerate semantics on the card -------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["fused", "ring", "recursive_halving",
                                       "reduce_bcast", "pallas_ring"])
def test_allreduce_degenerate(algorithm):
    got, x = _run1(lambda c, v: c.allreduce(v, algorithm=algorithm))
    assert torch.equal(got, x)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["fused", "tree"])
def test_bcast_reduce_degenerate(algorithm):
    got, x = _run1(lambda c, v: c.bcast(v, 0, algorithm))
    assert torch.equal(got, x)
    got, x = _run1(lambda c, v: c.reduce(v, ops.MAX, 0, algorithm))
    assert torch.equal(got, x)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["fused", "ring", "doubling", "pallas_ring"])
def test_allgather_degenerate(algorithm):
    got, x = _run1(lambda c, v: c.allgather(v, algorithm=algorithm))
    assert torch.equal(got.reshape(-1), x)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["fused", "pairwise"])
def test_alltoall_degenerate(algorithm):
    got, x = _run1(lambda c, v: c.alltoall(v.reshape(1, 8), algorithm=algorithm))
    assert torch.equal(got.reshape(-1), x)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["fused", "ring", "pallas_ring"])
def test_reduce_scatter_scan_degenerate(algorithm):
    got, x = _run1(lambda c, v: c.reduce_scatter(v.reshape(1, 8), algorithm=algorithm))
    assert torch.equal(got, x)
    got, x = _run1(lambda c, v: c.scan(v))
    assert torch.equal(got, x)


@pytest.mark.gpu
def test_attention_size1_runs_on_the_card():
    """P=1 ring attention on the card is local attention (rtol 2e-4,
    atol 2e-5, as test_tpu_real.py:238)."""
    _card()
    g = torch.Generator().manual_seed(2)
    q = torch.randn(8, 128, generator=g)
    out = mpi_tpu_torch.run(lambda c, t: ring_attention(t, t, t, c), q, nranks=1)
    s = (q.double() @ q.double().T) / math.sqrt(128)
    want = torch.softmax(s, dim=-1) @ q.double()
    torch.testing.assert_close(out[0].cpu().double(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
def test_entry_runs_on_the_card():
    """``entry()`` runs on one card, as a test (test_tpu_real.py:91)."""
    _card()
    f, (grid,) = entry.entry(8)
    new, residual = f(grid)
    torch.cuda.synchronize()
    assert new.shape == grid.shape and new.device.type == "cuda"
    assert bool(torch.isfinite(residual))


# ---- ahead-of-time traces of the P=8 programs ---------------------------------


TARGETS = [pytest.param("cuda", marks=pytest.mark.gpu), "cpu"]


def _cuda_build():
    if torch.version.cuda is None:
        pytest.skip("a trace for the card needs a PyTorch built with CUDA (run: "
                    "MPI_TPU_TEST_TPU=1 pytest -m gpu tests/test_torch_gpu_real.py "
                    "on the card)")


def _real(avals, seed=0):
    """Seeded CPU tensors of ``avals`` (tensors give shape and dtype,
    tuples are float32 shapes)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(tuple(a.shape), generator=g).to(a.dtype)
            if hasattr(a, "dtype") else torch.randn(tuple(a), generator=g)
            for a in avals]


def _lower8(fn, avals, target):
    """``fn``'s 8-rank program traced for ``target``.  For the card, each
    kernel launch is a graph node; for the CPU, the graph holds no kernel
    node and runs bitwise equal to the eager program."""
    if target == "cuda":
        _cuda_build()
    graph = aot.lower_spmd(fn, *avals, nranks=P, device=target)
    if target == "cpu":
        assert aot.kernel_nodes(graph) == {}
        args = _real(avals)
        got = torch.utils._pytree.tree_leaves(graph(*args))
        want = torch.utils._pytree.tree_leaves(
            mpi_tpu_torch.run(fn, *args, nranks=P, device="cpu"))
        assert len(got) == len(want)
        for g, e in zip(got, want):
            assert torch.equal(g, e)
    return graph


def _kernels(fn, avals, target, want):
    graph = _lower8(fn, avals, target)
    if target == "cuda":
        assert aot.kernel_nodes(graph) == want
    return graph


def _fold(graph, target):
    """The ``ring_fold`` node of a trace for the card (None for the CPU)."""
    if target == "cpu":
        return None
    fold, = [n for n in graph.graph.nodes if "ring_fold" in str(n.target)]
    return fold


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("algorithm", ["fused", "ring", "recursive_halving",
                                       "reduce_bcast", "pallas_ring"])
def test_allreduce8_lowers(algorithm, target):
    _kernels(lambda c, v: c.allreduce(v[c.rank], algorithm=algorithm), [(P, 1024)],
             target, {"ring_fold": 1} if algorithm == "pallas_ring" else {})


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("algorithm", ["tree", "fused"])
def test_tree8_lowers(algorithm, target):
    _kernels(lambda c, v: c.bcast(v[c.rank], 3, algorithm), [(P, 256)], target, {})
    _kernels(lambda c, v: c.reduce(v[c.rank], ops.SUM, 2, algorithm), [(P, 256)],
             target, {})


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("algorithm", ["pairwise", "fused"])
def test_alltoall8_lowers(algorithm, target):
    _kernels(lambda c, v: c.alltoall(v[c.rank].reshape(P, 32), algorithm=algorithm),
             [(P, P * 32)], target, {})


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pallas_ring8_lowers(dtype, target):
    """test_tpu_real.py:133: the multi-segment shape (32 768 elements per
    rank: 256 rows, four tiles of 64 rows, four segments)."""
    from mpi_tpu_torch.gpu import ring

    n = P * 256 * 128
    rows = ring._geometry(n, P, 64)[0]
    assert len(ring._segments(rows // 64)) == 4
    _kernels(lambda c, v: ring.ring_allreduce(v[c.rank].reshape(-1), P, tile_rows=64),
             [torch.empty((P, n // P), dtype=dtype, device="meta")], target,
             {"ring_fold": 1})


@pytest.mark.parametrize("target", TARGETS)
def test_pallas_reduce_scatter8_lowers(target):
    graph = _kernels(lambda c, v: c.reduce_scatter(v[c.rank].reshape(P, 1024),
                                                   algorithm="pallas_ring"),
                     [(P, P * 1024)], target, {"ring_fold": 1})
    fold = _fold(graph, target)
    assert fold is None or fold.args[-1] is True  # the scatter mode


@pytest.mark.parametrize("target", TARGETS)
def test_pallas_ring8_grouped_lowers(target):
    groups = [[0, 2, 4, 6], [1, 3, 5, 7]]
    comm = mpi_tpu_torch.TorchCommunicator.from_groups(groups)
    graph = _kernels(lambda c, v: comm.allreduce(v[c.rank], algorithm="pallas_ring"),
                     [(P, 64 * 128)], target, {"ring_fold": 1})
    fold = _fold(graph, target)
    assert fold is None or (fold.args[1] == [0, 2, 4, 6, 1, 3, 5, 7]
                            and fold.args[2] == 4)


@pytest.mark.parametrize("target", TARGETS)
def test_pallas_ring8_max_lowers(target):
    graph = _kernels(lambda c, v: c.allreduce(v[c.rank], op=ops.MAX,
                                              algorithm="pallas_ring"),
                     [(P, 64 * 128)], target, {"ring_fold": 1})
    fold = _fold(graph, target)
    assert fold is None or fold.args[3] == "max"


@pytest.mark.parametrize("target", TARGETS)
def test_pallas_allgather8_lowers(target):
    _kernels(lambda c, v: c.allgather(v[c.rank], algorithm="pallas_ring"),
             [(P, 64 * 128 * 4)], target, {"ring_gather": 1})


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention8_lowers(dtype, target):
    """test_tpu_real.py:216: the forward kernel of an 8-rank ring."""
    aval = torch.empty((P * 64, 128), dtype=dtype, device="meta")

    def fwd(c, q, k, v):
        blk = lambda t: t.reshape(P, 64, 128)[c.rank]
        return ring_attention(blk(q), blk(k), blk(v), c, causal=True)

    _kernels(fwd, [aval] * 3, target, {"attn_fwd": 1})


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention8_value_and_grad_lowers(dtype, target):
    """Forward and backward (K2, K3) of an 8-rank ring under
    ``torch.func.grad_and_value`` (for the card, a trace with a backward
    pass needs the card), and the world-level backward alone."""
    from mpi_tpu_torch.gpu import attention

    aval = torch.empty((P * 64, 128), dtype=dtype, device="meta")

    def train(c, q):
        qb = q.reshape(P, 64, 128)[c.rank]
        return torch.func.grad_and_value(lambda t: torch.sum(
            ring_attention(t, t, t, c, causal=True).float() ** 2))(qb)

    if target == "cuda":
        _card()
    _kernels(train, [aval], target,
             {"attn_fwd": 1, "attn_bwd_dq": 1, "attn_bwd_dkv": 1})
    if target == "cuda":
        world = torch.empty((P, 1, 64, 128), dtype=dtype, device="meta")
        lse = torch.empty((P, 1, 64), device="meta")
        bwd = aot.lower(lambda q, l: attention.ring_attention_bwd_world(
            q, q, q, q, l, q, causal=True), world, lse, device="cuda")
        assert aot.kernel_nodes(bwd) == {"attn_bwd_dq": 1, "attn_bwd_dkv": 1}


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("alg", ["ring", "pallas_ring"])
def test_dryrun_step8_lowers(alg, target):
    """test_tpu_real.py:166 and :258: the dry run's step for 8 ranks."""
    if target == "cuda":
        _card()
    graph = entry.lower_multichip(8, alg, device=target)
    nodes = aot.kernel_nodes(graph)
    if target == "cpu":
        assert nodes == {}
        args = _real(entry._shapes(*entry._split_axes(8)))
        for g, e in zip(graph(*args), entry._build_step(2, 4, alg)(*args)):
            assert torch.equal(g, e)
        return
    assert nodes.get("ring_fold") == (1 if alg == "pallas_ring" else None)
    assert nodes.get("attn_fwd", 0) >= 1, nodes


# ---- kernel ops in traces for the card --------------------------------------

DP_GROUPS = [[0, 4], [1, 5], [2, 6], [3, 7]]


def _step_kernels(comm, g, x):
    """The step's two kernel calls as it spells them: the dp sync of a
    gradient by pallas_ring and the causal ring attention over mp."""
    comm_mp = mpi_tpu_torch.TorchCommunicator.from_groups([[0, 1, 2, 3], [4, 5, 6, 7]])
    comm_dp = mpi_tpu_torch.TorchCommunicator.from_groups(DP_GROUPS)
    synced = comm_dp.allreduce(g, algorithm="pallas_ring")
    att_in = torch.tanh(torch.mean(x)).expand(8, 128)
    return synced, ring_attention(att_in, att_in, att_in, comm_mp, causal=True)


@pytest.mark.gpu
def test_the_steps_kernels_are_graph_nodes_for_the_card():
    _cuda_build()
    graph = aot.lower_spmd(_step_kernels, (8, 16), (4, 8), nranks=8, device="cuda")
    assert aot.kernel_nodes(graph) == {"ring_fold": 1, "attn_fwd": 1}
    fold, = [n for n in graph.graph.nodes if "ring_fold" in str(n.target)]
    assert fold.args[1] == [w for g in DP_GROUPS for w in g] and fold.args[2] == 2
    for n in graph.graph.nodes:
        val = n.meta.get("val")
        if isinstance(val, torch.Tensor) and n.op == "call_function":
            assert val.device.type in ("cuda", "cpu"), (n, val.device)


@pytest.mark.gpu
def test_cuda_export_round_trips_on_fake_tensors(tmp_path):
    from mpi_tpu_torch.gpu import ring

    _cuda_build()
    program = aot.export(lambda g, x: ring.allreduce_world(g, DP_GROUPS),
                         (8, 4, 16), (2,), device="cuda")
    path = tmp_path / "fold.pt2"
    torch.export.save(program, str(path))
    loaded = torch.export.load(str(path))
    assert aot.kernel_nodes(loaded.graph_module) == {"ring_fold": 1}
    out = loaded.graph_module.graph.find_nodes(op="output")[0].args[0][0]
    assert out.meta["val"].device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["allreduce", "reduce_scatter", "allgather",
                                  "attention", "attention_bwd"])
def test_fake_cuda_world_takes_the_kernel_op(call):
    """A fake CUDA tensor is a CUDA tensor to the wrappers: the trace
    records the kernel op, never the plain version."""
    from mpi_tpu_torch.gpu import attention, ring

    _cuda_build()

    def fn(w, q):
        if call == "allreduce":
            return ring.allreduce_world(w)
        if call == "reduce_scatter":
            return ring.reduce_scatter_world(w.reshape(8, 8, 2))
        if call == "allgather":
            return ring.allgather_world(w)
        if call == "attention":
            return attention.ring_attention_world(q, q, q, causal=True)
        lse = torch.zeros(q.shape[:-1], device=q.device)
        return attention.ring_attention_bwd_world(q, q, q, q, lse, q, causal=True)

    graph = aot.lower(fn, (8, 16), (8, 2, 16, 128), device="cuda")
    want = {"allreduce": {"ring_fold": 1}, "reduce_scatter": {"ring_fold": 1},
            "allgather": {"ring_gather": 1}, "attention": {"attn_fwd": 1},
            "attention_bwd": {"attn_bwd_dq": 1, "attn_bwd_dkv": 1}}[call]
    assert aot.kernel_nodes(graph) == want
