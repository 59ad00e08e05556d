"""Ahead-of-time tracing and export of the multi-parallel step
(``entry.lower_multichip`` / ``export_multichip``, ``mpi_tpu_torch.aot``)
on the CPU.

For ``device="cpu"`` the traced graph and the exported program, after a
``torch.export.save`` / ``load`` round trip, run bitwise equal to the eager
step (the same aten ops in the same order), and within
``tests/test_torch_dryrun.py``'s tolerances (rtol 1e-5, atol 1e-6) of
``__graft_entry__._build_step``.  For ``device="cuda"`` the traces run on
fake CUDA tensors, which need a PyTorch built with CUDA (and the step's
backward the card): those tests live in ``tests/test_torch_gpu_real.py``,
which the card's machine runs without JAX.  Here a PyTorch built for the
CPU only refuses such a trace with a diagnosis, and the kernel ops' fake
implementations, which such a trace records, are checked on meta tensors.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

import __graft_entry__ as ge
from mpi_tpu_torch import TorchCommunicator, aot, entry, resolve_device
from mpi_tpu_torch.entry import _build_step, _shapes
from mpi_tpu_torch.gpu import attention, ring
from mpi_tpu_torch.gpu.attention import ring_attention

RTOL, ATOL = 1e-5, 1e-6
ROWS = [[0, 1, 2, 3], [4, 5, 6, 7]]
DP_GROUPS = [[0, 4], [1, 5], [2, 6], [3, 7]]


def _inputs(seed=0):
    """The inputs of tests/test_dryrun.py:47-50."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * (0.1 if i >= 2 else 1)).astype(np.float32)
            for i, s in enumerate(_shapes(2, 4))]


def _reference(alg, args):
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("dp", "mp"))
    step, in_specs, out_specs = ge._build_step(mesh, 2, 4, dp_algorithm=alg)
    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return [np.asarray(o) for o in f(*[jnp.asarray(a) for a in args])]


@pytest.mark.parametrize("alg", ["ring", "pallas_ring"])
def test_lowered_step_runs_bitwise_equal_to_the_eager_step(alg):
    args = [torch.from_numpy(a) for a in _inputs()]
    eager = _build_step(2, 4, alg)(*args)
    graph = entry.lower_multichip(8, alg, device="cpu")
    got = graph(*args)
    for name, g, e, w in zip(("w1", "w2", "loss", "aux"), got, eager,
                             _reference(alg, _inputs())):
        assert torch.equal(g, e), name
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
    assert aot.kernel_nodes(graph) == {}  # the CPU traces the plain versions


@pytest.mark.parametrize("alg", ["ring", "pallas_ring"])
def test_exported_step_round_trips_through_save_and_load(tmp_path, alg):
    program = entry.export_multichip(8, alg, device="cpu")
    path = tmp_path / "step.pt2"
    torch.export.save(program, str(path))
    loaded = torch.export.load(str(path)).module()
    args = [torch.from_numpy(a) for a in _inputs(seed=2)]
    eager = _build_step(2, 4, alg)(*args)
    for name, g, e in zip(("w1", "w2", "loss", "aux"), loaded(*args), eager):
        assert torch.equal(g, e), name
    # the program takes other values of the same shapes, as an AOT artifact
    args = [torch.from_numpy(a) for a in _inputs(seed=3)]
    for g, e in zip(loaded(*args), _build_step(2, 4, alg)(*args)):
        assert torch.equal(g, e)


def test_lower_takes_other_shapes():
    shapes = ((8, 16), (8, 16), (16, 32), (32, 16))
    graph = entry.lower_multichip(8, device="cpu", shapes=shapes)
    rng = np.random.RandomState(4)
    args = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]
    for g, e in zip(graph(*args), _build_step(2, 4)(*args)):
        assert g.shape == e.shape and torch.equal(g, e)


def test_a_cuda_trace_needs_a_cuda_build():
    """A PyTorch built for the CPU only refuses a trace for the card with a
    diagnosis (its fake CUDA tensors have no device guard)."""
    if torch.version.cuda is not None:
        pytest.skip("this PyTorch is built with CUDA")
    for lower in (lambda: entry.lower_multichip(8, "pallas_ring", device="cuda"),
                  lambda: aot.lower(lambda t: t + 1, (4,), device="cuda")):
        with pytest.raises(RuntimeError, match="PyTorch built with CUDA"):
            lower()


def _step_kernels(comm, g, x):
    """The step's two kernel calls as it spells them: the dp sync of a
    gradient by pallas_ring and the causal ring attention over mp (traced
    for the card in ``tests/test_torch_gpu_real.py``)."""
    comm_mp = TorchCommunicator.from_groups(ROWS)
    comm_dp = TorchCommunicator.from_groups(DP_GROUPS)
    synced = comm_dp.allreduce(g, algorithm="pallas_ring")
    att_in = torch.tanh(torch.mean(x)).expand(8, 128)
    return synced, ring_attention(att_in, att_in, att_in, comm_mp, causal=True)


def test_the_same_calls_traced_for_the_cpu_take_the_plain_versions():
    graph = aot.lower_spmd(_step_kernels, (8, 16), (4, 8), nranks=8, device="cpu")
    assert aot.kernel_nodes(graph) == {}


def test_a_run_never_takes_the_trace_target():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="not available"):
        resolve_device("cuda")
    assert resolve_device("cuda", trace=True) == torch.device("cuda", 0)
    assert resolve_device(None, trace=True) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)


CALLS = ["allreduce", "reduce_scatter", "allgather", "attention", "attention_bwd"]


@pytest.mark.parametrize("call", CALLS)
def test_kernel_ops_state_their_outputs_on_meta(call):
    """Each kernel op's fake implementation, which a trace for the card
    records, states the outputs' shapes, dtypes and device, and builds and
    launches nothing."""
    ops = torch.ops.mpi_tpu_torch
    meta = dict(device="meta")
    w = torch.empty(8, 4, 16, **meta)
    q4 = torch.empty(8, 2, 16, 128, dtype=torch.bfloat16, **meta)
    lse = torch.empty(8, 2, 16, **meta)
    flat = [r for g in DP_GROUPS for r in g]
    before = dict(ring.LAUNCHES), dict(attention.LAUNCHES)
    if call in ("allreduce", "reduce_scatter"):
        scatter = call == "reduce_scatter"
        outs = (ops.ring_fold(w, flat, 2, "sum", 8, True, scatter),)
        shapes = [(8, 16) if scatter else (8, 4, 16)]
    elif call == "allgather":
        outs, shapes = (ops.ring_gather(w, flat, 2),), [(8, 2, 4, 16)]
    elif call == "attention":
        outs = ops.attn_fwd(q4, q4, q4, list(range(8)), 8, 0.1, True)
        shapes = [tuple(q4.shape), (8, 2, 16)]
    else:
        outs = (ops.attn_bwd_dq(q4, q4, q4, q4, lse, lse, list(range(8)), 8, 0.1, True),
                *ops.attn_bwd_dkv(q4, q4, q4, q4, lse, lse, list(range(8)), 8, 0.1, True))
        shapes = [tuple(q4.shape)] * 3
    assert [tuple(o.shape) for o in outs] == shapes
    for o in outs:
        assert o.device.type == "meta"
        assert o.dtype == (torch.float32 if o.dim() == 3 and call == "attention"
                           else (w if call in ("allreduce", "reduce_scatter",
                                               "allgather") else q4).dtype)
    assert (dict(ring.LAUNCHES), dict(attention.LAUNCHES)) == before
