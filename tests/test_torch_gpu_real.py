"""The card's test tier — counterpart of ``tests/test_tpu_real.py``.

Run on a machine with the card (this file imports no JAX; the env var stops
``tests/conftest.py`` importing it)::

    MPI_TPU_TEST_TPU=1 python -m pytest -q -m gpu tests/test_torch_gpu_real.py

Two families, as the reference's:

* **P=1 degenerate semantics on the card** (``gpu`` marker; skip without
  a card): every collective by every algorithm runs on one rank and
  returns the degenerate result, exactly; ``entry.entry()`` runs there,
  also as the evidence writer runs it (``tools/gpu_evidence.py``).
  With them, the host layer's nonblocking engine and fault tolerance on
  the card: an ``iallreduce`` of a side-stream producer's tensor, and a
  local rank killed inside a ring allreduce, then shrink.
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

Beside them (``gpu`` marker), a world that spans two processes on the one
card: the ring kernel across processes over CUDA IPC
(``examples/multihost_world.py``), bitwise equal to one process; and the
attention kernels' forms above d = 256 against their plain versions.
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [384, 512])
def test_wide_head_attention_kernels_match_plain_on_the_card(d, dtype):
    """Head dims above 256 take the forms of csrc/attention_wide.cu and
    attention_bwd_wide.cu (counted in ``WIDE_LAUNCHES``, never in
    ``LAUNCHES``): forward and backward, causal GQA 4/2 over 8 ranks of 48
    rows, against the plain versions on the card with chip_smoke.py's
    gradient rule (float32 ``rtol=1e-4, atol=1e-5``; bfloat16 the same
    plus 2^-7 of |plain|, one bfloat16 rounding on each side)."""
    _wide_head_case(d, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [640, 1152])
def test_wide_head_f32_backward_clusters_match_plain_on_the_card(d):
    """The float32 backward's clusters at d = 640 (5 blocks, 1 pass) and
    1152 (3 blocks, 3 passes each), as the test above."""
    _wide_head_case(d, torch.float32)


@pytest.mark.gpu
def test_wide_head_f32_backward_is_bitwise_deterministic_on_the_card():
    """Two runs of the float32 backward above d = 256 are bitwise equal:
    every block of a cluster sums the partials of S and dP in rank order,
    and no output is summed with atomics."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, do = (torch.randn(P, 4, 112, 640, device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn(P, 2, 112, 640, device="cuda", generator=gen) for _ in range(2))
    out, lse = attention.ring_attention_plain(q, k, v, causal=True, with_lse=True)
    attention.reset_launches()
    first = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=True)
    second = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 2, "bwd_dkv": 2}
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [640, 1152])
def test_wide_head_bf16_backward_clusters_match_plain_on_the_card(d):
    """The bf16 backward's clusters at d = 640 (5 blocks, 1 pass) and 1152
    (3 blocks, 3 passes each), as the first wide-head test."""
    _wide_head_case(d, torch.bfloat16)


@pytest.mark.gpu
def test_wide_head_bf16_backward_is_bitwise_deterministic_on_the_card():
    """Two runs of the bf16 backward above d = 256 are bitwise equal, at
    d = 640 (one pass) and 1152 (three): every block of a cluster sums the
    partials of S and dP in rank order, every output is a running sum in
    its walk's order, and no output is summed with atomics."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(9)
    for d in (640, 1152):
        q, do = (torch.randn(P, 4, 112, d, device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(P, 2, 112, d, device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(2))
        out, lse = attention.ring_attention_plain(q, k, v, causal=True, with_lse=True)
        attention.reset_launches()
        first = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=True)
        second = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=True)
        torch.cuda.synchronize()
        assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 2, "bwd_dkv": 2}
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [640, 1152])
def test_wide_head_forward_clusters_match_plain_on_the_card(d, dtype):
    """The forward's clusters (csrc/attention_wide.cu) at d = 640 (5 blocks,
    1 pass) and 1152 (3 blocks, 3 passes each), in both dtypes, against the
    plain forward, by the rule of the first wide-head test."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(d + 1)
    q = torch.randn(P, 4, 48, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(P, 2, 48, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
    attention.reset_launches()
    out, lse = attention.ring_attention_world(q, k, v, causal=True, with_lse=True)
    want, wlse = attention.ring_attention_plain(q, k, v, causal=True, with_lse=True)
    torch.cuda.synchronize()
    assert attention.WIDE_LAUNCHES == {"fwd": 1, "bwd_dq": 0, "bwd_dkv": 0}
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    rtol = 1e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    torch.testing.assert_close(lse, wlse, rtol=0, atol=1e-5)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_head_forward_is_bitwise_deterministic_on_the_card(dtype):
    """Two launches of the forward above d = 256 are bitwise equal in both
    dtypes: every block of a cluster sums the partials of S in rank order,
    at d = 640 (one pass) and 1152 (three)."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    for d in (640, 1152):
        q = torch.randn(P, 4, 112, d, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(P, 2, 112, d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        first = attention.ring_attention_world(q, k, v, causal=True, with_lse=True)
        second = attention.ring_attention_world(q, k, v, causal=True, with_lse=True)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b), d


def _narrow_bf16_forward(d, causal):
    """The bf16 forward at head dim ``d`` (128 or 256: csrc/attention.cu's
    TMA producer and two consumer warpgroups) twice, and the plain version,
    on GQA 4/2 blocks of Sb = 208 (two 128-row blocks, the second partial; a
    partial 64-row tile)."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(d + causal)
    q = torch.randn(P, 4, 208, d, device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(P, 2, 208, d, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    attention.reset_launches()
    first = attention.ring_attention_world(q, k, v, causal=causal, with_lse=True)
    second = attention.ring_attention_world(q, k, v, causal=causal, with_lse=True)
    ref = attention.ring_attention_plain(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == {"fwd": 2, "bwd_dq": 0, "bwd_dkv": 0}
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    return first, second, ref


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [128, 256])
def test_narrow_bf16_forward_matches_plain_on_the_card(d, causal):
    """out and lse of the bf16 forward at d = 128 and 256 against the plain
    version: out by the rule of the wide-head tests, lse within 1e-5."""
    (out, lse), _, (pout, plse) = _narrow_bf16_forward(d, causal)
    torch.testing.assert_close(out.float(), pout.float(), rtol=2.0 ** -7, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_narrow_bf16_forward_is_bitwise_deterministic_on_the_card(d):
    """Two launches of the bf16 forward at d = 128 and 256 are bitwise
    equal: every block owns its rows and folds its walk in a fixed order."""
    first, second, _ = _narrow_bf16_forward(d, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _narrow_f32_forward(d, causal, hkv):
    """The float32 forward at head dim ``d`` (128 or 256: csrc/attention.cu's
    TMA producer and two consumer warpgroups on TF32 ``wgmma``, O formed
    transposed) twice, and the plain version, on 4/``hkv`` heads (GQA 4/2
    or MQA 4/1) in two ring groups of four, Sb = 208 (at d = 128 a full and
    a partial 128-row block, at d = 256 three 64-row blocks and a partial
    one; a partial last 32-row streamed tile)."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(d + causal + 10 * hkv)
    groups = [[0, 1, 2, 3], [4, 5, 6, 7]]
    q = torch.randn(P, 4, 208, d, device="cuda", generator=gen)
    k, v = (torch.randn(P, hkv, 208, d, device="cuda", generator=gen) for _ in range(2))
    attention.reset_launches()
    first = attention.ring_attention_world(q, k, v, groups, causal=causal, with_lse=True)
    second = attention.ring_attention_world(q, k, v, groups, causal=causal, with_lse=True)
    ref = attention.ring_attention_plain(q, k, v, groups, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == {"fwd": 2, "bwd_dq": 0, "bwd_dkv": 0}
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    return first, second, ref


@pytest.mark.gpu
@pytest.mark.parametrize("hkv", [2, 1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [128, 256])
def test_narrow_f32_forward_matches_plain_on_the_card(d, causal, hkv):
    """out and lse of the float32 forward at d = 128 and 256, GQA and MQA,
    full and causal, against the plain version within the float32
    allowance of ``chip_smoke.check_close`` (1e-5 each)."""
    (out, lse), _, (pout, plse) = _narrow_f32_forward(d, causal, hkv)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, pout, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_narrow_f32_forward_is_bitwise_deterministic_on_the_card(d):
    """Two launches of the float32 forward at d = 128 and 256 are bitwise
    equal: every block owns its rows and folds its walk in a fixed order;
    at d = 256 its warpgroups add the two halves of S in a fixed order."""
    first, second, _ = _narrow_f32_forward(d, True, 1)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _narrow_bf16_backward(d, causal):
    """The bf16 backward at head dim ``d`` (128 or 256: csrc/attention_bwd.cu's
    TMA producer and two consumer warpgroups) twice, and the plain version,
    on GQA 4/2 blocks of Sb = 112 (a partial 128-row block, a partial
    streamed tile)."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(d + causal)
    q, do = (torch.randn(P, 4, 112, d, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(P, 2, 112, d, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    out, lse = attention.ring_attention_plain(q, k, v, causal=causal, with_lse=True)
    attention.reset_launches()
    first = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=causal)
    second = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=causal)
    ref = attention.ring_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 2, "bwd_dkv": 2}
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    return first, second, ref


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [128, 256])
def test_narrow_bf16_backward_matches_plain_on_the_card(d, causal):
    """dq, dk and dv of the bf16 backward at d = 128 and 256 against the
    plain version, by the rule of the wide-head tests."""
    got, _, ref = _narrow_bf16_backward(d, causal)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-4 + 2.0 ** -7, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_narrow_bf16_backward_is_bitwise_deterministic_on_the_card(d):
    """Two launches of the bf16 backward at d = 128 and 256 are bitwise
    equal: every block owns its outputs, sums in its walk's order, and
    the dK/dV block at d = 256 hands P from one warpgroup to the other in
    a fixed order."""
    first, second, _ = _narrow_bf16_backward(d, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _narrow_f32_backward(d, causal):
    """The float32 backward at head dim ``d`` twice, and the plain version,
    on GQA 4/2 blocks of Sb = 112 (a partial 64-row block, a partial
    32-row streamed tile): csrc/attention_bwd.cu's TMA producer and two
    consumer warpgroups on TF32 ``wgmma``, at d = 128 with two stages of
    whole streamed tiles, at d = 256 with the streamed tiles as column-chunk
    units of one ring."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(d + causal + 7)
    q, do = (torch.randn(P, 4, 112, d, device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn(P, 2, 112, d, device="cuda", generator=gen) for _ in range(2))
    out, lse = attention.ring_attention_plain(q, k, v, causal=causal, with_lse=True)
    attention.reset_launches()
    first = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=causal)
    second = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=causal)
    ref = attention.ring_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 2, "bwd_dkv": 2}
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    return first, second, ref


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [128, 256])
def test_narrow_f32_backward_matches_plain_on_the_card(d, causal):
    """dq, dk and dv of the float32 backward at d = 128 and 256 against the
    plain version, within the float32 allowance (rtol 1e-4, atol 1e-5)."""
    got, _, ref = _narrow_f32_backward(d, causal)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_narrow_f32_backward_is_bitwise_deterministic_on_the_card(d):
    """Two launches of the float32 backward at d = 128 and 256 are bitwise
    equal: every block owns its outputs and sums in its walk's order; at
    d = 128 its warpgroups hand P over in a fixed order."""
    first, second, _ = _narrow_f32_backward(d, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_narrow_f32_backward_d256_mqa_ragged_matches_plain_on_the_card(causal):
    """The float32 backward at d = 256 with one K/V head for four query
    heads (MQA: every K/V block walks four GQA heads) in two ring groups of
    four, Sb = 80: a partial 64-row own tile and a last streamed tile of 16
    rows, whose units (forming and output) end past Sb and read zeros there.
    dq, dk and dv against the plain version within the float32 allowance,
    and two launches bitwise equal."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(80 + causal)
    groups = [[0, 1, 2, 3], [4, 5, 6, 7]]
    q, do = (torch.randn(P, 4, 80, 256, device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn(P, 1, 80, 256, device="cuda", generator=gen) for _ in range(2))
    out, lse = attention.ring_attention_plain(q, k, v, groups, causal=causal, with_lse=True)
    attention.reset_launches()
    first = attention.ring_attention_bwd_world(q, k, v, out, lse, do, groups, causal=causal)
    second = attention.ring_attention_bwd_world(q, k, v, out, lse, do, groups, causal=causal)
    ref = attention.ring_attention_bwd_plain(q, k, v, out, lse, do, groups, causal=causal)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 2, "bwd_dkv": 2}
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    for a, b, c in zip(first, second, ref):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_wgmma_reads_a_raw_float32_word_as_truncated_tf32():
    """TF32 ``wgmma`` reads a raw float32 word in shared memory as that
    word with its low 13 mantissa bits cleared (truncation, as
    ``mma.sync``), which the float32 backward above d = 256 relies on for
    the hi of its streamed tiles: the probe multiplies 32 x 8 random words
    by an identity and gets them back truncated, not rounded."""
    _card()
    from mpi_tpu_torch import _build

    gen = torch.Generator(device="cuda").manual_seed(11)
    b = torch.randn(32, 8, device="cuda", generator=gen) * 3
    out = torch.full((64, 32), float("nan"), device="cuda")
    lib = _build.load("attention_bwd_wide")
    assert lib.wgmma_tf32_probe(b.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    trunc = (b.view(torch.int32) & -8192).view(torch.float32)
    nearest = ((b.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    assert not torch.equal(trunc, nearest)
    assert torch.equal(out[:8].T, trunc)
    assert bool((out[8:] == 0).all())


def _wide_head_case(d, dtype):
    """Forward and backward at head dim ``d`` against the plain versions
    on the card, by the rule of the first wide-head test."""
    _card()
    from mpi_tpu_torch.gpu import attention

    gen = torch.Generator(device="cuda").manual_seed(d)
    q, do = (torch.randn(P, 4, 48, d, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(P, 2, 48, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    attention.reset_launches()
    out, lse = attention.ring_attention_world(q, k, v, causal=True, with_lse=True)
    want, wlse = attention.ring_attention_plain(q, k, v, causal=True, with_lse=True)
    got = attention.ring_attention_bwd_world(q, k, v, want, wlse, do, causal=True)
    ref = attention.ring_attention_bwd_plain(q, k, v, want, wlse, do, causal=True)
    torch.cuda.synchronize()
    assert attention.WIDE_LAUNCHES == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    rtol = 1e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    torch.testing.assert_close(lse, wlse, rtol=0, atol=1e-5)
    for a, b in zip((out, *got), (want, *ref)):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-5)


@pytest.mark.gpu
def test_entry_runs_on_the_card():
    """``entry()`` runs on one card, as a test (test_tpu_real.py:91)."""
    _card()
    f, (grid,) = entry.entry(8)
    new, residual = f(grid)
    torch.cuda.synchronize()
    assert new.shape == grid.shape and new.device.type == "cuda"
    assert bool(torch.isfinite(residual))


@pytest.mark.gpu
def test_evidence_entry_and_traces_on_the_card():
    """The evidence writer's card sections (``tools/gpu_evidence.py``):
    ``entry()`` on the card, finite; the traces for the card of export
    (a)-(c) hold K1, K2 and K3 nodes and no plain attention product."""
    _card()
    from mpi_tpu_torch.tools import gpu_evidence

    got = gpu_evidence.entry_on_card()
    assert got["ok"] and got["device"].startswith("cuda") and got["finite"], got
    for name, want in (("pallas_ring_1d", ("ring_fold",)),
                       ("ring_attention", ("attn_fwd",)),
                       ("ring_attention_tiled", ("attn_fwd",)),
                       ("attention_value_and_grad", ("attn_fwd", "attn_bwd_dq",
                                                     "attn_bwd_dkv")),
                       ("attention_value_and_grad_tiled", ("attn_fwd", "attn_bwd_dq",
                                                           "attn_bwd_dkv"))):
        rec = gpu_evidence.trace(name)
        assert rec["ok"], (name, rec)
        assert all(rec["kernel_nodes"].get(k, 0) >= 1 for k in want), (name, rec)
        assert name == "pallas_ring_1d" or rec["plain_products"] == 0, (name, rec)


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


# ---- the host layer's nonblocking engine and fault tolerance on the card -----


@pytest.mark.gpu
@pytest.mark.parametrize("numel", [1 << 10, 1 << 20], ids=["state-machine", "thread"])
def test_iallreduce_after_a_side_stream_producer(numel):
    """A payload produced on a side stream by a long kernel, handed to
    ``iallreduce`` under that stream: the default stream the collective
    works on waits for the producer at issue, and the caller's stream waits
    for the result at ``wait()`` — the sum is right on both the
    state-machine path (4 KiB) and the thread path (4 MiB, above
    ``nbc_sm_max_bytes``)."""
    _card()

    def prog(comm):
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            torch.cuda._sleep(200_000_000)  # a long producer on the side stream
            x = torch.full((numel,), float(comm.rank + 1), device=comm.device)
            req = comm.iallreduce(x)
            out = req.wait()
            got = out.clone()  # consumed on the side stream
        side.synchronize()
        return got

    n = 4
    res = mpi_tpu_torch.run(prog, backend="local", nranks=n, progress="thread")
    want = float(n * (n + 1) // 2)
    for got in res:
        assert got.device.type == "cuda"
        assert torch.equal(got, torch.full_like(got, want))


@pytest.mark.gpu
def test_kill_and_shrink_on_the_card():
    """A local rank killed inside a ring allreduce on the card: every
    survivor raises ProcFailedError naming it (with the collective and a
    segment), shrinks, and the shrunk world's allreduce on the card equals
    the float64 sum of the survivors' inputs, bitwise across ranks."""
    _card()
    from mpi_tpu_torch import mpit
    from mpi_tpu_torch.errors import ProcFailedError
    from mpi_tpu_torch.transport.faulty import FaultyTransport
    from mpi_tpu_torch.transport.local import KILLED

    old = {k: mpit.cvar_read(k) for k in ("fault_detect_timeout_s",
                                          "fault_heartbeat_interval_s")}
    mpit.cvar_write("fault_detect_timeout_s", 1.0)
    mpit.cvar_write("fault_heartbeat_interval_s", 0.05)
    n, dead, numel = 4, 2, 1 << 20

    def inp(r, device):
        g = torch.Generator(device=device).manual_seed(100 + r)
        return torch.randn(numel, generator=g, device=device)

    def prog(comm):
        x = inp(comm.rank, comm.device)
        try:
            comm.allreduce(x, algorithm="ring")
            return "completed"
        except ProcFailedError as e:
            diag = (e.failed, e.collective, e.segment is not None)
        new = comm.shrink()
        return diag, new.size, comm.membership_epoch, new.allreduce(x, algorithm="ring")

    try:
        res = mpi_tpu_torch.run(
            prog, backend="local", nranks=n, fault_tolerance=True,
            progress="thread",
            transport_wrapper=lambda t: (FaultyTransport(t, kill_after_n=3)
                                         if t.world_rank == dead else t))
    finally:
        for k, v in old.items():
            mpit.cvar_write(k, v)
    assert res[dead] is KILLED
    survivors = [r for r in range(n) if r != dead]
    want = sum(inp(r, "cuda").double() for r in survivors)
    outs = []
    for r in survivors:
        diag, size, epoch, out = res[r]
        assert diag == ((dead,), "allreduce", True) and size == n - 1 and epoch == 1
        assert out.device.type == "cuda"
        assert torch.allclose(out.double(), want, rtol=1e-5, atol=1e-5)
        outs.append(out)
    assert all(torch.equal(o, outs[0]) for o in outs)


# ---- the runtime verifier on the card -----------------------------------------


def _verified(prog, n=2, **kw):
    """``prog`` on ``n`` verified local ranks on the card, at a 1 s stall
    bound; returns (results, finalize report, verify_* pvar deltas)."""
    import gc

    from mpi_tpu_torch import mpit, verify

    _card()
    old = mpit.cvar_read("verify_stall_timeout_s")
    mpit.cvar_write("verify_stall_timeout_s", 1.0)
    ses = mpit.session_create()
    ses.reset_all()
    verify.finalize_report()
    try:
        res = mpi_tpu_torch.run(prog, backend="local", nranks=n, verify=True, **kw)
    finally:
        mpit.cvar_write("verify_stall_timeout_s", old)
    report = verify.finalize_report()
    gc.collect()
    report += verify.take_report()
    pvars = {p: ses.read(p) for p in mpit.pvar_list() if p.startswith("verify_")}
    return res, report, pvars


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [True, False], ids=["overlapping", "disjoint"])
def test_irecv_buf_slices_of_one_cuda_tensor(overlap):
    """Two pending ``irecv(buf=)`` into slices of one CUDA tensor: one
    overlap report line per rank where the slices overlap, none where they
    are disjoint; the receives land either way."""
    def prog(comm):
        buf = torch.zeros(8, device=comm.device)
        peer = 1 - comm.rank
        r1 = comm.irecv(source=peer, tag=4, buf=buf[0:4])
        r2 = comm.irecv(source=peer, tag=4, buf=buf[2:6] if overlap else buf[4:8])
        comm.send(torch.arange(4.0, device=comm.device), peer, tag=4)
        comm.send(torch.arange(4.0, device=comm.device) + 4, peer, tag=4)
        r1.wait()
        r2.wait()
        return buf.cpu()

    res, report, pvars = _verified(prog)
    lines = [ln for ln in report if "overlapping live buffers" in ln]
    assert len(lines) == (2 if overlap else 0), report
    assert all("cuda" in ln for ln in lines)
    assert pvars["verify_buffer_overlaps"] == len(lines)
    if not overlap:
        assert all(torch.equal(b, torch.arange(8.0)) for b in res)


@pytest.mark.gpu
def test_cpu_and_cuda_ranges_never_overlap():
    """Ranges are keyed by device: a CPU tensor and a CUDA tensor are never
    reported as overlapping, even where their addresses would meet."""
    from types import SimpleNamespace

    from mpi_tpu_torch.verify.state import MemoryBoard, WorldVerify, buffer_span

    _card()
    cpu = torch.zeros(1 << 20)
    cuda = torch.zeros(1 << 20, device="cuda")
    assert buffer_span(cpu)[0] == "cpu" and buffer_span(cuda)[0] == "cuda:0"
    t = SimpleNamespace(world_rank=0, world_size=1)
    w = WorldVerify(t, MemoryBoard(1), 1.0)
    w._bufs[0] = ("cpu",) + buffer_span(cuda)[1:] + (True, "a cpu range at the "
                                                    "card tensor's addresses")
    from mpi_tpu_torch import mpit

    base = mpit.pvar_read("verify_buffer_overlaps")
    w.buffer_release(w.buffer_live(cuda, "the card tensor", writes=True))
    assert mpit.pvar_read("verify_buffer_overlaps") == base
    w.buffer_live(cuda[8:], "a view of it", writes=True)
    w.buffer_live(cuda[:16], "another view", writes=True)
    assert mpit.pvar_read("verify_buffer_overlaps") == base + 1


@pytest.mark.gpu
def test_persistent_fence_on_a_cuda_round_result():
    """The double-buffer fence on the card: holding round 0's result (a
    CUDA view of the working buffer) across two later starts raises
    BufferPinnedError; the result is still intact."""
    from mpi_tpu_torch.errors import BufferPinnedError

    def prog(comm):
        h = comm.allreduce_init(torch.ones(1 << 12, device=comm.device))
        r0 = h.start().wait()
        assert r0.device.type == "cuda"
        h.start().wait()
        try:
            h.start().wait()
        except BufferPinnedError as e:
            return "fenced", "copy it first" in str(e), float(r0[0])
        return "missed", False, float(r0[0])

    res, _, _ = _verified(prog, progress="thread")
    assert res == [("fenced", True, 2.0)] * 2


@pytest.mark.gpu
def test_long_products_are_no_deadlock_on_local_ranks():
    """Rank 0 runs more than 3 x verify_stall_timeout_s of bfloat16
    products (its host thread waiting on the card) before a ring
    allreduce its peers are already blocked in: no DeadlockError, the
    right sum, and no verify finding."""
    from mpi_tpu_torch.examples.host_verify import busy_products

    n, numel = 4, 1 << 22

    def prog(comm):
        x = torch.full((numel,), float(comm.rank + 1), device=comm.device)
        spent = busy_products(comm.device, 3.5)[1] if comm.rank == 0 else 0.0
        return comm.allreduce(x, algorithm="ring"), spent

    res, report, pvars = _verified(prog, n=n)
    assert res[0][1] > 3.0
    want = float(n * (n + 1) // 2)
    for out, _ in res:
        assert out.device.type == "cuda" and torch.equal(out, torch.full_like(out, want))
    assert report == [] and not any(v for k, v in pvars.items()
                                    if k != "verify_clock_bytes")


@pytest.mark.gpu
def test_verify_pickles_no_payload_on_a_socket_world(tmp_path):
    """Two socket ranks on the card under ``--verify``: a CUDA payload's
    ring allreduce pickles only the signature tuples (as many bytes as a
    1 KiB ring's, up to the shape's digits), and the clean ring, the race
    and the deadlock of ``examples/host_verify.py`` behave on the card."""
    import json
    import os
    import subprocess
    import sys

    _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", "3", "--verify",
         "--timeout", "240", os.path.join(root, "mpi_tpu_torch", "examples",
                                          "host_verify.py"),
         "--out", str(out), "--mib", "64", "--small-mib", "4"],
        capture_output=True, text=True, cwd=root, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for r in range(3):
        rec = json.load(open(out / f"rank{r}.json"))
        assert rec["device"].startswith("cuda")
        wire, small = rec["clean_ring"]["wire"], rec["clean_ring"]["wire_1KiB"]
        assert abs(wire["bytes_pickled_sent"] - small["bytes_pickled_sent"]) <= 64
        assert wire["bytes_raw_sent"] >= 2 * (3 - 1) / 3 * (64 << 20) * 0.99


# ---- the same-host data plane on the card ------------------------------------


@pytest.mark.gpu
def test_int8_encode_rounding_ties_on_the_card():
    """The int8 wire encode on the card equals the CPU's byte for byte,
    with every entry but the max-abs on a rounding tie (x / scale = k +
    0.5 exactly in float32; the divisor is a float32 tensor on the card,
    so the card divides as numpy does).  The scale, 3.3, has an inexact
    reciprocal, so the same encode dividing by a Python float (a CUDA
    multiply by the reciprocal) differs at some of these ties."""
    _card()
    from mpi_tpu_torch import compress

    amax = torch.tensor([127 * 3.3], dtype=torch.float32)
    scale = torch.tensor([float(amax) / 127.0], dtype=torch.float32)
    k = torch.randint(-126, 126, (1 << 16,),
                      generator=torch.Generator().manual_seed(0)) + 0.5
    x = k * scale
    on_tie = x / scale == k
    x = torch.cat([x[on_tie], amax])
    assert on_tie.sum() > (1 << 15)
    for data in (x, torch.randn(1 << 16) * 3.0):
        cpu = compress.INT8.encode_segs(data)
        card = compress.INT8.encode_segs(data.cuda())
        for a, b in zip(card, cpu):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))
    q = compress.INT8.encode_segs(x)[1]
    wrong = torch.round(x.cuda() / float(scale)).clamp_(-127, 127).to(torch.int8)
    assert (wrong.cpu() != q).any()


@pytest.mark.gpu
def test_arena_allreduce_of_cuda_tensors_on_two_shm_ranks():
    """The collective arena with tensors on the card: 2 shm rank threads,
    flat and block-in-place allreduce, served by the arena (hits counted),
    results on the card and bitwise equal to the same world on the CPU."""
    _card()
    from mpi_tpu_torch import mpit
    from mpi_tpu_torch.transport.shm import run_shm

    xs = [torch.randn(1 << 18, generator=torch.Generator().manual_seed(r))
          for r in range(2)]

    def prog(comm, dev):
        x = xs[comm.rank].to(dev)
        return [comm.allreduce(x[:256], algorithm="sm"),
                comm.allreduce(x, algorithm="sm")]

    h0 = mpit.pvar_read("coll_sm_hits")
    card = run_shm(lambda c: prog(c, "cuda"), 2)
    assert mpit.pvar_read("coll_sm_hits") - h0 == 4
    cpu = run_shm(lambda c: prog(c, "cpu"), 2, device="cpu")
    for got, want in zip(card, cpu):
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_process_checkpoint_restores_onto_the_card(tmp_path):
    """``checkpoint.save`` / ``load`` on 2 local ranks with tensors on the
    card: the state comes back on ``cuda:``, bitwise, beside its numpy
    and Python leaves; the same files load on a CPU world onto the CPU."""
    _card()
    import numpy as np

    from mpi_tpu_torch import checkpoint

    path = str(tmp_path / "ck")

    def state(rank, dev):
        g = torch.Generator().manual_seed(rank)
        return {"w": torch.randn(64, 33, generator=g).to(dev),
                "h": torch.randn(7, generator=g).to(torch.bfloat16).to(dev),
                "np": np.arange(3) + rank, "step": rank}

    def save_load(c):
        checkpoint.save(path, state(c.rank, c.device), c)
        return checkpoint.load(path, c)

    card = mpi_tpu_torch.run(save_load, backend="local", nranks=2)
    cpu = mpi_tpu_torch.run(lambda c: checkpoint.load(path, c),
                            backend="local", nranks=2, device="cpu")
    for r in range(2):
        want = state(r, "cpu")
        for got, dev in ((card[r], "cuda"), (cpu[r], "cpu")):
            for k in ("w", "h"):
                assert got[k].device.type == dev
                assert torch.equal(got[k].cpu(), want[k])
            assert (got["np"] == want["np"]).all() and got["step"] == r


@pytest.mark.gpu
def test_pready_snapshot_survives_a_refill_on_the_card():
    """A card tensor's partition is snapshotted by ``pready`` (a clone on
    the default stream): a producer working on a side stream, which
    refills the partition right after readying it, never reaches the
    receiver with the refill (``pready`` made the default stream wait on
    the side stream, and the side stream wait on the clone)."""
    _card()
    from mpi_tpu_torch import mpi4

    parts, numel = 8, 1 << 20

    def prog(c):
        if c.rank == 0:
            buf = torch.arange(parts * numel, dtype=torch.float32,
                               device=c.device).reshape(parts, numel)
            req = mpi4.psend_init(c, buf, parts, dest=1, tag=2).start()
            side = torch.cuda.Stream(c.device)
            side.wait_stream(torch.cuda.current_stream(c.device))
            with torch.cuda.stream(side):
                for i in range(parts):
                    buf[i].mul_(2.0).div_(2.0)  # the producer's last write
                    req.pready(i)
                    buf[i].fill_(-1.0)  # the refill, right after
            req.wait()
            torch.cuda.synchronize(c.device)
            return None
        got = mpi4.precv_init(c, parts, source=0, tag=2).start().wait()
        assert all(t.device.type == "cuda" for t in got)
        return torch.stack(got).cpu()

    res = mpi_tpu_torch.run(prog, backend="local", nranks=2)
    want = torch.arange(parts * numel, dtype=torch.float32).reshape(parts, numel)
    assert torch.equal(res[1], want)


# ---- receives steered into user buffers, MPI-IO, on the card ---------------


def _socket_world(fn, nranks):
    """``fn(comm)`` on ``nranks`` socket transports in threads of this
    process, on the card."""
    import tempfile
    import threading

    from mpi_tpu_torch.communicator import P2PCommunicator
    from mpi_tpu_torch.transport.socket import SocketTransport

    rdv = tempfile.mkdtemp(prefix="mtt_gpu_sock_")
    ts = [SocketTransport(r, nranks, rdv, device="cuda") for r in range(nranks)]
    out, errs = [None] * nranks, []

    def body(r):
        try:
            torch.cuda.set_device(0)
            out[r] = fn(P2PCommunicator(ts[r], range(nranks)))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for t in ts:
        t.close()
    if errs:
        raise errs[0]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["socket", "shm"])
def test_steered_receive_into_a_card_tensor(kind):
    """``irecv(buf=<card tensor>)`` posted before the frame: the reader
    lands the body in pinned staging and copies it into the tensor itself
    (same ``data_ptr``), counted as one in-place landing, no fallback."""
    _card()
    from mpi_tpu_torch import mpit
    from mpi_tpu_torch.transport.shm import run_shm

    numel = 1 << 22
    src = torch.randn(numel, generator=torch.Generator().manual_seed(3))

    def prog(comm):
        if comm.rank == 0:
            comm.recv(1, 99)
            comm.send(src.to(comm.device), dest=1, tag=21)
            return None
        buf = torch.zeros(numel, device=comm.device)
        ptr = buf.data_ptr()
        req = comm.irecv(0, 21, buf=buf)
        comm.send(b"posted", dest=0, tag=99)
        got = req.wait()
        assert got is buf and buf.data_ptr() == ptr
        return buf.cpu()

    base = [mpit.pvar_read(n) for n in ("recv_user_inplace",
                                        "recv_user_fallbacks")]
    res = (_socket_world(prog, 2) if kind == "socket" else run_shm(prog, 2))
    assert torch.equal(res[1], src)
    assert [mpit.pvar_read(n) - b for n, b in zip(
        ("recv_user_inplace", "recv_user_fallbacks"), base)] == [1, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("datarep", ["native", "external32"])
def test_file_round_trip_of_a_card_tensor(tmp_path, datarep):
    """A card tensor written through a strided view and read back: the
    read is a tensor on the card, bitwise; the bytes on disk are the
    host's numpy bytes in the datarep's byte order."""
    _card()
    import numpy as np

    from mpi_tpu_torch import datatypes as dt
    from mpi_tpu_torch import io as mio

    path = str(tmp_path / "card.bin")
    x = torch.randn(1 << 16, generator=torch.Generator().manual_seed(5))
    comm = mpi_tpu_torch.comm_self(device="cuda")
    with mio.file_open(comm, path, mio.MODE_CREATE | mio.MODE_RDWR) as f:
        f.set_view(etype=torch.float32,
                   filetype=dt.type_vector(1 << 16, 1, 2, np.float32),
                   datarep=datarep)
        f.write_at_all(0, x.cuda())
        back = f.read_at_all(0, 1 << 16)
    assert back.device.type == "cuda" and torch.equal(back.cpu(), x)
    disk = np.fromfile(path, dtype=">f4" if datarep == "external32" else "<f4")
    assert np.array_equal(disk[::2], x.numpy())



@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["socket", "shm"])
def test_serve_leases_card_workers(monkeypatch, backend):
    """A resident world server's workers on the card (no ``MPI_TPU_DEVICE``):
    ``examples/host_serve.py``'s checked 4 MiB-a-rank allreduce on every
    worker's card, and the card tensor lease rank 0 returns arrives on the
    client's CPU."""
    _card()
    from mpi_tpu_torch import connect, serve
    from mpi_tpu_torch.examples.host_serve import job_allreduce_checked

    monkeypatch.delenv("MPI_TPU_DEVICE", raising=False)
    with serve.WorldServer(pool_size=2, backend=backend) as srv:
        client = connect(srv)
        try:
            res = client.run(job_allreduce_checked, 4, nranks=2, timeout=120.0)
            assert all(res["ok"]) and res["want"] == 3.0, res
            assert [d.split(":")[0] for d in res["devices"]] == ["cuda"] * 2
            assert res["head"].device.type == "cpu"
            assert res["head"].tolist() == [3.0] * 4
        finally:
            client.close()


@pytest.mark.gpu
def test_federation_takeover_keeps_orphans_on_the_card(monkeypatch, tmp_path):
    """A two-server file namespace with every worker on the card
    (``examples/host_federation.py``): a checked lease through the
    namespace, the leader SIGKILLed, the same client leasing on the
    survivor, and a lease on the adopted pool runs on the orphans, which
    kept their pids and their card."""
    _card()
    import json

    from mpi_tpu_torch.examples import host_federation

    monkeypatch.delenv("MPI_TPU_DEVICE", raising=False)
    out = tmp_path / "fed.json"
    assert host_federation.main([
        "--ns", str(tmp_path / "ns"), "--servers", "2", "--pool-size", "2",
        "--mib", "4", "--require", "cuda", "--kill-leader",
        "--out", str(out)]) == 0
    kill = json.loads(out.read_text())["kill"]
    assert (kill["pools_adopted"], kill["orphans_reregistered"]) == (1, 2)
    assert kill["orphans_after"] and all(
        d.startswith("cuda") for _, d in kill["orphans_after"])
    assert {tuple(p) for p in kill["orphans_after"]} <= {
        tuple(p) for p in kill["orphans_before"]}
    assert all(kill["adopted_lease"]["ok"])


@pytest.mark.gpu
def test_k1_across_two_processes_on_one_card(monkeypatch, tmp_path):
    """Two simulated hosts of two ranks each on ``cuda:0``
    (``examples/multihost_world.py``): the ring kernel reads the other
    process's rows over CUDA IPC; every process's rows equal, bitwise, the
    one-process kernel over all four ranks and the plain version, every
    peer-pointer mode launched, and no IPC mapping stays open."""
    _card()
    import json
    import os

    from mpi_tpu_torch.gpu import multihost

    monkeypatch.delenv("MPI_TPU_DEVICE", raising=False)
    rdv = tmp_path / "rdv"
    rdv.mkdir()
    script = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "mpi_tpu_torch", "examples", "multihost_world.py")
    assert multihost.launch_sim_hosts(
        2, [script, "--out", str(tmp_path / "out"), "--mib", "1", "--half-mib",
            "0.5", "--rdv", str(rdv), "--reps", "1"],
        devices_per_host=2, timeout=300) == 0
    for q in range(2):
        rec = json.loads((tmp_path / "out" / f"proc{q}.json").read_text())
        assert rec["device"].startswith("cuda") and rec["first"] == 2 * q
        assert all(rec["launches"].values()), rec["launches"]
        assert all(k["max_abs_err"] == 0.0 for k in rec["k1"].values())
        assert rec["node_key"] == [0, 0, 1, 1]
        assert rec["open_mappings_after"] == 0
