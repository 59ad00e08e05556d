"""The attention kernels' operand splits (mpi_tpu_torch/csrc/attention.cu,
attention_bwd.cu and hopper.cuh), emulated with torch ops on the CPU and
held against the plain versions ``ring_attention_plain`` and
``ring_attention_bwd_plain`` under chip_smoke.py's ``check_close`` rule, and
at one size against the reference (Pallas interpret mode): the forward's
output, and ``jax.grad`` through the fused backward.

What the kernels multiply:

* bf16 inputs: Q K^T and dO V^T as bf16 x bf16 (exact in float32); the
  float32 operands P and dS enter P V, P^T dO, dS^T Q and dS K as
  hi = bf16(x) plus lo = bf16(x - hi), two products each.
* float32 inputs: every operand of every product as TF32 hi plus lo,
  hi = x with its low 13 mantissa bits cleared, lo = x - hi, which the
  tensor core reads with its low 13 bits cleared as well; a product is
  a_lo b_hi + a_hi b_hi + a_hi b_lo.

The forward folds the K/V block in tiles of 64 (bf16) or 32 (float32)
rows with the online rescale, in log2 units (scores times scale log2(e),
exp2, lse = m ln 2 + log l).  The emulation differs from the kernels only
in the order of the float32 sums and in exp2 (the card's ex2.approx is
within two ulps), so these tests are the evidence, before the card sees
the kernels, that the split depth fits the tolerance.  In the backward a
single bf16 P and dS, or a single TF32 product, does not fit it; in the
forward, whose only float32 operand is P, neither does.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from mpi_tpu_torch.gpu import attention
from test_torch_attention import jax_forward
from test_torch_attention_grad import TOL, inputs, jax_grads

MASK13 = -8192  # 0xFFFFE000 as int32: clears the low 13 mantissa bits


def tf32_trunc(x):
    return (x.view(torch.int32) & MASK13).view(torch.float32)


def tf32_rna(x):
    """cvt.rna.tf32.f32: nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & MASK13).view(torch.float32)


def split_tf32(x):
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def split_bf16(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (al @ bh + ah @ bh) + ah @ bl


def mm_1xtf32(a, b):
    return tf32_trunc(a) @ tf32_trunc(b)


def mm_split_bf16(a, b):
    """a float32, split hi/lo; b exact in bf16."""
    ah, al = split_bf16(a)
    return ah @ b + al @ b


def mm_single_bf16(a, b):
    return a.to(torch.bfloat16).float() @ b


# the products each input dtype's kernels use: (recompute, with P or dS)
KERNEL_PRODUCTS = {torch.float32: (mm_3xtf32, mm_3xtf32),
                   torch.bfloat16: (torch.matmul, mm_split_bf16)}


def emulated_bwd(q, k, v, out, lse, dout, groups=None, *, causal=False,
                 products=None, cast=True):
    """The backward kernels' arithmetic on the CPU, in the plain version's
    ring schedule (shapes as ``ring_attention_bwd_plain``, multi-head)."""
    recompute, with_p = products or KERNEL_PRODUCTS[q.dtype]
    nranks, hq, sb, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    heads = torch.arange(hq) // rep
    scale = 1.0 / np.sqrt(d)
    gl = groups or [list(range(nranks))]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dof * out.float()).sum(-1, keepdim=True)
    lse4 = lse.reshape(nranks, hq, sb, 1)
    mask = torch.arange(sb)[None, :] <= torch.arange(sb)[:, None]
    dq = torch.zeros(qf.shape)
    dk = torch.zeros(kf.shape)
    dv = torch.zeros(kf.shape)
    for grp in gl:
        g = len(grp)
        for a in range(g):
            for r, w in enumerate(grp):
                j = (r - a) % g
                if causal and j > r:
                    continue
                kb, vb = kf[grp[j]][heads], vf[grp[j]][heads]
                s = recompute(qf[w], kb.transpose(-1, -2)) * scale
                p = torch.exp(s - lse4[w])
                if causal and j == r:
                    p = torch.where(mask, p, torch.zeros_like(p))
                dp = recompute(dof[w], vb.transpose(-1, -2))
                ds = p * (dp - delta[w]) * scale
                dq[w] += with_p(ds, kb)
                dk_c = with_p(ds.transpose(-1, -2), qf[w])
                dv_c = with_p(p.transpose(-1, -2), dof[w])
                for h in range(hq):
                    dk[grp[j], h // rep] += dk_c[h]
                    dv[grp[j], h // rep] += dv_c[h]
    if cast:
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


# the forward's products: (Q K^T, P V) and its k-tile rows, by input dtype
FWD_PRODUCTS = {torch.float32: (mm_3xtf32, mm_3xtf32, 32),
                torch.bfloat16: (torch.matmul, mm_split_bf16, 64)}
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def emulated_fwd(q, k, v, groups=None, *, causal=False, products=None, cast=True):
    """The forward kernel's arithmetic on the CPU (shapes as
    ``ring_attention_plain``, multi-head): each arrival's K/V block in
    tiles of 64 (bf16) or 32 (float32) rows, each tile folded into the
    float32 state (m in log2 units, l, o); returns (out, lse)."""
    qk, pv, tile = products or FWD_PRODUCTS[q.dtype]
    nranks, hq, sb, d = q.shape
    rep = hq // k.shape[1]
    heads = torch.arange(hq) // rep
    scale2 = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    gl = groups or [list(range(nranks))]
    qf, kf, vf = (t.float() for t in (q, k, v))
    mask = torch.arange(sb)[None, :] <= torch.arange(sb)[:, None]
    out = torch.empty(qf.shape)
    lse = torch.empty((nranks, hq, sb))
    for grp in gl:
        g = len(grp)
        for r, w in enumerate(grp):
            m = torch.full((hq, sb, 1), -np.inf)
            l = torch.zeros((hq, sb, 1))
            o = torch.zeros((hq, sb, d))
            for a in range(g):
                j = (r - a) % g
                if causal and j > r:
                    continue
                kb, vb = kf[grp[j]][heads], vf[grp[j]][heads]
                for k0 in range(0, sb, tile):
                    cols = slice(k0, min(sb, k0 + tile))
                    x = qk(qf[w], kb[:, cols].transpose(-1, -2)) * scale2
                    if causal and j == r:
                        x = torch.where(mask[:, cols], x, torch.full_like(x, -1e30))
                    m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    o = o * alpha + pv(p, vb[:, cols])
                    m = m_new
            out[w] = o / l
            lse[w] = (m * LN2 + torch.log(l))[..., 0]
    return (out.to(q.dtype) if cast else out), lse


def world(P, hq, hkv, sb, d, dtype, causal, groups=None, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(P, h, sb, d).astype(np.float32)).to(dtype)
                   for h in (hq, hkv, hkv, hq))
    out, lse = attention.ring_attention_plain(q, k, v, groups, causal=causal,
                                              with_lse=True)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_split_backward_within_check_close_of_plain(dtype, causal, hq, hkv):
    """{f32, bf16} x {full, causal} x {MHA, GQA, MQA}, two groups of 2 on
    a world of 4: the kernels' splits against the plain backward."""
    groups = [[0, 1], [2, 3]] if hkv == 2 else None
    ops = world(4, hq, hkv, 16, 128, dtype, causal, groups, seed=hq + 10 * hkv)
    got = emulated_bwd(*ops, groups, causal=causal)
    want = attention.ring_attention_bwd_plain(*ops, groups, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        chip_smoke.check_close(torch, f"split {name}", a, b, dtype)


@pytest.mark.parametrize("dtype,products", [
    (torch.bfloat16, (torch.matmul, mm_single_bf16)),
    (torch.float32, (mm_1xtf32, mm_1xtf32)),
])
def test_one_term_leaves_the_float32_allowance(dtype, products):
    """Before the final rounding the kernels' sums are float32: with the
    hi/lo splits they stay within the float32 allowance of the plain
    version; a single bf16 P and dS, or a single TF32 product, does not."""
    ops = world(4, 4, 2, 16, 128, dtype, True, seed=5)
    want = attention.ring_attention_bwd_plain(
        *(t.float() for t in ops), causal=True)
    split = emulated_bwd(*ops, causal=True, cast=False)
    one = emulated_bwd(*ops, causal=True, products=products, cast=False)
    worst = 0.0
    for name, a, b, c in zip(("dq", "dk", "dv"), split, one, want):
        chip_smoke.check_close(torch, f"split {name}", a, c, torch.float32)
        allow = 1e-5 + 1e-4 * c.abs()
        worst = max(worst, float(((b - c).abs() / allow).max()))
    assert worst > 1.0


def test_split_backward_matches_jax_grad_of_the_reference():
    """At one size (tests/test_torch_attention_grad.py's GQA case, causal):
    the float32 split against ``jax.grad`` through the reference's fused
    backward, with that file's tolerance."""
    P, hq, hkv, sb = 4, 4, 2, 8
    q, k, v, ct = inputs(P, hq, hkv, sb, 128, seed=P + 10 * hq + hkv)
    want = jax_grads(q, k, v, ct, "f32", True)
    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = attention.ring_attention_plain(tq, tk, tv, causal=True, with_lse=True)
    got = emulated_bwd(tq, tk, tv, out, lse, tct, causal=True)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL["f32"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_split_forward_within_check_close_of_plain(dtype, causal, hq, hkv):
    """{f32, bf16} x {full, causal} x {MHA, GQA, MQA}, two groups of 2 on
    a world of 4 for GQA: the forward's tiles and splits against the plain
    forward, out and lse.  Sb = 80 (bf16) and 48 (float32) end in a partial
    k-tile."""
    groups = [[0, 1], [2, 3]] if hkv == 2 else None
    sb = 80 if dtype == torch.bfloat16 else 48
    q, k, v, _, _, _ = world(4, hq, hkv, sb, 128, dtype, causal, groups, seed=hq + 10 * hkv)
    out, lse = emulated_fwd(q, k, v, groups, causal=causal)
    want, want_lse = attention.ring_attention_plain(q, k, v, groups, causal=causal,
                                                    with_lse=True)
    assert out.dtype == want.dtype == dtype and out.shape == want.shape
    chip_smoke.check_close(torch, "split forward out", out, want, dtype)
    chip_smoke.check_close(torch, "split forward lse", lse, want_lse, torch.float32)


@pytest.mark.parametrize("dtype,products", [
    (torch.bfloat16, (torch.matmul, mm_single_bf16, 64)),
    (torch.float32, (mm_1xtf32, mm_1xtf32, 32)),
])
def test_forward_one_term_leaves_the_float32_allowance(dtype, products):
    """Before the final rounding the forward's output is float32: with the
    hi/lo splits it stays within the float32 allowance of the plain
    version; with a single bf16 P, or single TF32 products, it does not
    (the recorded share is above 1)."""
    q, k, v, _, _, _ = world(4, 4, 2, 64, 128, dtype, True, seed=5)
    want, want_lse = attention.ring_attention_plain(*(t.float() for t in (q, k, v)),
                                                    causal=True, with_lse=True)
    split, split_lse = emulated_fwd(q, k, v, causal=True, cast=False)
    chip_smoke.check_close(torch, "split out", split, want, torch.float32)
    chip_smoke.check_close(torch, "split lse", split_lse, want_lse, torch.float32)
    one, _ = emulated_fwd(q, k, v, causal=True, products=products, cast=False)
    share = float(((one - want).abs() / 1e-5).max())
    assert share > 1.0, share


def test_split_forward_matches_the_reference():
    """At one size (GQA, causal, Sb = 48: a full and a partial 32-row
    k-tile) the float32 forward's tiles and splits against the reference's
    Pallas forward in interpret mode, with tests/test_torch_attention.py's
    float32 tolerance."""
    rs = np.random.RandomState(21)
    q, k, v = (rs.randn(4, h, 48, 128).astype(np.float32) for h in (4, 2, 2))
    want = jax_forward(q, k, v, "f32", causal=True)
    got, _ = emulated_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


finite = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 100, allow_nan=False,
                   allow_infinity=False, width=32)
signed = st.tuples(finite, st.booleans()).map(lambda t: -t[0] if t[1] else t[0])


@settings(max_examples=300, deadline=None)
@given(signed)
def test_bf16_hi_plus_lo_reconstructs_x(x):
    t = torch.tensor([x], dtype=torch.float32)
    hi, lo = split_bf16(t)
    assert abs(float(hi.double() + lo.double()) - x) <= 2.0 ** -16 * abs(x)


@settings(max_examples=300, deadline=None)
@given(signed)
def test_tf32_hi_plus_lo_reconstructs_x(x):
    t = torch.tensor([x], dtype=torch.float32)
    hi, lo = split_tf32(t)
    assert abs(float(hi.double() + lo.double()) - x) <= 2.0 ** -20 * abs(x)
    # cvt.rna's rounding, emulated the same way, halves the bound
    hr = tf32_rna(t)
    assert abs(float(hr.double() + tf32_rna(t - hr).double()) - x) <= 2.0 ** -22 * abs(x)


@settings(max_examples=300, deadline=None)
@given(signed, signed)
def test_3xtf32_product_within_three_2_to_minus_20(a, b):
    ta, tb = torch.tensor([[a]]), torch.tensor([[b]])
    (ah, al), (bh, bl) = split_tf32(ta), split_tf32(tb)
    got = float(al.double() * bh.double() + ah.double() * bh.double()
                + ah.double() * bl.double())
    assert abs(got - a * b) <= (3 + 2.0 ** -10) * 2.0 ** -20 * abs(a * b)
