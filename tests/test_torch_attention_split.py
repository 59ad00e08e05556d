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

The forward folds the K/V block in tiles of 128 (bf16 at d = 128), 64
(bf16 at d = 256) or 32 (float32) rows with the online rescale, in log2
units (scores times scale log2(e), exp2, lse = m ln 2 + log l), in blocks
of 128 Q rows (bf16) with the kernel's shortcuts where asked.  The
emulation differs from the kernels only in the order of the float32 sums
and in exp2 (the card's ex2.approx is within two ulps), so these tests are
the evidence, before the card sees the kernels, that the split depth fits
the tolerance.  In the backward a
single bf16 P and dS, or a single TF32 product, does not fit it; in the
forward, whose only float32 operand is P, neither does.  The forms above
d = 256 (csrc/attention_wide.cu, attention_bwd_wide.cu) run in
thread-block clusters: the forward's order of sums, and the bf16
backward's, are emulated at the end of the file.
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


def tf32_chain(a, b):
    """a b as the float32 kernels form the chains of (at most) four k steps
    of one block of d or one streamed tile: both operands split (TF32
    truncation), a_hi b_hi + (a_lo b_hi + a_hi b_lo), each term a chain on
    the tensor core (a_hi b_hi and a_hi b_lo in one wgmma of twice the
    width; dK/dV's outputs sum the two small terms in one chain), added by
    float32 adds."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return ah @ bh + (al @ bh + ah @ bl)


def tf32_blocks(a, b):
    """a b (a [..., n, d], b [..., d, k]) as the float32 forward at d <= 256
    forms S = Q K^T: one ``tf32_chain`` a 32-column block of d (four k
    steps), the blocks of each 128 columns added in order; at d = 256 each
    consumer warpgroup forms one 128-column half and the two halves' sums
    are added."""
    def half(c0):
        acc = tf32_chain(a[..., c0:c0 + 32], b[..., c0:c0 + 32, :])
        for c in range(c0 + 32, min(c0 + 128, a.shape[-1]), 32):
            acc = acc + tf32_chain(a[..., c:c + 32], b[..., c:c + 32, :])
        return acc
    acc = half(0)
    for c0 in range(128, a.shape[-1], 128):
        acc = acc + half(c0)
    return acc


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
# (bf16: 64-row tiles at d = 256, 128-row ones at d = 128, kernel_fwd_products;
# float32 (csrc/attention.cu attn_fwd_f32_kernel): S a chain a 32-column
# block of d (tf32_blocks), O^T = V^T P^T over the 32-row tile as a_hi b_hi
# + (a_lo b_hi + a_hi b_lo), each term a chain, added to O by float32 adds
# after O's rescale; the terms are those of P V with P and V split)
FWD_PRODUCTS = {torch.float32: (tf32_blocks, tf32_chain, 32),
                torch.bfloat16: (torch.matmul, mm_split_bf16, 64)}


def kernel_fwd_products(dtype, d):
    """The forward kernel's products and k-tile rows at head dim ``d``
    (csrc/attention.cu ``FwdBf16Plan``, ``FwdF32Plan``)."""
    qk, pv, tile = FWD_PRODUCTS[dtype]
    return qk, pv, 128 if dtype == torch.bfloat16 and d == 128 else tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def emulated_fwd(q, k, v, groups=None, *, causal=False, products=None, cast=True, rows=None,
                 shortcuts=False):
    """The forward kernel's arithmetic on the CPU (shapes as
    ``ring_attention_plain``, multi-head): each arrival's K/V block in
    tiles of 128 (bf16 at d = 128), 64 (bf16 at d = 256) or 32 (float32)
    rows, each tile folded into the float32 state (m in log2 units, l, o);
    returns (out, lse).

    ``rows``: the Q rows of a kernel block (None: a rank's whole block at
    once).  A block walks, on its diagonal arrival, the k-tiles up to the
    one holding its last row (``DqWalk``), and every row of it folds every
    tile of that walk; the rows are folded a warp's 16 at a time.
    ``shortcuts``: the bf16 kernel's, for each warp's rows: a tile with no
    masked entry for them folds without the mask, and o is not rescaled in
    a head where alpha is 1 for all of them."""
    nranks, hq, sb, d = q.shape
    qk, pv, tile = products or kernel_fwd_products(q.dtype, d)
    rep = hq // k.shape[1]
    heads = torch.arange(hq) // rep
    scale2 = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    gl = groups or [list(range(nranks))]
    qf, kf, vf = (t.float() for t in (q, k, v))
    mask = torch.arange(sb)[None, :] <= torch.arange(sb)[:, None]
    nk = -(-sb // tile)
    block, warp = (sb, sb) if rows is None else (rows, 16)
    out = torch.empty(qf.shape)
    lse = torch.empty((nranks, hq, sb))
    for grp in gl:
        g = len(grp)
        for r, w in enumerate(grp):
            for b0 in range(0, sb, block):
                first = min(nk, (b0 + block - 1) // tile + 1)
                for w0 in range(b0, min(sb, b0 + block), warp):
                    qs = slice(w0, min(sb, w0 + warp))
                    m = torch.full((hq, qs.stop - w0, 1), -np.inf)
                    l = torch.zeros((hq, qs.stop - w0, 1))
                    o = torch.zeros((hq, qs.stop - w0, d))
                    for a in range(g):
                        j = (r - a) % g
                        if causal and j > r:
                            continue
                        diag = causal and j == r
                        kb, vb = kf[grp[j]][heads], vf[grp[j]][heads]
                        for k0 in range(0, (first if diag else nk) * tile, tile):
                            cols = slice(k0, min(sb, k0 + tile))
                            x = qk(qf[w][:, qs], kb[:, cols].transpose(-1, -2)) * scale2
                            if diag and not (shortcuts and k0 + tile - 1 <= w0):
                                x = torch.where(mask[qs, cols], x, torch.full_like(x, -1e30))
                            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                            alpha = torch.exp2(m - m_new)
                            p = torch.exp2(x - m_new)
                            l = l * alpha + p.sum(-1, keepdim=True)
                            if shortcuts:
                                o = torch.where((alpha == 1).all(1, keepdim=True), o, o * alpha)
                            else:
                                o = o * alpha
                            o = o + pv(p, vb[:, cols])
                            m = m_new
                    out[w][:, qs] = o / l
                    lse[w][:, qs] = (m * LN2 + torch.log(l))[..., 0]
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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_split_forward_f32_at_d256_within_check_close_of_plain(hq, hkv, causal):
    """The float32 forward's order of sums at d = 256 (eight 32-column
    chains of S a tile; each warpgroup of a 64-row block forms the whole
    of S and owns 128 columns of O, which changes no sum), {MHA, GQA, MQA}
    x {full, causal}, Sb = 8 (one partial tile) and 80 (two 32-row tiles
    and a partial one), on a world of 4 and in two groups of 2: out and lse
    against the plain forward under check_close's float32 rule, with the
    kernel's shortcuts (an unmasked path, the skipped rescale)."""
    for sb in (8, 80):
        for groups in (None, [[0, 1], [2, 3]]):
            q, k, v, _, _, _ = world(4, hq, hkv, sb, 256, torch.float32, causal, groups,
                                     seed=256 + sb + hq + hkv + causal)
            out, lse = emulated_fwd(q, k, v, groups, causal=causal, rows=64, shortcuts=True)
            want, want_lse = attention.ring_attention_plain(q, k, v, groups, causal=causal,
                                                            with_lse=True)
            assert out.dtype == want.dtype == torch.float32 and out.shape == want.shape
            chip_smoke.check_close(torch, f"f32 d=256 sb={sb} out", out, want, torch.float32)
            chip_smoke.check_close(torch, f"f32 d=256 sb={sb} lse", lse, want_lse,
                                   torch.float32)


@pytest.mark.parametrize("d,rows", [(128, 128), (256, 64)])
def test_split_forward_f32_blocks_and_shortcuts_change_no_bit(d, rows):
    """The float32 kernel's blocks (128 rows at d = 128, 64 at d = 256) fold
    every tile of their walk into every row, the ones past a row's diagonal
    all masked, and take the unmasked path and the skipped rescale: out and
    lse bitwise the whole block's at once without them (causal GQA, Sb =
    208: several blocks, the last ragged)."""
    q, k, v, _, _, _ = world(2, 4, 2, 208, d, torch.float32, True, seed=d + 7)
    whole = emulated_fwd(q, k, v, causal=True)
    blocks = emulated_fwd(q, k, v, causal=True, rows=rows, shortcuts=True)
    assert all(torch.equal(a, b) for a, b in zip(whole, blocks))


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


def test_split_forward_at_d256_matches_the_reference():
    """At d = 256 (GQA, causal, Sb = 48: a full and a partial 32-row
    k-tile) the float32 forward's order of sums against the reference's
    Pallas forward in interpret mode, with tests/test_torch_attention.py's
    float32 tolerance."""
    rs = np.random.RandomState(23)
    q, k, v = (rs.randn(4, h, 48, 256).astype(np.float32) for h in (4, 2, 2))
    want = jax_forward(q, k, v, "f32", causal=True)
    got, _ = emulated_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, rows=64,
                          shortcuts=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("sb", [80, 208])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_narrow_bf16_forward_128_row_blocks_are_bitwise_the_192_row_ones(hq, hkv, causal, sb,
                                                                         tile):
    """The bf16 forward at d = 128 in blocks of 128 Q rows with the
    kernel's shortcuts (csrc/attention.cu ``attn_fwd_bf16_kernel``) gives
    out and lse bitwise equal to blocks of 192 rows without them (the
    earlier form's three warpgroups), at the earlier form's 64-row K/V
    tiles and at the kernel's 128: a block's walk only adds tiles that are
    all masked for its earlier rows (P = 0, alpha = 1: exact zeros).
    {MHA, GQA in two groups of 2, MQA} x {full, causal}, Sb = 80 (one
    block of either size) and 208 (blocks that end at other rows), both
    ending in a partial tile; within check_close of the plain forward."""
    groups = [[0, 1], [2, 3]] if hkv == 2 else None
    q, k, v, _, _, _ = world(4, hq, hkv, sb, 128, torch.bfloat16, causal, groups,
                             seed=hq + 10 * hkv + sb)
    products = (torch.matmul, mm_split_bf16, tile)
    new = emulated_fwd(q, k, v, groups, causal=causal, products=products, rows=128,
                       shortcuts=True)
    old = emulated_fwd(q, k, v, groups, causal=causal, products=products, rows=192)
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    want, want_lse = attention.ring_attention_plain(q, k, v, groups, causal=causal,
                                                    with_lse=True)
    chip_smoke.check_close(torch, "128-row blocks out", new[0], want, torch.bfloat16)
    chip_smoke.check_close(torch, "128-row blocks lse", new[1], want_lse, torch.float32)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_narrow_bf16_forward_shortcuts_change_no_bit(hq, hkv, d):
    """The bf16 forward's unmasked path (a tile with no masked entry for a
    warp's rows folds without the mask) and its skipped rescale (alpha 1
    for all of a warp's rows) change no bit of out and lse, causal, in
    128-row blocks at Sb = 208, d = 128 and 256 (where the earlier form's
    blocks were 128 rows too)."""
    q, k, v, _, _, _ = world(4, hq, hkv, 208, d, torch.bfloat16, True, seed=d + hq + hkv)
    cut = emulated_fwd(q, k, v, causal=True, rows=128, shortcuts=True, cast=False)
    full = emulated_fwd(q, k, v, causal=True, rows=128, cast=False)
    assert torch.equal(cut[0], full[0]) and torch.equal(cut[1], full[1])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_narrow_bf16_forward_128_row_tiles_within_check_close_of_plain(hq, hkv, causal):
    """At d = 128 the bf16 forward folds 128-row K/V tiles (the earlier
    form 64): its running maximum steps every 128 columns, so P rounds at
    other places than the earlier form's and out and lse are not its bits;
    both stay within check_close of the plain forward.  {MHA, GQA in two
    groups of 2, MQA} x {full, causal}, Sb = 208 (a full and a partial
    128-row tile), in the kernel's 128-row blocks with its shortcuts."""
    groups = [[0, 1], [2, 3]] if hkv == 2 else None
    q, k, v, _, _, _ = world(4, hq, hkv, 208, 128, torch.bfloat16, causal, groups,
                             seed=hq + hkv + causal)
    want, want_lse = attention.ring_attention_plain(q, k, v, groups, causal=causal,
                                                    with_lse=True)
    for tile in (128, 64):
        out, lse = emulated_fwd(q, k, v, groups, causal=causal, rows=128, shortcuts=True,
                                products=(torch.matmul, mm_split_bf16, tile))
        chip_smoke.check_close(torch, f"{tile}-row tiles out", out, want, torch.bfloat16)
        chip_smoke.check_close(torch, f"{tile}-row tiles lse", lse, want_lse, torch.float32)


def test_narrow_bf16_forward_matches_the_reference():
    """At d = 128 (GQA, causal, Sb = 208) on inputs whose values are bf16:
    the bf16 forward's 128-row tiles, blocks and shortcuts, before the
    final rounding, against the reference's Pallas forward in interpret
    mode in float32, within check_close's float32 allowance (out 1e-5)."""
    rs = np.random.RandomState(29)
    q, k, v = (torch.from_numpy(rs.randn(2, h, 208, 128).astype(np.float32))
               .to(torch.bfloat16).float() for h in (4, 2, 2))
    want = jax_forward(*(t.numpy() for t in (q, k, v)), "f32", causal=True)
    got, _ = emulated_fwd(*(t.to(torch.bfloat16) for t in (q, k, v)), causal=True, rows=128,
                          shortcuts=True, cast=False)
    chip_smoke.check_close(torch, "128-row tiles out vs reference", got, torch.tensor(want),
                           torch.float32)


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


# -- the forward above d = 256 in thread-block clusters (csrc/attention_wide.cu)
#
# A cluster of C blocks (``attention.wide_cluster``) forms S once a K/V tile:
# block c's partial over its own m chunks of 128 columns of d (m = 1 at
# d <= 1024), the partials summed in rank order 0..C-1 by float32 adds; at
# m > 1 a block takes m passes, pass p's units in chunk order c m + (p + 1 +
# u) % m (the pass's own output chunk last), and each pass forms its own S
# for its own output chunk.  float32: a chunk's partial is four chains of
# four TF32 k steps (32 columns), the hi x hi products in one chain and the
# two small products in another; warpgroup w adds the chains of the blocks
# 2 w and 2 w + 1 (over the block's m chunks, in unit order), and the block's
# partial is warpgroup 0's sum plus warpgroup 1's; the output is formed
# transposed, O^T = V^T P^T, one chain of each kind over a 32-row tile,
# then O = O alpha + (big + small).  bf16: a chunk's partial is one bf16
# product (exact products summed in float32), P enters P V as hi and lo;
# 64-row tiles.


def wide_partial_f32(a, bt, chunk):
    """One chunk's parts of A B^T (a [.., n, d], bt [.., d, k]) as the
    float32 kernel forms them: 32-column chains, each big + small, the
    first two blocks' added (warpgroup 0's part), the last two's
    (warpgroup 1's)."""
    def chain(cb):
        cols = slice(128 * chunk + 32 * cb, 128 * chunk + 32 * cb + 32)
        (ah, al), (bh, bl) = split_tf32(a[..., cols]), split_tf32(bt[..., cols, :])
        return ah @ bh + (al @ bh + ah @ bl)
    return chain(0) + chain(1), chain(2) + chain(3)


def wide_partial_bf16(a, bt, chunk):
    cols = slice(128 * chunk, 128 * chunk + 128)
    return (a[..., cols] @ bt[..., cols, :],)


def wide_pv_f32(p, v):
    """O^T = V^T P^T over one tile: big + small, both operands split."""
    (ph, pl), (vh, vl) = split_tf32(p), split_tf32(v)
    return ph @ vh + (pl @ vh + ph @ vl)


def cluster_qk(d, pass_, partial):
    """Q K^T as pass ``pass_`` of the clusters at head dim d sums it."""
    C, m = attention.wide_cluster(d)

    def qk(a, bt):
        s = None
        for c in range(C):
            parts = None
            for u in range(m):
                f = partial(a, bt, c * m + (pass_ + 1 + u) % m)
                parts = f if parts is None else tuple(x + y for x, y in zip(parts, f))
            pc = parts[0]
            for x in parts[1:]:
                pc = pc + x
            s = pc if s is None else s + pc
        return s
    return qk


def emulated_wide_fwd(q, k, v, groups=None, *, causal=False):
    """The cluster forward's arithmetic on the CPU: pass p of the clusters
    gives output chunks c m + p (c < C) and, at p = 0, the lse."""
    d = q.shape[-1]
    C, m = attention.wide_cluster(d)
    f32 = q.dtype == torch.float32
    partial, pv, tile = ((wide_partial_f32, wide_pv_f32, 32) if f32 else
                         (wide_partial_bf16, mm_split_bf16, 64))
    out = torch.empty(q.shape)
    for pass_ in range(m):
        o, lse_p = emulated_fwd(q, k, v, groups, causal=causal, cast=False,
                                products=(cluster_qk(d, pass_, partial), pv, tile))
        for c in range(C):
            cols = slice((c * m + pass_) * 128, (c * m + pass_ + 1) * 128)
            out[..., cols] = o[..., cols]
        if pass_ == 0:
            lse = lse_p
    return out.to(q.dtype), lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [512, 640, 1152])
def test_cluster_forward_within_check_close_of_plain(d, causal, dtype):
    """d = 512 (clusters of 4), 640 (5) and 1152 (3 blocks of 3 passes),
    GQA 4/2 in two groups of 2 on a world of 4, Sb = 48 (float32: a full
    and a partial 32-row tile) or 80 (bf16: 64 and 16 rows): the cluster
    forward's order of sums against the plain forward, out and lse."""
    sb = 48 if dtype == torch.float32 else 80
    q, k, v, _, _, _ = world(4, 4, 2, sb, d, dtype, causal, [[0, 1], [2, 3]], seed=d + causal)
    out, lse = emulated_wide_fwd(q, k, v, [[0, 1], [2, 3]], causal=causal)
    want, want_lse = attention.ring_attention_plain(q, k, v, [[0, 1], [2, 3]], causal=causal,
                                                    with_lse=True)
    assert out.dtype == want.dtype == dtype and out.shape == want.shape
    chip_smoke.check_close(torch, "cluster forward out", out, want, dtype)
    chip_smoke.check_close(torch, "cluster forward lse", lse, want_lse, torch.float32)


def test_cluster_forward_passes_differ_only_in_the_order_of_sums():
    """At m > 1 (d = 1152: 3 blocks of 3 passes) each pass sums S in its own
    order, so the passes' S differ in their last bits, and by no more than
    the float32 rounding of a sum over d."""
    rs = np.random.RandomState(3)
    a = torch.from_numpy(rs.randn(2, 16, 1152).astype(np.float32))
    bt = torch.from_numpy(rs.randn(2, 1152, 32).astype(np.float32))
    s = [cluster_qk(1152, p, wide_partial_f32)(a, bt) for p in range(3)]
    exact = a.double() @ bt.double()
    assert not torch.equal(s[0], s[1])
    for x in s:
        assert float((x.double() - exact).abs().max()) < 1e-4 * float(exact.abs().max())


def test_cluster_forward_matches_the_reference():
    """At d = 512 (GQA, causal, Sb = 48) the float32 cluster forward's
    order of sums against the reference's Pallas forward in interpret
    mode, with tests/test_torch_attention.py's float32 tolerance."""
    rs = np.random.RandomState(23)
    q, k, v = (rs.randn(4, h, 48, 512).astype(np.float32) for h in (4, 2, 2))
    want = jax_forward(q, k, v, "f32", causal=True)
    got, _ = emulated_wide_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- the backward above d = 256 in thread-block clusters, bf16
# (csrc/attention_bwd_wide.cu)
#
# The forward's clusters: for each 64-row tile of the other side, S and dP
# are the sums of the cluster's bf16 partials (``cluster_qk`` with
# ``wide_partial_bf16``: exact products summed in float32, each block's m
# chunks in unit order, the C partials in rank order); P and dS enter the
# output products in three bf16 terms, hi, mid and lo, one product a tile
# (a chain of tensor-core sums a tile long), each added to a float32
# running sum in its walk's order: dQ over the arrivals' K/V tiles in ring
# order, dK and dV over the visiting ranks, the GQA heads and the Q tiles.
# At m > 1 pass p forms its own S and dP for its own output chunks.


def split3_bf16(x):
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, (r - mid).to(torch.bfloat16).float()


def mm_split3_bf16(a, b):
    """a float32 in three bf16 terms; b exact in bf16."""
    hi, mid, lo = split3_bf16(a)
    return hi @ b + mid @ b + lo @ b


def test_three_bf16_terms_keep_cancelling_sums_within_the_float32_allowance():
    """An output of the bf16 backward sums products of P (or dS) entries
    with bf16 rows.  Where large products cancel, the sum is near 0 and its
    float32 allowance is about the absolute 1e-5: two bf16 terms (hi, lo)
    leave up to 2^-17 of each entry and pass it (found on an H100 at
    d = 1024, MQA, causal: dV of an early key row); three are the entry
    itself.  Products and sums in float64, so that only the split
    differs."""
    rs = np.random.RandomState(7)
    p = rs.uniform(0.25, 1.0, (64, 128))
    p = torch.from_numpy(np.concatenate([p, p * (1 + rs.uniform(-1e-6, 1e-6, p.shape))], 1)
                         .astype(np.float32))
    b = torch.from_numpy(rs.randn(128, 64).astype(np.float32)).to(torch.bfloat16).double()
    b = torch.cat([b, -b])
    exact = p.double() @ b
    allow = 1e-5 + 1e-4 * exact.abs()
    two = sum(t.double() @ b for t in split_bf16(p))
    three = sum(t.double() @ b for t in split3_bf16(p))
    assert float(((two - exact).abs() / allow).max()) > 1.0
    assert float(((three - exact).abs() / allow).max()) < 0.01


def emulated_wide_bwd(q, k, v, out, lse, dout, groups=None, *, causal=False, cast=True):
    """The bf16 cluster backward's arithmetic on the CPU (shapes as
    ``ring_attention_bwd_plain``, multi-head); inputs whose values are
    bf16 (of either dtype)."""
    nranks, hq, sb, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    heads = torch.arange(hq) // rep
    scale = 1.0 / np.sqrt(d)
    C, m = attention.wide_cluster(d)
    gl = groups or [list(range(nranks))]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dof * out.float()).sum(-1, keepdim=True)
    lse4 = lse.reshape(nranks, hq, sb, 1)
    mask = torch.arange(sb)[None, :] <= torch.arange(sb)[:, None]
    tiles = [slice(t0, min(sb, t0 + 64)) for t0 in range(0, sb, 64)]
    dq, dk, dv = torch.zeros(qf.shape), torch.zeros(kf.shape), torch.zeros(kf.shape)
    for pass_ in range(m):
        qk = cluster_qk(d, pass_, wide_partial_bf16)
        cols = torch.cat([torch.arange((c * m + pass_) * 128, (c * m + pass_ + 1) * 128)
                          for c in range(C)])
        for grp in gl:
            g = len(grp)
            p_of, ds_of = {}, {}  # (r, j): P and dS of rank r's queries, block j's keys
            for r, w in enumerate(grp):
                for j in range(g):
                    if causal and j > r:
                        continue
                    kb, vb = kf[grp[j]][heads], vf[grp[j]][heads]
                    p = torch.exp(qk(qf[w], kb.transpose(-1, -2)) * scale - lse4[w])
                    if causal and j == r:
                        p = torch.where(mask, p, torch.zeros_like(p))
                    p_of[r, j] = p
                    ds_of[r, j] = p * (qk(dof[w], vb.transpose(-1, -2)) - delta[w]) * scale
            for r, w in enumerate(grp):
                run = torch.zeros(hq, sb, d)
                for a in range(g):
                    j = (r - a) % g
                    if (r, j) in ds_of:
                        kb = kf[grp[j]][heads]
                        for t in tiles:
                            run = run + mm_split3_bf16(ds_of[r, j][..., t], kb[:, t])
                dq[w][..., cols] = run[..., cols]
            for j, kw in enumerate(grp):
                run_k, run_v = torch.zeros(hkv, sb, d), torch.zeros(hkv, sb, d)
                for a in range(g):
                    r = (j + a) % g
                    if (r, j) not in p_of:
                        continue
                    w = grp[r]
                    for t in range(rep):
                        hs = slice(t, hq, rep)  # head t of each K/V head
                        for qt in tiles:
                            run_v = run_v + mm_split3_bf16(
                                p_of[r, j][hs][:, qt].transpose(-1, -2), dof[w][hs][:, qt])
                            run_k = run_k + mm_split3_bf16(
                                ds_of[r, j][hs][:, qt].transpose(-1, -2), qf[w][hs][:, qt])
                dk[kw][..., cols] = run_k[..., cols]
                dv[kw][..., cols] = run_v[..., cols]
    if cast:
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [512, 640, 1152])
def test_cluster_backward_within_check_close_of_plain(d, causal):
    """d = 512 (clusters of 4), 640 (5) and 1152 (3 blocks of 3 passes),
    GQA 4/2 in two groups of 2 on a world of 4, Sb = 80 (a 64-row tile and
    a partial one of 16): the bf16 cluster backward's order of sums against
    the plain backward, dq, dk and dv."""
    groups = [[0, 1], [2, 3]]
    ops = world(4, 4, 2, 80, d, torch.bfloat16, causal, groups, seed=d + 2 + causal)
    got = emulated_wide_bwd(*ops, groups, causal=causal)
    want = attention.ring_attention_bwd_plain(*ops, groups, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        chip_smoke.check_close(torch, f"cluster backward {name}", a, b, torch.bfloat16)


def test_cluster_backward_matches_jax_grad_of_the_reference():
    """At d = 512 (GQA, causal, Sb = 80) on inputs whose values are bf16:
    the cluster backward's order of sums, before its final rounding,
    against ``jax.grad`` through the reference's fused backward in
    interpret mode, with tests/test_torch_attention_grad.py's float32
    tolerance."""
    rnd = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()  # noqa: E731
    q, k, v, ct = (rnd(a) for a in inputs(2, 4, 2, 80, 512, seed=31))
    want = jax_grads(q, k, v, ct, "f32", True)
    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = attention.ring_attention_plain(tq, tk, tv, causal=True, with_lse=True)
    got = emulated_wide_bwd(tq, tk, tv, out, lse, tct, causal=True, cast=False)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL["f32"])


def emulated_narrow_bwd(q, k, v, out, lse, dout, groups=None, *, causal=False, cast=True):
    """The bf16 backward's order of sums at d = 128 and 256
    (csrc/attention_bwd.cu ``attn_bwd_dq_bf16_kernel``,
    ``attn_bwd_dkv_bf16_kernel``) on the CPU (shapes as
    ``ring_attention_bwd_plain``, multi-head; inputs whose values are
    bf16): S and dP one running float32 sum over d in 16-column steps; P =
    2^(S scale log2(e) - lse log2(e)) (exp2, as the kernels); P and dS split
    hi and lo; every output one running float32 sum over its
    block's walk (dQ: arrivals r, r - 1, ..., then k rows; dK, dV: visiting
    ranks j, j + 1, ..., GQA heads in increasing order, then q rows), a
    16-row k step at a time, its lo then its hi product.  A 128-row block's
    rows past the diagonal add exact zeros, so they do not show here."""
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
    steps = [slice(s0, min(sb, s0 + 16)) for s0 in range(0, sb, 16)]

    def chain(a, b):
        """a [..., m, d] b^T [..., d, n] in 16-column steps of d"""
        acc = a[..., :16] @ b[..., :16].transpose(-1, -2)
        for c0 in range(16, d, 16):
            acc = acc + a[..., c0:c0 + 16] @ b[..., c0:c0 + 16].transpose(-1, -2)
        return acc

    def add_steps(acc, x, b):
        """acc + x b, a 16-row k step at a time, lo then hi"""
        for st in steps:
            hi, lo = split_bf16(x[..., st])
            acc = acc + lo @ b[..., st, :]
            acc = acc + hi @ b[..., st, :]
        return acc

    dq, dk, dv = torch.zeros(qf.shape), torch.zeros(kf.shape), torch.zeros(kf.shape)
    for grp in gl:
        g = len(grp)
        p_of, ds_of = {}, {}  # (r, j): P and dS of rank r's queries, block j's keys
        for r, w in enumerate(grp):
            for j in range(g):
                if causal and j > r:
                    continue
                kb, vb = kf[grp[j]][heads], vf[grp[j]][heads]
                p = torch.exp2(chain(qf[w], kb) * (scale * LOG2E) - lse4[w] * LOG2E)
                if causal and j == r:
                    p = torch.where(mask, p, torch.zeros_like(p))
                p_of[r, j] = p
                ds_of[r, j] = p * (chain(dof[w], vb) - delta[w]) * scale
        for r, w in enumerate(grp):
            for a in range(g):
                j = (r - a) % g
                if (r, j) in ds_of:
                    dq[w] = add_steps(dq[w], ds_of[r, j], kf[grp[j]][heads])
        for j, kw in enumerate(grp):
            for a in range(g):
                r = (j + a) % g
                if (r, j) not in p_of:
                    continue
                w = grp[r]
                for t in range(rep):
                    hs = slice(t, hq, rep)  # head t of each K/V head
                    dv[kw] = add_steps(dv[kw], p_of[r, j][hs].transpose(-1, -2), dof[w][hs])
                    dk[kw] = add_steps(dk[kw], ds_of[r, j][hs].transpose(-1, -2), qf[w][hs])
    if cast:
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [128, 256])
def test_narrow_bf16_backward_order_within_check_close_of_plain(d, causal):
    """d = 128 and 256, GQA 4/2 in two groups of 2 on a world of 4, Sb = 80
    (five 16-row k steps, a partial 64-row tile): the bf16 backward's order
    of sums against the plain backward, dq, dk and dv."""
    groups = [[0, 1], [2, 3]]
    ops = world(4, 4, 2, 80, d, torch.bfloat16, causal, groups, seed=d + 5 + causal)
    got = emulated_narrow_bwd(*ops, groups, causal=causal)
    want = attention.ring_attention_bwd_plain(*ops, groups, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        chip_smoke.check_close(torch, f"narrow backward {name}", a, b, torch.bfloat16)


def test_narrow_bf16_backward_order_matches_jax_grad_of_the_reference():
    """At d = 128 (GQA, causal, Sb = 80) on inputs whose values are bf16:
    the bf16 backward's order of sums against ``jax.grad`` through the
    reference's fused backward in interpret mode, before the final rounding,
    under check_close's bf16 rule, which the kernel's bf16 outputs are held
    to on the card.  The float32 tolerance of
    tests/test_torch_attention_grad.py is met but for one dV element of
    40 960 (2.0e-5 off where 2^-17 of each P entry, what the hi and lo terms
    leave, meets cancelling products)."""
    rnd = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()  # noqa: E731
    q, k, v, ct = (rnd(a) for a in inputs(2, 4, 2, 80, 128, seed=37))
    want = jax_grads(q, k, v, ct, "f32", True)
    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = attention.ring_attention_plain(tq, tk, tv, causal=True, with_lse=True)
    got = emulated_narrow_bwd(tq, tk, tv, out, lse, tct, causal=True, cast=False)
    for name, g, w in zip("qkv", got, want):
        chip_smoke.check_close(torch, f"narrow backward d{name} vs jax.grad", g,
                               torch.from_numpy(w), torch.bfloat16)


# (P, query heads, K/V heads, Sb) of the backward's split check at d = 128,
# causal, on seeds 101-106 (chip_smoke.SPLIT_SEEDS holds the same on the card)
SPLIT_SHAPES = ((4, 8, 1, 64), (8, 4, 1, 32), (4, 4, 2, 64))


@pytest.mark.parametrize("seed", range(101, 107))
def test_narrow_bf16_backward_two_terms_stay_within_the_allowance(seed):
    """P and dS as two bf16 terms (hi, lo) in the bf16 backward's order of
    sums keep every causal case of SPLIT_SHAPES within check_close's bf16
    allowance of the plain backward (the three-term split is needed only
    where outputs sum cancelling products past the float32 allowance)."""
    for P, hq, hkv, sb in SPLIT_SHAPES:
        ops = world(P, hq, hkv, sb, 128, torch.bfloat16, True, seed=seed)
        got = emulated_narrow_bwd(*ops, causal=True)
        want = attention.ring_attention_bwd_plain(*ops, causal=True)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            chip_smoke.check_close(torch, f"seed {seed} {P}x{hq}/{hkv}x{sb} {name}", a, b,
                                   torch.bfloat16)


# -- the float32 backward at d = 128 and 256 (attention_bwd.cu
# attn_bwd_dq_f32_kernel, attn_bwd_dkv_f32_kernel): TF32 wgmma, three
# products a product, the outputs formed transposed


def emulated_narrow_f32_bwd(q, k, v, out, lse, dout, groups=None, *, causal=False,
                            chain=tf32_chain):
    """The float32 backward's order of sums (csrc/attention_bwd.cu at d =
    128 and 256) on the CPU (shapes as ``ring_attention_bwd_plain``, multi-head):
    S (S^T) and dP (dP^T) as chains over 32-column blocks of d (four k
    steps each), the blocks' chains added in order; P = 2^(S scale log2(e) -
    lse log2(e)) (exp2, as the kernels), dS = P (dP - delta) scale; every
    output formed transposed, dQ^T = K^T dS^T, dV^T = dO^T P, dK^T = Q^T dS,
    one chain over each 32-row tile of the streamed side, added to a float32
    running sum in its block's walk (dQ: arrivals r, r - 1, ..., then k
    tiles; dK, dV: visiting ranks j, j + 1, ..., GQA heads in increasing
    order, then q tiles).  A block's rows past the diagonal add exact
    zeros, so they do not show here.  ``chain``: the product of one chain
    (``tf32_chain``; a plain TF32 product for the negative control)."""
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
    tiles = [slice(t0, min(sb, t0 + 32)) for t0 in range(0, sb, 32)]
    T = lambda x: x.transpose(-1, -2)  # noqa: E731

    def formed(a, b):
        """a [..., m, d] b^T [..., d, n]: one chain a 32-column block of d"""
        acc = chain(a[..., :32], T(b[..., :32]))
        for c0 in range(32, d, 32):
            acc = acc + chain(a[..., c0:c0 + 32], T(b[..., c0:c0 + 32]))
        return acc

    dq, dk, dv = torch.zeros(qf.shape), torch.zeros(kf.shape), torch.zeros(kf.shape)
    for grp in gl:
        g = len(grp)
        p_of, ds_of = {}, {}  # (r, j): P and dS of rank r's queries, block j's keys
        for r, w in enumerate(grp):
            for j in range(g):
                if causal and j > r:
                    continue
                kb, vb = kf[grp[j]][heads], vf[grp[j]][heads]
                p = torch.exp2(formed(qf[w], kb) * (scale * LOG2E) - lse4[w] * LOG2E)
                if causal and j == r:
                    p = torch.where(mask, p, torch.zeros_like(p))
                p_of[r, j] = p
                ds_of[r, j] = p * (formed(dof[w], vb) - delta[w]) * scale
        for r, w in enumerate(grp):
            acc = torch.zeros(hq, d, sb)  # dQ^T
            for a in range(g):
                j = (r - a) % g
                if (r, j) in ds_of:
                    kb = kf[grp[j]][heads]
                    for t in tiles:
                        acc = acc + chain(T(kb[:, t]), T(ds_of[r, j][..., t]))
            dq[w] = T(acc)
        for j, kw in enumerate(grp):
            acc_k, acc_v = torch.zeros(hkv, d, sb), torch.zeros(hkv, d, sb)  # dK^T, dV^T
            for a in range(g):
                r = (j + a) % g
                if (r, j) not in p_of:
                    continue
                w = grp[r]
                for t in range(rep):
                    hs = slice(t, hq, rep)  # head t of each K/V head
                    for qt in tiles:
                        acc_v = acc_v + chain(T(dof[w][hs][:, qt]), p_of[r, j][hs][:, qt])
                        acc_k = acc_k + chain(T(qf[w][hs][:, qt]), ds_of[r, j][hs][:, qt])
            dk[kw], dv[kw] = T(acc_k), T(acc_v)
    return dq, dk, dv


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_narrow_f32_backward_order_within_check_close_of_plain(hq, hkv, causal, d):
    """{MHA, GQA, MQA} x {full, causal} x d = 128 and 256, on a world of 4
    and in two groups of 2, Sb = 8 (one partial tile) and 80 (two 32-row
    tiles and a partial one): the float32 backward's order of sums against
    the plain backward, dq, dk and dv, under check_close's float32 rule,
    which the kernels are held to on the card (at d = 256 its column-chunk
    units take a tile's 32-column blocks in the same order, and each
    output still sums one chain a 32-row tile)."""
    for sb in (8, 80):
        for groups in (None, [[0, 1], [2, 3]]):
            ops = world(4, hq, hkv, sb, d, torch.float32, causal, groups,
                        seed=d + sb + hq + hkv + causal)
            got = emulated_narrow_f32_bwd(*ops, groups, causal=causal)
            want = attention.ring_attention_bwd_plain(*ops, groups, causal=causal)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
                chip_smoke.check_close(torch, f"narrow f32 {name} sb={sb} groups={groups}", a, b,
                                       torch.float32)


def test_narrow_f32_backward_order_matches_jax_grad_of_the_reference():
    """At d = 128 (GQA, causal, Sb = 80): the float32 backward's order of
    sums against ``jax.grad`` through the reference's fused backward in
    interpret mode, with tests/test_torch_attention_grad.py's float32
    tolerance."""
    q, k, v, ct = inputs(2, 4, 2, 80, 128, seed=41)
    want = jax_grads(q, k, v, ct, "f32", True)
    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = attention.ring_attention_plain(tq, tk, tv, causal=True, with_lse=True)
    got = emulated_narrow_f32_bwd(tq, tk, tv, out, lse, tct, causal=True)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL["f32"])


def test_narrow_f32_backward_order_at_d256_matches_jax_grad_of_the_reference():
    """At d = 256 (GQA 4/2, causal, Sb = 80: two 32-row tiles and a
    partial one, eight 32-column blocks of d): the float32 backward's order
    of sums against ``jax.grad`` through the reference's fused backward in
    interpret mode, with tests/test_torch_attention_grad.py's float32
    tolerance."""
    q, k, v, ct = inputs(2, 4, 2, 80, 256, seed=47)
    want = jax_grads(q, k, v, ct, "f32", True)
    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = attention.ring_attention_plain(tq, tk, tv, causal=True, with_lse=True)
    got = emulated_narrow_f32_bwd(tq, tk, tv, out, lse, tct, causal=True)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL["f32"])


def test_narrow_f32_backward_plain_tf32_leaves_the_allowance():
    """The negative control: the same order with every product a single
    TF32 product (no lo terms) leaves the float32 allowance of the plain
    backward, where the three products stay within it."""
    ops = world(4, 4, 2, 80, 128, torch.float32, True, seed=43)
    want = attention.ring_attention_bwd_plain(*ops, causal=True)
    three = emulated_narrow_f32_bwd(*ops, causal=True)
    one = emulated_narrow_f32_bwd(*ops, causal=True, chain=mm_1xtf32)
    worst = 0.0
    for name, a, b, c in zip(("dq", "dk", "dv"), three, one, want):
        chip_smoke.check_close(torch, f"three products {name}", a, c, torch.float32)
        allow = 1e-5 + 1e-4 * c.abs()
        worst = max(worst, float(((b - c).abs() / allow).max()))
    assert worst > 1.0
