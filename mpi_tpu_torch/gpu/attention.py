"""Ring attention over the SPMD world: the CUDA kernels that replace the
Pallas ring-attention kernels, their plain PyTorch versions, and the
differentiable per-rank entry point.

Counterpart of ``mpi_tpu/tpu/pallas_attention.py``.  The TPU forward
(``_kernel`` :367, launched by ``_kernel_call`` :1059) circulates every
rank's K/V block around the ring as RDMAs and folds each arrival into an
online-softmax state; the TPU backward (``_bwd_kernel`` :617, launched by
``_bwd_kernel_call`` :1130) circulates [K, V, dK, dV] for a full cycle.  On
one card all P ranks' blocks share one memory, so ``csrc/attention.cu``
(forward) and ``csrc/attention_bwd.cu`` (backward), both on the tensor
cores, read, for each rank, the blocks its ring would have delivered, in
the order it would have delivered them (the design notes are in the
sources).  They are built for d = 128 and 256; every other head dim the
reference takes (any multiple of 128) runs their forms in
``csrc/attention_wide.cu`` and ``csrc/attention_bwd_wide.cu``, which cut d
into 128-column chunks, inside the same ops.
No slot, credit, barrier or VMEM plan carries over: ``interpret`` and
``vmem_limit_bytes`` have no counterpart and are dropped, and there is no
fallback.  A kernel whose shared-memory plan would not fit a block raises
``NotImplementedError`` with the byte arithmetic (no plan does).

Three layers:

* ``ring_attention_world`` / ``ring_attention_bwd_world`` take the physical
  ``[P, ...]`` world.  On a CUDA tensor they launch the kernels (and count
  each launch in ``LAUNCHES``, or in ``WIDE_LAUNCHES`` for d above 256) or
  raise; on a CPU tensor they run the plain versions.
* ``ring_attention_plain`` / ``ring_attention_bwd_plain``: the TPU schedule
  step by step in torch ops, all state in float32 (the head-dim products
  summed in float64).
* ``ring_attention`` is the per-rank call made inside ``run_spmd`` (the
  counterpart of ``pallas_ring_attention`` :925).  It is a
  ``torch.autograd.Function`` whose ``vmap`` rule hands the world to the
  forward; its backward calls a second world-level function with its own
  ``vmap`` rule, so the backward kernels see the world too.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import primitives
from .ring import (_DTYPE_CODE, _LANES, _SUBLANES, Groups, _group_list,
                   _group_table, _stream)

_MASKED = -1e30  # large-negative finite, as pallas_attention.py:109
# the head dims of csrc/attention.cu and csrc/attention_bwd.cu; any other
# multiple of 128 takes csrc/attention_wide.cu and csrc/attention_bwd_wide.cu
_HEAD_DIMS = (128, 256)
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
# score-block elements per plain-version step: bounds its peak memory
_PLAIN_SCORES = 1 << 26

# kernel launches per entry point: a wrapper adds one exactly where it
# launches, in LAUNCHES for d in _HEAD_DIMS, in WIDE_LAUNCHES above
LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
WIDE_LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, WIDE_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _wide(d: int) -> bool:
    return d not in _HEAD_DIMS


# -- diagnoses: copy of mpi_tpu/tpu/pallas_attention.py:955-989 ----------------


def _check_blocks(q_shape, k_shape, v_shape, q_dtype, k_dtype,
                  v_dtype) -> Tuple[bool, int, int, int, int]:
    """The reference's diagnoses on one rank's blocks; returns
    (multihead, hq, hkv, sb, d)."""
    q_ndim, k_ndim = len(q_shape), len(k_shape)
    if q_ndim not in (2, 3):
        raise ValueError(
            f"ring attention wants [Sb, dh] or [H, Sb, dh] blocks, got "
            f"q {tuple(q_shape)}")
    if tuple(k_shape) != tuple(v_shape) or \
            tuple(q_shape[-2:]) != tuple(k_shape[-2:]) or q_ndim != k_ndim:
        raise ValueError(
            f"ring attention wants equal [.., rows, d] blocks for q/k/v "
            f"(k/v may differ from q only in the HEAD count), got "
            f"{tuple(q_shape)}/{tuple(k_shape)}/{tuple(v_shape)}")
    if k_dtype != q_dtype or v_dtype != q_dtype:
        raise ValueError(
            f"ring attention wants one dtype for q/k/v (the circulating "
            f"K/V buffer is allocated as q's), got "
            f"{q_dtype}/{k_dtype}/{v_dtype}")
    multihead = q_ndim == 3
    hq = q_shape[0] if multihead else 1
    hkv = k_shape[0] if multihead else 1
    if hkv < 1 or hq % hkv or hkv > hq:
        raise ValueError(
            f"GQA wants Hq a positive multiple of Hkv, got Hq={hq} "
            f"Hkv={hkv}")
    sb, d = q_shape[-2:]
    if q_dtype not in _SUBLANES:
        raise NotImplementedError(
            f"ring attention supports float32/bfloat16 for now, got {q_dtype}")
    if d % _LANES:
        raise NotImplementedError(
            f"head dim must be a multiple of {_LANES} (lane width), got {d}")
    sub = _SUBLANES[q_dtype]
    if sb % sub:
        raise NotImplementedError(
            f"block rows must be a multiple of {sub} ({q_dtype} "
            f"sublane tile), got {sb}")
    return multihead, hq, hkv, sb, d


def _world_blocks(q, k, v):
    """Check a world's blocks; returns 4-D ``[P, H, Sb, d]`` views and
    (multihead, hq, hkv, sb, d)."""
    if q.dim() < 3 or k.dim() != q.dim() or v.dim() != q.dim() or \
            not (q.shape[0] == k.shape[0] == v.shape[0]):
        raise ValueError(
            f"a world of ring-attention blocks needs a leading rank "
            f"dimension shared by q/k/v, got {tuple(q.shape)}/"
            f"{tuple(k.shape)}/{tuple(v.shape)}")
    info = _check_blocks(q.shape[1:], k.shape[1:], v.shape[1:], q.dtype,
                         k.dtype, v.dtype)
    if not info[0]:
        q, k, v = q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1)
    return q, k, v, info


def _default_scale(scale: Optional[float], d: int) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _head_chunk(hq: int, sb: int) -> int:
    return max(1, min(hq, _PLAIN_SCORES // (sb * sb)))


# -- plain versions: the TPU schedule step by step -----------------------------


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a b^T`` over the head dim (Q K^T, dO V^T), summed in float64 and
    rounded to float32 once.  The plain versions are the yardstick of
    kernels that sum these d products in another order; a float32 sum's
    own error grows with d, and at the widest head dims it would take much
    of the float32 allowance of that comparison, so the yardstick's is
    kept at one rounding."""
    return torch.matmul(a.double(), b.double().transpose(-1, -2)).float()


def _fold(q, k, v, m, l, o, scale, mask):
    """One arrival's online-softmax fold for a chunk of heads, all float32
    (copy of ``_online_fold``, pallas_attention.py:116; the scores as
    ``_dots``).  q/k/v/o ``[H, Sb, d]``, m/l ``[H, Sb, 1]``; ``mask``
    ``[Sb, Sb]`` True = attend."""
    s = _dots(q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _MASKED))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    o_new = o * alpha + torch.matmul(p, v)
    return m_new, l_new, o_new


def _diag_mask(sb: int, device) -> torch.Tensor:
    """``_causal_mask`` (pallas_attention.py:134) of the diagonal block:
    key position <= query position.  Past blocks are all-True and future
    blocks are skipped, so only the diagonal needs one."""
    idx = torch.arange(sb, device=device)
    return idx[None, :] <= idx[:, None]


def ring_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         groups: Groups = None, *, scale: Optional[float] = None,
                         causal: bool = False, with_lse: bool = False):
    """Plain version of the forward over a world: q ``[P, Hq, Sb, d]`` (or
    ``[P, Sb, d]``), k/v ``[P, Hkv, Sb, d]``.  Group position r folds arrival
    a = 0..g-1, which carries K/V block (r - a) mod g; under ``causal``
    later blocks are skipped and the diagonal is masked with -1e30.
    Returns out like q (and lse ``[P, Hq, Sb]`` float32)."""
    q4, k4, v4, (multihead, hq, hkv, sb, d) = _world_blocks(q, k, v)
    gl = _group_list(groups, q.shape[0])
    scale = _default_scale(scale, d)
    rep = hq // hkv
    heads = torch.arange(hq, device=q.device) // rep
    mask = _diag_mask(sb, q.device) if causal else None
    out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((q.shape[0], hq, sb), dtype=torch.float32, device=q.device)
    chunk = _head_chunk(hq, sb)
    for grp in gl:
        g = len(grp)
        for r, w in enumerate(grp):
            for h0 in range(0, hq, chunk):
                hs = slice(h0, min(hq, h0 + chunk))
                qf = q4[w, hs].float()
                n = qf.shape[0]
                m = torch.full((n, sb, 1), -math.inf, device=q.device)
                l = torch.zeros((n, sb, 1), device=q.device)
                o = torch.zeros((n, sb, d), device=q.device)
                for a in range(g):
                    j = (r - a) % g
                    if causal and j > r:
                        continue
                    kv_heads = heads[hs]
                    m, l, o = _fold(qf, k4[grp[j]][kv_heads].float(),
                                    v4[grp[j]][kv_heads].float(), m, l, o,
                                    scale, mask if j == r else None)
                out[w, hs] = (o / l).to(q.dtype)
                lse[w, hs] = (m + torch.log(l))[..., 0]
    out = out if multihead else out[:, 0]
    return (out, lse) if with_lse else out


def ring_attention_bwd_plain(q, k, v, out, lse, dout, groups: Groups = None, *,
                             scale: Optional[float] = None,
                             causal: bool = False):
    """Plain version of the backward (``_bwd_kernel``, :617): returns
    (dq, dk, dv) shaped and typed like q, k, v.  ``delta = rowsum(dO·O)``
    in float32 (:1142); dQ accumulates in arrival order; the dK/dV of block
    j accumulate as the block circulates (owner j, then j+1, ..., j+g-1),
    query heads in increasing order within one arrival (``pair_grads``,
    :700-715); all sums in float32 (Q K^T and dO V^T as ``_dots``), cast
    at the end (:1200-1202)."""
    q4, k4, v4, (multihead, hq, hkv, sb, d) = _world_blocks(q, k, v)
    nranks = q.shape[0]
    gl = _group_list(groups, nranks)
    scale = _default_scale(scale, d)
    rep = hq // hkv
    heads = torch.arange(hq, device=q.device) // rep
    o4 = out if multihead else out.unsqueeze(1)
    do4 = dout if multihead else dout.unsqueeze(1)
    lse4 = lse.reshape(nranks, hq, sb, 1)
    delta = (do4.float() * o4.float()).sum(dim=-1, keepdim=True)
    mask = _diag_mask(sb, q.device) if causal else None
    dq = torch.zeros(q4.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k4.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(k4.shape, dtype=torch.float32, device=q.device)
    chunk = _head_chunk(hq, sb)
    for grp in gl:
        g = len(grp)
        for a in range(g):
            for r, w in enumerate(grp):
                j = (r - a) % g
                if causal and j > r:
                    continue
                kw = grp[j]
                for h0 in range(0, hq, chunk):
                    hs = slice(h0, min(hq, h0 + chunk))
                    qh, doh = q4[w, hs].float(), do4[w, hs].float()
                    kb = k4[kw][heads[hs]].float()
                    vb = v4[kw][heads[hs]].float()
                    # _pair_grad_tile (pallas_attention.py:217)
                    s = _dots(qh, kb) * scale
                    p = torch.exp(s - lse4[w, hs])
                    if causal and j == r:
                        p = torch.where(mask, p, torch.zeros_like(p))
                    dp = _dots(doh, vb)
                    ds = p * (dp - delta[w, hs]) * scale
                    dq[w, hs] += torch.matmul(ds, kb)
                    dk_c = torch.matmul(ds.transpose(-1, -2), qh)
                    dv_c = torch.matmul(p.transpose(-1, -2), doh)
                    for i, h in enumerate(range(hs.start, hs.stop)):
                        dk[kw, h // rep] += dk_c[i]
                        dv[kw, h // rep] += dv_c[i]
    dq, dk, dv = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if not multihead:
        dq, dk, dv = dq[:, 0], dk[:, 0], dv[:, 0]
    return dq, dk, dv


# -- the CUDA kernels --------------------------------------------------------------

# the shared-memory plan of each kernel per input dtype (or, where the head
# dims take different forms, per input dtype and head dim): a ``struct`` in
# its source (a ``template <int D>`` one for d in _HEAD_DIMS) whose ``SMEM``
# is the bytes a block uses
_PLANS = {"fwd": ("attention.cu", {torch.bfloat16: "FwdBf16Plan",
                                   torch.float32: "FwdF32Plan"}),
          "bwd_dq": ("attention_bwd.cu", {torch.bfloat16: "DqBf16Plan",
                                          torch.float32: {128: "DqF32Plan", 256: "DqF32UnitPlan"}}),
          "bwd_dkv": ("attention_bwd.cu", {torch.bfloat16: "DkvBf16Plan",
                                           torch.float32: {128: "DkvF32Plan", 256: "DkvF32UnitPlan"}})}
_WIDE_PLANS = {"fwd": ("attention_wide.cu", {torch.bfloat16: "WideFwdBf16Plan",
                                             torch.float32: "WideFwdF32Plan"}),
               "bwd_dq": ("attention_bwd_wide.cu", {torch.bfloat16: "WideDqBf16Plan",
                                                    torch.float32: "WideDqF32Plan"}),
               "bwd_dkv": ("attention_bwd_wide.cu", {torch.bfloat16: "WideDkvBf16Plan",
                                                     torch.float32: "WideDkvF32Plan"})}


def _c_ternary(expr: str) -> str:
    """A C expression's ``c ? a : b`` chains (right-associative) as
    Python conditional expressions."""
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr.strip(), re.S)
    if m is None:
        return expr
    return f"({_c_ternary(m.group(2))} if {m.group(1)} else {_c_ternary(m.group(3))})"


def _plan_consts(source: str, plan: str, d: int) -> Dict[str, int]:
    """The ``static constexpr int`` members of ``struct <plan>`` in
    ``csrc/<source>`` at D = ``d``, evaluated in order, so the sources stay
    the one place the plans are written."""
    from .. import _build

    text = (_build.SRC_DIR / source).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % plan, text, re.S).group(1)
    env = {"D": d}
    for decl in re.findall(r"static constexpr int ([^;]+);", body):
        for item in decl.split(","):
            name, expr = (part.strip() for part in item.split("=", 1))
            env[name] = eval(_c_ternary(expr).replace("/", "//"),
                             {"__builtins__": {}}, env)
    return env


@functools.lru_cache(maxsize=None)
def _plan_smem(source: str, plan: str, d: int) -> int:
    """``SMEM`` of ``struct <plan>`` in ``csrc/<source>`` at D = ``d``."""
    return _plan_consts(source, plan, d)["SMEM"]


@functools.lru_cache(maxsize=None)
def wide_cluster(d: int) -> Tuple[int, int]:
    """(C, m) of the forward and the backward above d = 256 (``WideCluster``
    in csrc/ring_attention.cuh): clusters of C blocks, the
    largest divisor of d / 128 that is at most 8, each block taking m =
    d / 128 / C passes over its walk, one output chunk a pass."""
    consts = _plan_consts("ring_attention.cuh", "WideCluster", d)
    return consts["C"], consts["M"]


def kernel_smem_bytes(d: int, dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """Shared memory per block of each kernel at head dim ``d``, from the
    plans in the sources.  For d in ``_HEAD_DIMS``: bf16 tiles are in the
    128-byte swizzle after 1 KB of alignment: the forward
    (csrc/attention.cu ``FwdBf16Plan``) holds its 128-row Q tile and NS
    one-tile stages of K or V tiles (128 rows at d = 128, 64 at 256); the
    backward (csrc/attention_bwd.cu
    ``DqBf16Plan``, ``DkvBf16Plan``) its two resident tiles (128-row Q and
    dO; K and V, 128 rows at d = 128, 64 at 256), NS stages of its two
    streamed tiles (dK/dV with their lse and delta rows) and, for dK/dV at
    d = 256, P of two tile parities.  The float32 forward (``FwdF32Plan``)
    holds 64 W Q rows and two stages of 32-row K and V tiles, in rows of
    stride d + 4.  The float32 backward holds its tiles in the 128-byte
    swizzle after 1 KB of alignment: two resident 64-row tiles (Q and dO; K
    and V) and its output products' B tiles (64 x 32, hi then lo: dQ's dS
    of two tile parities, P handed over in them; dK/dV's P and dS); at
    d = 128 (``DqF32Plan``, ``DkvF32Plan``) two stages of two streamed
    32-row tiles, each 32-column block's raw rows followed by their lo rows
    (dK/dV with their lse and delta rows); at d = 256 (``DqF32UnitPlan``,
    ``DkvF32UnitPlan``) a ring of four 16 KB units, a unit one streamed
    operand's 32 rows by 64 columns with their lo rows (forming S and dP)
    or by 128 columns raw (an output's A), dK/dV with a unit's lse or delta
    rows.
    Above, the forward (csrc/attention_wide.cu) and the backward
    (csrc/attention_bwd_wide.cu) run in clusters: the bf16 forward
    (``WideFwdBf16Plan``) holds its own 64 x 128 Q chunk, two stages of a K
    chunk and a V (or Q) chunk, and two parities of the S partial its
    cluster sums; the float32 forms (``WideFwdF32Plan``, ``WideDqF32Plan``,
    ``WideDkvF32Plan``) one 128-column chunk of their own 64-row tiles, two
    stages of two streamed 32-row tiles and their lo tiles, two parities of
    the partials, and their output products' B tiles; the bf16 backward
    (``WideDqBf16Plan``, ``WideDkvBf16Plan``) the same regions in bf16 with
    64-row streamed tiles and no lo tiles, its partials 64 x 64, and its
    output products' A tiles (P and dS as hi, mid and lo).  No plan's bytes
    depend on d."""
    plans = _WIDE_PLANS if _wide(d) else _PLANS
    return {name: _plan_smem(src, _plan_name(names[dtype], d), d)
            for name, (src, names) in plans.items()}


def _plan_name(name, d: int) -> str:
    return name[d] if isinstance(name, dict) else name


def _kernel_plan(d: int, dtype: torch.dtype = torch.float32) -> None:
    """Raise where a kernel's block at head dim ``d`` would need more shared
    memory than a block may use, with the arithmetic (the plans in the
    sources; none does at any d)."""
    for name, need in kernel_smem_bytes(d, dtype).items():
        if need > _SMEM_LIMIT:
            source = (_WIDE_PLANS if _wide(d) else _PLANS)[name][0]
            raise NotImplementedError(
                f"the ring-attention {name} kernel (csrc/{source}) at head "
                f"dim {d}, {dtype}, would need {need} bytes of shared "
                f"memory a block, beyond the {_SMEM_LIMIT} bytes a block "
                f"may use")


def _require_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(
                f"ring-attention kernels run on CUDA tensors (CPU tensors "
                f"take the plain version); got a tensor on {t.device}")


# the attention sources' own refusals (csrc/ring_attention.cuh kBadShape,
# kNoCluster, kNoEncoder, kBadMap)
_REFUSALS = {
    1000: "a head dim or dtype the kernels were not built for",
    1001: "the cluster launch was refused: cudaOccupancyMaxActiveClusters "
          "finds no room on the card for one cluster of the plan's blocks",
    1002: "the CUDA driver's cuTensorMapEncodeTiled was not found",
    1003: "cuTensorMapEncodeTiled refused an operand's tensor map",
}


def _raise_on(err: int, name: str) -> None:
    if err:
        why = _REFUSALS.get(err, f"CUDA error {err}")
        raise RuntimeError(
            f"ring attention {name} kernel launch failed: {why}"
            + (f" (code {err})" if err in _REFUSALS else ""))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels stage
    16-byte chunks); a copy only where a view starts elsewhere."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _geometry(q4, k4, groups, size, d):
    return (len(groups) // size, size, q4.shape[1], k4.shape[1], q4.shape[2], d)


# Each C entry point of csrc/attention.cu and csrc/attention_bwd.cu is a
# world-level ``torch.library`` op on 4-D ``[P, H, Sb, d]`` operands
# (``mpi_tpu_torch::attn_fwd``, ``::attn_bwd_dq``, ``::attn_bwd_dkv``), whose
# CUDA implementation launches the kernel for its head dim (the ``_wide``
# entry point of the wide source above d = 256) and counts the launch; its fake
# implementation only states the outputs, so a trace on fake CUDA tensors
# records each launch as one graph node and never builds or launches.


def _lse_shape(q4: torch.Tensor) -> Tuple[int, int, int]:
    return tuple(q4.shape[:3])


@torch.library.custom_op("mpi_tpu_torch::attn_fwd", mutates_args=(),
                         device_types="cuda")
def attn_fwd(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
             groups: List[int], size: int, scale: float,
             causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attn_fwd`` of csrc/attention.cu (``attn_fwd_wide`` of
    csrc/attention_wide.cu above d = 256): (out like q4, lse ``[P, Hq, Sb]``
    float32) for each group of ``size`` consecutive entries of ``groups``."""
    return _launch_fwd(q4, k4, v4, groups, size, scale, causal)


def _launch_fwd(q4, k4, v4, groups, size, scale, causal):
    from .. import _build

    q4, k4, v4 = _aligned(q4), _aligned(k4), _aligned(v4)
    out = torch.empty_like(q4)
    lse = torch.empty(_lse_shape(q4), dtype=torch.float32, device=q4.device)
    wide = _wide(q4.shape[3])
    fn = (_build.load("attention_wide").attn_fwd_wide if wide
          else _build.load("attention").attn_fwd)
    table = _group_table(_split(groups, size), q4.device)
    with torch.cuda.device(q4.device):
        err = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), table.data_ptr(),
                 *_geometry(q4, k4, groups, size, q4.shape[3]), scale,
                 int(causal), _DTYPE_CODE[q4.dtype], _stream(q4))
    _raise_on(err, "forward")
    (WIDE_LAUNCHES if wide else LAUNCHES)["fwd"] += 1
    return out, lse


@attn_fwd.register_fake
def _(q4, k4, v4, groups, size, scale, causal):
    return (torch.empty_like(q4, memory_format=torch.contiguous_format),
            q4.new_empty(_lse_shape(q4), dtype=torch.float32))


def _launch_bwd(name: str, q4, k4, v4, dout4, lse, delta, groups, size, scale,
                causal, outs) -> None:
    from .. import _build

    wide = _wide(q4.shape[3])
    lib = _build.load("attention_bwd_wide" if wide else "attention_bwd")
    q4, k4, v4, dout4, lse = (_aligned(t) for t in (q4, k4, v4, dout4, lse))
    fn = getattr(lib, f"attn_{name}_wide" if wide else f"attn_{name}")
    table = _group_table(_split(groups, size), q4.device)
    with torch.cuda.device(q4.device):
        err = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), dout4.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
                 table.data_ptr(), *_geometry(q4, k4, groups, size, q4.shape[3]),
                 scale, int(causal), _DTYPE_CODE[q4.dtype], _stream(q4))
    _raise_on(err, name)
    (WIDE_LAUNCHES if wide else LAUNCHES)[name] += 1


@torch.library.custom_op("mpi_tpu_torch::attn_bwd_dq", mutates_args=(),
                         device_types="cuda")
def attn_bwd_dq(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
                dout4: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                groups: List[int], size: int, scale: float,
                causal: bool) -> torch.Tensor:
    """``attn_bwd_dq`` of csrc/attention_bwd.cu (``attn_bwd_dq_wide`` of
    csrc/attention_bwd_wide.cu above d = 256): dq like q4."""
    dq = torch.empty(q4.shape, dtype=q4.dtype, device=q4.device)
    _launch_bwd("bwd_dq", q4, k4, v4, dout4, lse, delta, groups, size, scale,
                causal, (dq,))
    return dq


@attn_bwd_dq.register_fake
def _(q4, k4, v4, dout4, lse, delta, groups, size, scale, causal):
    return q4.new_empty(q4.shape)


@torch.library.custom_op("mpi_tpu_torch::attn_bwd_dkv", mutates_args=(),
                         device_types="cuda")
def attn_bwd_dkv(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
                 dout4: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 groups: List[int], size: int, scale: float,
                 causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attn_bwd_dkv`` of csrc/attention_bwd.cu (``attn_bwd_dkv_wide``
    above d = 256): (dk, dv) like k4."""
    dk, dv = (torch.empty(k4.shape, dtype=k4.dtype, device=k4.device)
              for _ in range(2))
    _launch_bwd("bwd_dkv", q4, k4, v4, dout4, lse, delta, groups, size, scale,
                causal, (dk, dv))
    return dk, dv


@attn_bwd_dkv.register_fake
def _(q4, k4, v4, dout4, lse, delta, groups, size, scale, causal):
    return k4.new_empty(k4.shape), k4.new_empty(k4.shape)


def ring_attention_world(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         groups: Groups = None, *, scale: Optional[float] = None,
                         causal: bool = False, with_lse: bool = False):
    """Ring attention over a world (shapes as ``ring_attention_plain``):
    the ``attn_fwd`` kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return ring_attention_plain(q, k, v, groups, scale=scale,
                                    causal=causal, with_lse=with_lse)
    _require_cuda(q, k, v)
    q4, k4, v4, (multihead, hq, hkv, sb, d) = _world_blocks(q, k, v)
    _kernel_plan(d, q.dtype)
    gl = _group_list(groups, q.shape[0])
    out, lse = attn_fwd(q4, k4, v4, [w for g in gl for w in g], len(gl[0]),
                        _default_scale(scale, d), bool(causal))
    out = out if multihead else out[:, 0]
    return (out, lse) if with_lse else out


def ring_attention_bwd_world(q, k, v, out, lse, dout, groups: Groups = None, *,
                             scale: Optional[float] = None, causal: bool = False):
    """The backward over a world: ``attn_bwd_dq`` and ``attn_bwd_dkv`` on
    CUDA (``delta`` is a torch op before them, as the reference computes it
    outside its kernel), the plain version on the CPU."""
    if q.device.type == "cpu":
        return ring_attention_bwd_plain(q, k, v, out, lse, dout, groups,
                                        scale=scale, causal=causal)
    ops = bwd_operands(q, k, v, out, lse, dout, groups, scale=scale,
                       causal=causal)
    dq, = launch_bwd("bwd_dq", ops)
    dk, dv = launch_bwd("bwd_dkv", ops)
    if not ops["multihead"]:
        dq, dk, dv = dq[:, 0], dk[:, 0], dv[:, 0]
    return dq, dk, dv


_BWD_ARGS = ("q", "k", "v", "dout", "lse", "delta", "groups", "size", "scale",
             "causal")


def bwd_operands(q, k, v, out, lse, dout, groups: Groups = None, *,
                 scale: Optional[float] = None, causal: bool = False) -> dict:
    """Check and lay out the backward kernels' operands on the card,
    ``delta = rowsum(dO·O)`` included (what ``launch_bwd`` takes, so that
    each kernel can also be timed alone)."""
    _require_cuda(q, k, v, out, lse, dout)
    q4, k4, v4, (multihead, hq, hkv, sb, d) = _world_blocks(q, k, v)
    _kernel_plan(d, q.dtype)
    nranks = q.shape[0]
    gl = _group_list(groups, nranks)
    do4 = (dout if multihead else dout.unsqueeze(1)).to(q.dtype)
    o4 = out if multihead else out.unsqueeze(1)
    return {
        "q": q4, "k": k4, "v": v4, "dout": do4,
        "lse": lse.reshape(nranks, hq, sb).float(),
        "delta": (do4.float() * o4.float()).sum(dim=-1).contiguous(),
        "groups": [w for g in gl for w in g], "size": len(gl[0]),
        "scale": _default_scale(scale, d), "causal": bool(causal),
        "multihead": multihead}


def launch_bwd(name: str, ops: dict) -> Tuple[torch.Tensor, ...]:
    """Launch ``attn_bwd_dq`` (``name="bwd_dq"``, returns (dq,)) or
    ``attn_bwd_dkv`` (``"bwd_dkv"``, returns (dk, dv)) on ``bwd_operands``."""
    args = [ops[a] for a in _BWD_ARGS]
    if name == "bwd_dq":
        return (attn_bwd_dq(*args),)
    return tuple(attn_bwd_dkv(*args))


# -- per-rank entry point (inside run_spmd) -----------------------------------------


def _split(flat: Sequence[int], size: int) -> List[List[int]]:
    return [list(flat[i:i + size]) for i in range(0, len(flat), size)]


class _RingAttentionBwd(torch.autograd.Function):
    """The backward as a world-level op: its ``vmap`` rule sees every
    rank's cotangent and launches the backward kernels."""

    @staticmethod
    def forward(q, k, v, out, lse, dout, rank, groups, size, scale, causal):
        raise primitives._outside("ring_attention backward")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "ring attention has no second derivative (neither has the "
            "reference's custom_vjp)")

    @staticmethod
    @primitives.spanning
    def vmap(info, in_dims, q, k, v, out, lse, dout, rank, groups, size,
             scale, causal):
        n = info.batch_size
        world = [primitives.as_world(t, dim, n)
                 for t, dim in zip((q, k, v, out, lse, dout), in_dims)]
        grads = ring_attention_bwd_world(*world, _split(groups, size),
                                         scale=scale, causal=causal)
        return grads, (0, 0, 0)


class _RingAttention(torch.autograd.Function):
    """The forward as a world-level op; it keeps (q, k, v, out, lse) for
    the backward, as the reference's ``_fwd`` (:1220)."""

    @staticmethod
    def forward(q, k, v, rank, groups, size, scale, causal):
        raise primitives._outside("ring_attention")

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, rank, groups, size, scale, causal = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse, rank)
        ctx.config = (groups, size, scale, causal)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, rank = ctx.saved_tensors
        dq, dk, dv = _RingAttentionBwd.apply(q, k, v, out, lse, dout, rank,
                                             *ctx.config)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    @primitives.spanning
    def vmap(info, in_dims, q, k, v, rank, groups, size, scale, causal):
        n = info.batch_size
        world = [primitives.as_world(t, dim, n)
                 for t, dim in zip((q, k, v), in_dims)]
        out, lse = ring_attention_world(*world, _split(groups, size),
                                        scale=scale, causal=causal,
                                        with_lse=True)
        return (out, lse), (0, 0)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm, *,
                   scale: Optional[float] = None,
                   causal: bool = False) -> torch.Tensor:
    """Exact attention (full, or causal by global position) over the
    sequence sharded on ``comm``'s ring; call inside ``mpi_tpu_torch.run``.

    ``q`` is this rank's ``[Sb, d]`` block or ``[Hq, Sb, d]`` heads, ``k``/``v``
    ``[Hkv, Sb, d]`` with ``Hq % Hkv == 0`` (query head h attends K/V head
    ``h // (Hq // Hkv)``); the global sequence is the blocks in group-rank
    order.  A split communicator runs one ring per group; ``size == 1``
    is local attention.  Differentiable under ``torch.func`` and autograd:
    the backward is the fused ring backward.  Returns this rank's output,
    shaped and typed like ``q``."""
    _, _, _, _, d = _check_blocks(q.shape, k.shape, v.shape, q.dtype,
                                  k.dtype, v.dtype)
    w = comm._world("ring_attention")
    out, _ = _RingAttention.apply(
        primitives.as_tensor(q), primitives.as_tensor(k),
        primitives.as_tensor(v), w.idx, list(comm._flat_groups), comm.size,
        _default_scale(scale, d), bool(causal))
    return out
