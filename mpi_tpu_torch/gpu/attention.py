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
sources).
No slot, credit, barrier or VMEM plan carries over: ``interpret`` and
``vmem_limit_bytes`` have no counterpart and are dropped, and there is no
fallback.  A head dim the kernels are not built for raises
``NotImplementedError`` with the byte arithmetic of their shared memory.

Three layers:

* ``ring_attention_world`` / ``ring_attention_bwd_world`` take the physical
  ``[P, ...]`` world.  On a CUDA tensor they launch the kernels (and count
  each launch in ``LAUNCHES``) or raise; on a CPU tensor they run the plain
  versions.
* ``ring_attention_plain`` / ``ring_attention_bwd_plain``: the TPU schedule
  step by step in torch ops, all state in float32.
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
# the head dims every kernel is built for (the dispatch of csrc/attention.cu
# and csrc/attention_bwd.cu)
_HEAD_DIMS = (128, 256)
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
# score-block elements per plain-version step: bounds its peak memory
_PLAIN_SCORES = 1 << 26

# kernel launches per entry point: a wrapper adds one exactly where it launches
LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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


def _fold(q, k, v, m, l, o, scale, mask):
    """One arrival's online-softmax fold for a chunk of heads, all float32
    (copy of ``_online_fold``, pallas_attention.py:116).  q/k/v/o
    ``[H, Sb, d]``, m/l ``[H, Sb, 1]``; ``mask`` ``[Sb, Sb]`` True = attend."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
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
    :700-715); all sums in float32, cast at the end (:1200-1202)."""
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
                    s = torch.matmul(qh, kb.transpose(-1, -2)) * scale
                    p = torch.exp(s - lse4[w, hs])
                    if causal and j == r:
                        p = torch.where(mask, p, torch.zeros_like(p))
                    dp = torch.matmul(doh, vb.transpose(-1, -2))
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

# the shared-memory plan of each kernel per input dtype: a ``template <int D>
# struct`` in its source whose ``SMEM`` is the bytes a block uses
_PLANS = {"fwd": ("attention.cu", {torch.bfloat16: "FwdBf16Plan",
                                   torch.float32: "FwdF32Plan"}),
          "bwd": ("attention_bwd.cu", {torch.bfloat16: "Bf16Plan",
                                       torch.float32: "F32Plan"})}


@functools.lru_cache(maxsize=None)
def _plan_smem(source: str, plan: str, d: int) -> int:
    """``SMEM`` of ``struct <plan>`` in ``csrc/<source>`` at D = ``d``: its
    ``static constexpr int`` members evaluated in order (a C ternary
    ``c ? a : b`` becomes Python's), so the sources stay the one place the
    plans are written."""
    from .. import _build

    text = (_build.SRC_DIR / source).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % plan, text, re.S).group(1)
    env = {"D": d}
    for decl in re.findall(r"static constexpr int ([^;]+);", body):
        for item in decl.split(","):
            name, expr = (part.strip() for part in item.split("=", 1))
            expr = re.sub(r"(.+?) \? (.+?) : (.+)", r"(\2 if \1 else \3)", expr)
            env[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, env)
    return env["SMEM"]


def kernel_smem_bytes(d: int, dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """Shared memory per block of each kernel at head dim ``d``, from the
    plans in the sources.  bf16 tiles are 64 x d in the 128-byte swizzle
    after 1 KB of alignment: the forward (csrc/attention.cu
    ``FwdBf16Plan``) holds W resident Q tiles, two stages of K and three of
    V; the backward (csrc/attention_bwd.cu ``Bf16Plan``, both kernels
    alike) two resident tiles, two stages of two streamed ones and 1 KB of
    lse/delta rows.  float32 tiles have a row stride of d + 4: the forward
    (``FwdF32Plan``) holds 64 W Q rows and two stages of 32-row K and V
    tiles, the backward (``F32Plan``) two resident 64-row and two streamed
    32-row tiles and 256 bytes of lse/delta rows."""
    fwd, bwd = (_plan_smem(src, plans[dtype], d) for src, plans in _PLANS.values())
    return {"fwd": fwd, "bwd_dq": bwd, "bwd_dkv": bwd}


def _kernel_plan(d: int) -> None:
    """The kernels are compiled for the head dims ``_HEAD_DIMS``; any other
    head dim raises, with the shared memory their largest block (the
    float32 backward) would need there."""
    if d not in _HEAD_DIMS:
        need = kernel_smem_bytes(d)["bwd_dkv"]
        verdict = "within" if need <= _SMEM_LIMIT else "beyond"
        raise NotImplementedError(
            f"the ring-attention kernels are compiled for head dims "
            f"{list(_HEAD_DIMS)}, got {d}: the float32 backward block "
            f"(F32Plan in csrc/attention_bwd.cu) would need {need} bytes "
            f"of shared memory, {verdict} the {_SMEM_LIMIT} bytes a "
            f"block may use")


def _require_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(
                f"ring-attention kernels run on CUDA tensors (CPU tensors "
                f"take the plain version); got a tensor on {t.device}")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(
            f"ring attention {name} kernel launch failed: CUDA error {err}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels stage
    16-byte chunks); a copy only where a view starts elsewhere."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _geometry(q4, k4, groups, size, d):
    return (len(groups) // size, size, q4.shape[1], k4.shape[1], q4.shape[2], d)


# Each C entry point of csrc/attention.cu and csrc/attention_bwd.cu is a
# world-level ``torch.library`` op on 4-D ``[P, H, Sb, d]`` operands
# (``mpi_tpu_torch::attn_fwd``, ``::attn_bwd_dq``, ``::attn_bwd_dkv``): its
# CUDA implementation launches the kernel and counts the launch; its fake
# implementation only states the outputs, so a trace on fake CUDA tensors
# records each launch as one graph node and never builds or launches.


def _lse_shape(q4: torch.Tensor) -> Tuple[int, int, int]:
    return tuple(q4.shape[:3])


@torch.library.custom_op("mpi_tpu_torch::attn_fwd", mutates_args=(),
                         device_types="cuda")
def attn_fwd(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
             groups: List[int], size: int, scale: float,
             causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attn_fwd`` of csrc/attention.cu: (out like q4, lse ``[P, Hq, Sb]``
    float32) for each group of ``size`` consecutive entries of ``groups``."""
    from .. import _build

    q4, k4, v4 = _aligned(q4), _aligned(k4), _aligned(v4)
    out = torch.empty_like(q4)
    lse = torch.empty(_lse_shape(q4), dtype=torch.float32, device=q4.device)
    lib = _build.load("attention")
    table = _group_table(_split(groups, size), q4.device)
    with torch.cuda.device(q4.device):
        err = lib.attn_fwd(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), table.data_ptr(),
                           *_geometry(q4, k4, groups, size, q4.shape[3]),
                           scale, int(causal), _DTYPE_CODE[q4.dtype], _stream(q4))
    _raise_on(err, "forward")
    LAUNCHES["fwd"] += 1
    return out, lse


@attn_fwd.register_fake
def _(q4, k4, v4, groups, size, scale, causal):
    return (torch.empty_like(q4, memory_format=torch.contiguous_format),
            q4.new_empty(_lse_shape(q4), dtype=torch.float32))


def _launch_bwd(name: str, q4, k4, v4, dout4, lse, delta, groups, size, scale,
                causal, outs) -> None:
    from .. import _build

    lib = _build.load("attention_bwd")
    q4, k4, v4, dout4, lse = (_aligned(t) for t in (q4, k4, v4, dout4, lse))
    fn = lib.attn_bwd_dq if name == "bwd_dq" else lib.attn_bwd_dkv
    table = _group_table(_split(groups, size), q4.device)
    with torch.cuda.device(q4.device):
        err = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), dout4.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
                 table.data_ptr(), *_geometry(q4, k4, groups, size, q4.shape[3]),
                 scale, int(causal), _DTYPE_CODE[q4.dtype], _stream(q4))
    _raise_on(err, name)
    LAUNCHES[name] += 1


@torch.library.custom_op("mpi_tpu_torch::attn_bwd_dq", mutates_args=(),
                         device_types="cuda")
def attn_bwd_dq(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
                dout4: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                groups: List[int], size: int, scale: float,
                causal: bool) -> torch.Tensor:
    """``attn_bwd_dq`` of csrc/attention_bwd.cu: dq like q4."""
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
    """``attn_bwd_dkv`` of csrc/attention_bwd.cu: (dk, dv) like k4."""
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
    _kernel_plan(d)
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
    _kernel_plan(d)
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
