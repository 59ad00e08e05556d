"""Entry points — counterparts of ``__graft_entry__.py:62-358``.

``entry()`` returns a forward step of the Jacobi halo-exchange workload (one
``jacobi_step`` plus the MAX allreduce of its residual) run as an SPMD
program over ``nranks`` ranks, with the grid split by rows, and an example
argument.  ``f(grid)`` returns ``(new grid, residual)``.

``dryrun_multichip(n)`` runs ONE training step that exercises every
parallelism primitive of the communicator on a 2-D (``dp``, ``mp``) layout
of ``n`` ranks: a tensor-parallel matmul whose fused SUM allreduce over
``mp`` is differentiated (tp), the dp gradient sync by the hand-scheduled
ring (or ``dp_algorithm="pallas_ring"``, the CUDA ring kernel) and by
recursive halving (dp), a rotation plus ring attention over ``mp`` (sp),
``alltoall`` (ep), a non-wrapping shift (pp), a halo built from derived
datatypes, a nonblocking allreduce, an RMA fence epoch and a split
half-group; then a 1-D leg runs ring attention over all ``n`` ranks,
forward and backward, against a dense float64 oracle.  The reference's 2-D
mesh becomes one world of ``dp·mp`` ranks, world rank ``i_dp·mp + i_mp``;
the ``mp`` axis is the split communicator of its rows, ``dp`` of its
columns.  On the card the attention runs the CUDA kernels; on the CPU
(``device="cpu"``) their plain versions.  There is no fallback and no
warning (the reference's 2-D step takes a loud ppermute fallback for its
attention on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from . import aot
from . import datatypes as dtt
from . import ops
from .examples.jacobi import jacobi_step
from .gpu import TorchCommunicator, resolve_device, run_spmd
from .gpu.attention import ring_attention


def entry(nranks: int = 1, device=None):
    dev = resolve_device(device)
    world = TorchCommunicator(nranks)

    def fwd(comm, grid):
        local = grid.reshape(comm.size, -1, grid.shape[-1])[comm.rank]
        new = jacobi_step(comm, local)
        residual = comm.allreduce(torch.max(torch.abs(new - local)), op=ops.MAX)
        return new, residual

    def f(grid: torch.Tensor):
        new, residual = run_spmd(fwd, grid, comm=world, device=dev)
        return new.reshape(grid.shape), residual[0]

    example = torch.zeros((64, 128), dtype=torch.float32, device=dev)
    return f, (example,)


def _split_axes(n_devices: int):
    dp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return dp, n_devices // dp


def _shapes(dp: int, mp: int):
    B, D, H = 4 * dp, 8, 4 * mp  # tiny global shapes
    return (B, D), (B, D), (D, H), (H, D)


def _build_step(dp: int, mp: int, dp_algorithm: str = "ring"):
    """The 2-D training step: ``step(x, y, w1, w2)`` on whole tensors (x, y
    ``[B, D]``, w1 ``[D, H]``, w2 ``[H, D]``) runs one SPMD step on their
    device and returns (w1, w2, loss, aux) laid out as the reference's
    ``out_specs``: the updated weights whole, the loss summed over the dp
    shards (each the mean over its rows) and the replicated aux.  As in
    the reference, the weights take one SGD step (lr 0.1) on that summed
    loss.  Each rank takes its shard by ``comm_dp.rank`` /
    ``comm_mp.rank``; the sizes come from the shapes only.

    ``dp_algorithm`` picks the dp gradient sync of w1: "ring" (the
    ppermute schedule) or "pallas_ring" (the CUDA ring kernel on the card,
    its plain version on the CPU)."""
    rows = [[i * mp + j for j in range(mp)] for i in range(dp)]
    comm_mp = TorchCommunicator.from_groups(rows)
    comm_dp = TorchCommunicator.from_groups([list(c) for c in zip(*rows)])
    # split the tensor-parallel axis into halves (grouped collectives); the
    # colour is a function of the mp index, as the reference's
    comm_mp_half = (comm_mp.split_by(lambda w: (w % mp) // max(1, mp // 2))
                    if mp >= 2 else None)
    world = TorchCommunicator(dp * mp)
    lr = 0.1

    def train_step(comm, x, y, w1, w2):
        dev = comm.device
        xb = x.reshape(dp, -1, x.shape[-1])[comm_dp.rank]    # [B/dp, D]
        yb = y.reshape(dp, -1, y.shape[-1])[comm_dp.rank]
        w1b = w1.reshape(w1.shape[0], mp, -1)[:, comm_mp.rank]  # [D, H/mp]
        w2b = w2.reshape(mp, -1, w2.shape[-1])[comm_mp.rank]    # [H/mp, D]

        def loss_fn(w1, w2):
            h = torch.relu(xb @ w1)
            yhat = comm_mp.allreduce(h @ w2, algorithm="fused")  # tp psum
            return torch.mean((yhat - yb) ** 2), h

        grads, (loss, h) = torch.func.grad_and_value(
            loss_fn, argnums=(0, 1), has_aux=True)(w1b, w2b)
        # w1 and w2 enter replicated over dp, and the reference's
        # varying-axes typing transposes that replication into a sum of
        # their gradients over dp: the same sum, spelled out
        grads = [comm_dp.allreduce(g, algorithm="fused") for g in grads]
        # dp gradient sync: the hand-scheduled ring (or the ring kernel),
        # then recursive halving; replicate is the reference's vma brand
        g1 = comm_dp.replicate(
            comm_dp.allreduce(grads[0], algorithm=dp_algorithm) / dp)
        g2 = comm_dp.replicate(
            comm_dp.allreduce(grads[1], algorithm="recursive_halving") / dp)
        # sp: rotate activations around the mp ring, then ring attention
        # over mp on [8, 128] blocks derived from the activations
        h_rot = comm_mp.shift(h, offset=1, wrap=True)
        att_in = torch.tanh(torch.mean(h)).expand(8, 128)
        att = ring_attention(att_in, att_in, att_in, comm_mp, causal=True)
        # pp-style stage handoff: non-wrapping shift down the mp axis
        h_next = comm_mp.shift(h, offset=1, wrap=False, fill=0.0)
        # ep / Ulysses primitive: all_to_all over the mp axis
        t = torch.zeros((mp, 2), device=dev) + comm_mp.rank.to(torch.float32)
        t = comm_mp.alltoall(t, algorithm="fused")
        # typed halo: pack_torch is one static gather, shift one ppermute,
        # unpack_torch one scatter
        nrows, ncols = xb.shape
        face_src = dtt.type_create_subarray(
            [nrows, ncols], [nrows, 1], [0, ncols - 1], np.float32).commit()
        face_dst = dtt.type_create_subarray(
            [nrows, ncols], [nrows, 1], [0, 0], np.float32).commit()
        halo = comm_mp.shift(face_src.pack_torch(xb), offset=1, wrap=True)
        x_haloed = face_dst.unpack_torch(halo, xb)
        # nonblocking collective spelling
        loss_nb = comm_mp.iallreduce(loss, algorithm="fused").wait()
        # one-sided RMA epoch over the mp axis (put + accumulate + fence)
        win = comm_mp.win_create(torch.zeros(2, device=dev))
        ring_pairs = [(r, (r + 1) % mp) for r in range(mp)]
        win.put(torch.zeros(2, device=dev) + comm_mp.rank, ring_pairs)
        win.accumulate(torch.ones(2, device=dev), ring_pairs)
        win.fence()
        aux = (torch.sum(h_rot) + torch.sum(h_next) + torch.sum(t)
               + torch.sum(win.local) + torch.sum(x_haloed) + loss_nb
               + torch.sum(att))
        if comm_mp_half is not None:
            aux = aux + comm_mp_half.allreduce(loss, algorithm="fused")
        # tree reduce + bcast over dp (hand-scheduled)
        aux = aux + comm_dp.allreduce(loss, algorithm="reduce_bcast")
        # aux mixes rank-varying pieces: reduce it over both axes
        aux = comm_dp.allreduce(comm_mp.allreduce(aux, algorithm="fused"),
                                algorithm="fused")
        loss_sync = comm_dp.allreduce(loss, algorithm="fused")
        return w1b - lr * g1, w2b - lr * g2, loss_sync, aux

    def step(x, y, w1, w2):
        w1n, w2n, loss, aux = run_spmd(train_step, x, y, w1, w2, comm=world,
                                       device=x.device)
        # the reference's out_specs: w1 P(None, "mp"), w2 P("mp", None),
        # loss and aux P() (every rank holds them; dp row 0 is taken)
        w1n = w1n[:mp].permute(1, 0, 2).reshape(w1.shape)
        w2n = w2n[:mp].reshape(w2.shape)
        return w1n, w2n, loss[0], aux[0]

    return step


def lower_multichip(n_devices: int, dp_algorithm: str = "ring", device=None,
                    shapes=None):
    """The whole step for ``n_devices`` ranks (forward, ``torch.func.grad``
    and update) traced on fake tensors for ``device`` (default: the card;
    the counterpart of ``__graft_entry__.py:216 lower_multichip``, an
    ``AbstractMesh`` lowering): a ``torch.fx.GraphModule`` taking (x, y,
    w1, w2) of ``shapes`` (default: the reference's ``_shapes``), made
    without allocating device memory.  For the card, ``pallas_ring``'s dp
    sync and the attention are ``mpi_tpu_torch::ring_fold`` and
    ``::attn_fwd`` nodes (a PyTorch built without CUDA cannot trace the
    step's backward for the card: ``aot.lower`` raises saying so)."""
    dp, mp = _split_axes(n_devices)
    step = _build_step(dp, mp, dp_algorithm)
    return aot.lower(step, *(shapes or _shapes(dp, mp)), device=device)


def export_multichip(n_devices: int, dp_algorithm: str = "pallas_ring",
                     device=None, shapes=None):
    """``torch.export`` of ``lower_multichip`` (the counterpart of
    ``__graft_entry__.py:223 export_multichip_tpu``): an
    ``ExportedProgram`` that round-trips through ``torch.export.save`` /
    ``load``; its ``module()`` runs the step, kernels included."""
    dp, mp = _split_axes(n_devices)
    step = _build_step(dp, mp, dp_algorithm)
    return aot.export(step, *(shapes or _shapes(dp, mp)), device=device)


def _dense_causal_attention(q: np.ndarray) -> np.ndarray:
    """Causal self-attention of ``q`` with itself (q = k = v), float64."""
    s = (q @ q.T) / np.sqrt(q.shape[-1])
    s = np.where(np.tril(np.ones(s.shape, bool)), s, -np.inf)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ q


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One 2-D training step (twice: the second reuses the first one's
    weights) and the 1-D attention leg over ``n_devices`` ranks on
    ``device`` (default: the CUDA card); prints the reference's OK line.
    Raises on a non-finite result or an attention mismatch."""
    dev = resolve_device(device)
    dp, mp = _split_axes(n_devices)
    step = _build_step(dp, mp)
    rng = np.random.RandomState(0)
    sx, sy, s1, s2 = _shapes(dp, mp)

    def draw(shape, scale=1.0):
        return torch.as_tensor((rng.randn(*shape) * scale).astype(np.float32),
                               device=dev)

    x, y, w1, w2 = draw(sx), draw(sy), draw(s1, 0.1), draw(s2, 0.1)
    w1n, w2n, loss, aux = step(x, y, w1, w2)
    for name, v in [("w1", w1n), ("w2", w2n), ("loss", loss), ("aux", aux)]:
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"dryrun produced non-finite {name}")
    step(x, y, w1n, w2n)  # the step takes its own outputs again

    # attention leg: ring attention over a 1-D world of every rank, forward
    # against the dense causal oracle and the fused backward's gradient
    att_leg = "skipped(1dev: size==1 short-circuits to local attention)"
    if n_devices >= 2:
        Sb, dh = 8, 128
        q = draw((n_devices * Sb, dh))

        def att_program(comm, q):
            qb = q.reshape(comm.size, Sb, dh)[comm.rank]
            out = ring_attention(qb, qb, qb, comm, causal=True)
            grad = torch.func.grad(lambda t: torch.sum(
                ring_attention(t, t, t, comm, causal=True) ** 2))(qb)
            return out, grad

        att, gq = run_spmd(att_program, q, nranks=n_devices, device=dev)
        oracle = _dense_causal_attention(q.double().cpu().numpy())
        got = att.reshape(n_devices * Sb, dh).double().cpu().numpy()
        if not np.allclose(got, oracle, rtol=2e-4, atol=2e-4):
            raise RuntimeError("attention leg mismatches the dense oracle")
        if not (bool(torch.isfinite(gq).all()) and float(gq.abs().max()) > 0):
            raise RuntimeError("fused backward produced bad gradients")
        kind = "cuda_kernels" if dev.type == "cuda" else "plain"
        att_leg = f"{kind}({n_devices}dev,causal,fwd+fused_bwd)"

    print(f"dryrun_multichip OK: mesh=({dp}x{mp}) "
          f"loss={float(loss):.4f} attention_leg={att_leg}")
