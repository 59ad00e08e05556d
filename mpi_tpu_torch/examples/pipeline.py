"""Pipeline parallelism: GPipe-style microbatch streaming over shift() —
counterpart of ``examples/pipeline.py``.

Rank r holds stage r of a P-layer network; microbatches enter at rank 0
and flow down the pipeline with one non-wrapping ``shift`` per tick (one
ppermute).  The GPipe fill-and-drain schedule: M microbatches complete in
M + P − 1 ticks, each tick being [receive activations | apply my stage |
pass along] — a static schedule, so the whole pipeline is one SPMD
program.

    python -m mpi_tpu_torch.examples.pipeline -n 8               # CUDA
    python -m mpi_tpu_torch.examples.pipeline -n 8 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import mpi_tpu_torch


def _stage(x, w, b):
    return torch.tanh(x @ w + b)


def pipeline_forward(comm, micro_x, w, b):
    """Run M microbatches through a P-stage pipeline.

    micro_x: [M, B, D] — the input stream (only rank 0's is fed in).
    w: [D, D], b: [D] — THIS rank's stage parameters.  Returns [M, B, D]:
    the final outputs, valid on the LAST rank (zeros elsewhere — SPMD
    produces a value on every rank)."""
    P, rank = comm.size, comm.rank
    M, B, D = micro_x.shape
    is_first = rank == 0
    is_last = rank == P - 1

    zeros = micro_x.new_zeros((B, D))
    carry = zeros  # activation moving through me
    # the reference's outs.at[mb].set(...), out of place: one entry per
    # microbatch, stacked at the end
    outs = [zeros] * M
    for tick in range(M + P - 1):
        # feed: rank 0 injects microbatch `tick` (if any) — every other
        # rank takes what arrived from upstream last tick
        feed = micro_x[tick] if tick < M else zeros
        x_in = torch.where(is_first, feed, carry)
        y = _stage(x_in, w, b)
        # a stage only holds valid data for ticks in [rank, rank + M)
        valid = (tick >= rank) & (tick < rank + M)
        y = torch.where(valid, y, 0.0)
        # drain: the last stage records its finished microbatch
        mb = tick - (P - 1)
        if 0 <= mb < M:
            outs[mb] = torch.where(is_last, y, outs[mb])
        # pass along: one ppermute hop down the pipeline
        carry = comm.shift(y, offset=1, wrap=False, fill=0.0)
    return torch.stack(outs)


def pipeline_oracle(micro_x, ws, bs):
    """Serial reference in numpy (float64): all P stages on each
    microbatch.  micro_x [M, B, D]; ws [P, D, D]; bs [P, D]."""
    out = []
    for m in range(micro_x.shape[0]):
        x = np.asarray(micro_x[m], np.float64)
        for w, b in zip(ws, bs):
            x = np.tanh(x @ np.asarray(w, np.float64) + np.asarray(b, np.float64))
        out.append(x)
    return np.stack(out)


def pipeline_inputs(comm, micro: int = 6, batch: int = 4, d: int = 8):
    """This rank's (micro_x, w, b), drawn from its own generator
    (``rank_normal``; the reference draws with ``jax.random``, so the
    values differ from it): the stream is rank 0's draw that feeds the
    pipeline."""
    micro_x = mpi_tpu_torch.rank_normal((micro, batch, d), 999)
    w = mpi_tpu_torch.rank_normal((d, d), 7) * 0.5
    b = mpi_tpu_torch.rank_normal((d,), 107) * 0.1
    return micro_x, w, b


def pipeline_program(comm, micro: int = 6, batch: int = 4, d: int = 8):
    return pipeline_forward(comm, *pipeline_inputs(comm, micro, batch, d))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--nranks", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--micro", type=int, default=6)
    args = ap.parse_args()
    out = mpi_tpu_torch.run(pipeline_program, nranks=args.nranks,
                            device=args.device, micro=args.micro)
    last = out[-1]
    print(f"pipeline OK: outputs {tuple(last.shape)} on the last stage, "
          f"|out| = {float(last.abs().mean()):.4f}")


if __name__ == "__main__":
    main()
