"""The protocol model on the port: ``tests/test_pallas_protocol.py`` run
unchanged on ``mpi_tpu_torch.gpu.ring_model``, and the model's fold order
held against the port's K1.

The reference file is loaded and its imports of ``mpi_tpu.tpu.ring_model``
(at the top and inside test functions) are rewritten to the port's module;
nothing else changes: the same schedules, seeds, ``max_states`` and
assertions.  ``EXCLUDED`` lists the cases left out, each with its reason
(none: the model is the standard library only and runs whole), and
``test_every_case_is_held_or_excluded`` checks that every reference test
function is collected or excluded, so a case added to the reference file
must be accounted for.  The rewrite is local to this file: the shared
one of ``tests/test_torch_host_ref.py`` keeps ``mpi_tpu.tpu.*`` imports
as the reference's (the SPMD backend), and stays so.

``test_model_fold_order_is_the_ports_k1`` ties the spec to the kernel: it
folds float32 inputs, whose sums depend on the order of the additions, in
the order the model's ``_send_chunk`` / ``_accum_chunk`` give for each
device, step and flow, and requires the result bitwise equal to
``gpu/ring.py``'s plain allreduce (rot 0) and reduce_scatter (rot -1),
which ``chip_smoke.py`` holds the CUDA kernel against bitwise.
"""

import pathlib
import re
import types

import numpy as np
import pytest
import torch

from mpi_tpu_torch.gpu import ring, ring_model
from mpi_tpu_torch.gpu.ring_model import _accum_chunk, _send_chunk

TESTS = pathlib.Path(__file__).resolve().parent
REFERENCE = "test_pallas_protocol"
EXCLUDED = {}

_IMPORT = re.compile(r"^([ \t]*from )mpi_tpu\.tpu\.ring_model( import)", re.M)


def rewrite(src: str) -> str:
    """The reference test source with its model imports on the port."""
    return _IMPORT.sub(r"\1mpi_tpu_torch.gpu.ring_model\2", src)


def load() -> types.ModuleType:
    """``tests/test_pallas_protocol.py`` rewritten onto the port's model."""
    path = TESTS / f"{REFERENCE}.py"
    mod = types.ModuleType(f"tests._port_{REFERENCE}")
    mod.__file__ = str(path)
    exec(compile(rewrite(path.read_text()), f"<port of tests/{REFERENCE}.py>",
                 "exec"), mod.__dict__)
    return mod


def _reference_tests(mod: types.ModuleType):
    return [k for k, v in vars(mod).items()
            if k.startswith("test_") and callable(v)]


_PORTED = load()
globals().update({k: getattr(_PORTED, k) for k in _reference_tests(_PORTED)
                  if k not in EXCLUDED})


def test_every_case_is_held_or_excluded():
    ref = load()
    names = _reference_tests(ref)
    assert names
    for k in names:
        held = k in globals() and globals()[k].__module__ == ref.__name__
        assert held != bool(EXCLUDED.get(k, "")), (k, "held" if held else "unaccounted")
    assert set(EXCLUDED) <= set(names)


def test_the_cases_run_on_the_ports_model():
    src = (TESTS / f"{REFERENCE}.py").read_text()
    out = rewrite(src)
    assert "mpi_tpu.tpu" not in "".join(
        line for line in out.splitlines() if "import" in line)
    assert out.count("mpi_tpu_torch.gpu.ring_model import") == \
        src.count("mpi_tpu.tpu.ring_model import") > 1
    assert _PORTED.RingSim is ring_model.RingSim
    assert _PORTED.explore_all is ring_model.explore_all


# -- the model's fold order is the port's K1 ----------------------------------

TILE_ROWS = 8                   # one float32 tile: 8 rows of 128 lanes
DIRS = (1, -1)                  # two tiles a chunk: one flow each way


def _spread(rng: np.random.RandomState, shape) -> np.ndarray:
    """Random signs and magnitudes from 1e-4 to 1e8: the fold order shows."""
    mag = np.power(10.0, rng.uniform(-4, 8, size=shape))
    return (rng.standard_normal(shape) * mag).astype(np.float32)


def _model_fold(x: np.ndarray, rot: int, allgather: bool) -> np.ndarray:
    """``x`` = ``[P devices, P chunks, flows, rows, lanes]`` after the
    model's steps: at step u every device sends chunk ``_send_chunk`` of
    each flow to its downstream neighbour, which folds it into chunk
    ``_accum_chunk`` as own + received in the reduce-scatter half and
    stores it in the allgather half."""
    P = x.shape[0]
    buf = x.copy()
    n_rs = P - 1
    for u in range(n_rs + (P - 1 if allgather else 0)):
        for f, dirn in enumerate(DIRS):
            sent = [buf[d, _send_chunk(d, u, P, rot, dirn), f].copy()
                    for d in range(P)]
            for d in range(P):
                src = (d - dirn) % P       # the upstream writer of this flow
                c = _accum_chunk(d, u, P, rot, dirn)
                assert _send_chunk(src, u, P, rot, dirn) == c
                buf[d, c, f] = buf[d, c, f] + sent[src] if u < n_rs else sent[src]
    return buf


@pytest.mark.parametrize("rot", [0, -1], ids=["allreduce", "reduce_scatter"])
@pytest.mark.parametrize("P", [2, 3, 4, 8])
def test_model_fold_order_is_the_ports_k1(P, rot):
    """The model's order of folds, run on float32 data, is bitwise the
    port's plain allreduce (rot 0: both halves) and reduce_scatter (rot -1:
    the first half, rank r keeping chunk r), each chunk split into a
    right-going and a left-going tile as ``gpu/ring.py:_flows`` splits it.
    For P >= 3 the rank-order sum differs, so the order is what agrees."""
    x = _spread(np.random.RandomState(100 + P), (P, P, len(DIRS), TILE_ROWS, 128))
    world = torch.from_numpy(x)
    assert ring._flows(len(DIRS), True) == [(1, 0, 1), (-1, 1, 1)]
    if rot == 0:
        want = _model_fold(x, rot, allgather=True).reshape(P, -1)
        got = ring.allreduce_plain(world.reshape(P, -1), tile_rows=TILE_ROWS)
    else:
        fold = _model_fold(x, rot, allgather=False)
        want = np.stack([fold[d, d] for d in range(P)]).reshape(P, -1)
        got = ring.reduce_scatter_plain(world.reshape(P, P, -1), tile_rows=TILE_ROWS)
    assert np.array_equal(got.numpy(), want)
    in_rank_order = x[0]
    for r in range(1, P):
        in_rank_order = in_rank_order + x[r]
    in_rank_order = (np.broadcast_to(in_rank_order, x.shape).reshape(P, -1) if rot == 0
                     else np.stack([in_rank_order[d] for d in range(P)]).reshape(P, -1))
    assert np.array_equal(in_rank_order, want) == (P == 2)
