"""``tests/test_segmented_collectives2.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_alltoall_zero_pickled_bytes``: numpy blocks ride the port's
  pickle path (its raw frames carry tensors: transport/codec.py
  raw_eligible), so the pickled-byte count differs while the values are
  the reference's; the same program with tensor blocks is held below
  (test_alltoall_zero_pickled_bytes_tensor_blocks).
* ``test_scatter_gather_scan_zero_pickled_array_bytes``: numpy parts ride
  the port's pickle path, as above; the same program with tensor parts is
  held below (test_scatter_gather_scan_zero_pickled_tensor_bytes).
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_alltoall_zero_pickled_bytes': (
        "numpy blocks ride the port's pickle path (its raw frames carry "
        'tensors: transport/codec.py raw_eligible), so the pickled-byte '
        "count differs while the values are the reference's; the same "
        'program with tensor blocks is held below '
        '(test_alltoall_zero_pickled_bytes_tensor_blocks)'
    ),
    'test_scatter_gather_scan_zero_pickled_array_bytes': (
        "numpy parts ride the port's pickle path, as above; the same "
        'program with tensor parts is held below '
        '(test_scatter_gather_scan_zero_pickled_tensor_bytes)'
    ),
}

globals().update(port_cases("test_segmented_collectives2", EXCLUDED))


# -- the excluded byte-plane cases with tensor payloads ----------------------

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mpi_tpu_torch import mpit  # noqa: E402
from tests.test_torch_host_ref import _run_shm_world, _run_socket_world  # noqa: E402

_WORLDS = {"shm": _run_shm_world, "socket": _run_socket_world}


def _deltas(world, prog, n):
    names = ("bytes_pickled_sent", "bytes_raw_sent", "payload_copies")
    before = [mpit.pvar_read(k) for k in names]
    assert all(world(prog, n))
    return [mpit.pvar_read(k) - b for k, b in zip(names, before)]


@pytest.mark.parametrize("transport", sorted(_WORLDS))
def test_alltoall_zero_pickled_bytes_tensor_blocks(transport):
    """``test_alltoall_zero_pickled_bytes`` with the same seeded blocks as
    tensors: every wire byte raw, no host payload copy, values exact."""
    n, nelem = 4, 1 << 14

    def prog(comm):
        blocks = list(torch.from_numpy(np.random.RandomState(comm.rank).randn(n, nelem)))
        got = comm.alltoall(blocks, algorithm="pairwise")
        for s in range(n):
            np.testing.assert_array_equal(
                got[s].numpy(), np.random.RandomState(s).randn(n, nelem)[comm.rank])
        return True

    pickled, raw, copies = _deltas(_WORLDS[transport], prog, n)
    assert pickled == 0 and copies == 0
    assert raw >= n * (n - 1) * nelem * 8


@pytest.mark.parametrize("transport", sorted(_WORLDS))
def test_scatter_gather_scan_zero_pickled_tensor_bytes(transport):
    """``test_scatter_gather_scan_zero_pickled_array_bytes`` with tensor
    parts: scatter's fan-out, the doubling scan and gather's fan-in ride
    raw frames; the scan within float64 rtol 1e-7 of numpy's sum (its
    own tolerance), the rest exact."""
    n, nelem = 4, 1 << 15

    def prog(comm):
        parts = np.random.RandomState(0).randn(n, nelem)
        mine = comm.scatter(list(torch.from_numpy(parts)) if comm.rank == 0
                            else None, root=0)
        np.testing.assert_array_equal(mine.numpy(), parts[comm.rank])
        sc = comm.scan(mine, algorithm="doubling")
        np.testing.assert_allclose(sc.numpy(), parts[:comm.rank + 1].sum(0))
        back = comm.gather(mine, root=0)
        if comm.rank == 0:
            np.testing.assert_array_equal(np.asarray(back), parts)
        return True

    pickled, raw, copies = _deltas(_WORLDS[transport], prog, n)
    assert pickled == 0 and copies == 0
    assert raw >= (2 * (n - 1) + 1) * nelem * 8
