"""``tests/test_scan_reduce_scatter.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_scan_tpu``: SPMD case (the reference's TPU backend); the port's
  SPMD scan is held by tests/test_torch_communicator.py::test_scan_exscan.
* ``test_reduce_scatter_tpu``: SPMD case (the reference's TPU backend);
  the port's SPMD reduce_scatter is held by
  tests/test_torch_collectives.py::test_ring_reduce_scatter.
* ``test_reduce_scatter_tpu_max_fused``: SPMD case (the reference's TPU
  backend); the port's SPMD reduce_scatter is held by
  tests/test_torch_collectives.py::test_ring_reduce_scatter.
* ``test_reduce_scatter_grouped``: SPMD case (the reference's TPU
  backend); the port's SPMD grouped reduce_scatter is held by
  tests/test_torch_collectives.py::test_ring_reduce_scatter.
* ``test_allgather_alltoall_cpu_stack_arrays``: asserts isinstance(...,
  np.ndarray); the port stacks a tensor [P, ...] where the reference
  stacks an ndarray (its tensors are the arrays), held value for value
  against the reference by tests/test_torch_host_local.py::test_allgather
  and ::test_alltoall.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_scan_tpu': (
        "SPMD case (the reference's TPU backend); the port's SPMD scan is "
        'held by tests/test_torch_communicator.py::test_scan_exscan'
    ),
    'test_reduce_scatter_tpu': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'reduce_scatter is held by '
        'tests/test_torch_collectives.py::test_ring_reduce_scatter'
    ),
    'test_reduce_scatter_tpu_max_fused': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'reduce_scatter is held by '
        'tests/test_torch_collectives.py::test_ring_reduce_scatter'
    ),
    'test_reduce_scatter_grouped': (
        "SPMD case (the reference's TPU backend); the port's SPMD grouped "
        'reduce_scatter is held by '
        'tests/test_torch_collectives.py::test_ring_reduce_scatter'
    ),
    'test_allgather_alltoall_cpu_stack_arrays': (
        'asserts isinstance(..., np.ndarray); the port stacks a tensor [P, '
        '...] where the reference stacks an ndarray (its tensors are the '
        'arrays), held value for value against the reference by '
        'tests/test_torch_host_local.py::test_allgather and ::test_alltoall'
    ),
}

globals().update(port_cases("test_scan_reduce_scatter", EXCLUDED))
