"""``tests/test_vector_collectives.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_allgatherv_spmd``: SPMD case (the reference's TPU backend); the
  port's SPMD allgatherv is held by
  tests/test_torch_communicator.py::test_vector_collectives.
* ``test_scatterv_spmd``: SPMD case (the reference's TPU backend); the
  port's SPMD scatterv is held by
  tests/test_torch_communicator.py::test_vector_collectives.
* ``test_alltoallv_spmd``: SPMD case (the reference's TPU backend); the
  port's SPMD alltoallv is held by
  tests/test_torch_communicator.py::test_vector_collectives.
* ``test_gatherv_spmd_symmetric``: SPMD case (the reference's TPU
  backend); the port's SPMD gatherv is held by
  tests/test_torch_communicator.py::test_gatherv_sharded_padded_blocks_and_ragged_concat.
* ``test_alltoallv_all_zero_counts_spmd``: SPMD case (the reference's TPU
  backend); the port's SPMD alltoallv is held by
  tests/test_torch_communicator.py::test_vector_collectives.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_allgatherv_spmd': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'allgatherv is held by '
        'tests/test_torch_communicator.py::test_vector_collectives'
    ),
    'test_scatterv_spmd': (
        "SPMD case (the reference's TPU backend); the port's SPMD scatterv "
        'is held by '
        'tests/test_torch_communicator.py::test_vector_collectives'
    ),
    'test_alltoallv_spmd': (
        "SPMD case (the reference's TPU backend); the port's SPMD alltoallv "
        'is held by '
        'tests/test_torch_communicator.py::test_vector_collectives'
    ),
    'test_gatherv_spmd_symmetric': (
        "SPMD case (the reference's TPU backend); the port's SPMD gatherv "
        'is held by '
        'tests/test_torch_communicator.py::test_gatherv_sharded_padded_blocks_and_ragged_concat'
    ),
    'test_alltoallv_all_zero_counts_spmd': (
        "SPMD case (the reference's TPU backend); the port's SPMD alltoallv "
        'is held by '
        'tests/test_torch_communicator.py::test_vector_collectives'
    ),
}

globals().update(port_cases("test_vector_collectives", EXCLUDED))
