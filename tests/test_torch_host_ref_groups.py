"""``tests/test_groups.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_comm_create_spmd_halves``: SPMD case (the reference's TPU
  backend); the port's SPMD comm.create is held by
  tests/test_torch_communicator.py::test_split_type_create_dup.
* ``test_comm_create_spmd_reorders``: SPMD case (the reference's TPU
  backend); the port's SPMD comm.create reordering is held by
  tests/test_torch_communicator.py::test_split_key_reorders_and_nested_split.
* ``test_comm_create_spmd_uneven_rejected``: SPMD case (the reference's
  TPU backend); the port's SPMD split rejections is held by
  tests/test_torch_communicator.py::test_split_rejections.
* ``test_group_rank_of_traced_rank_raises_loudly``: SPMD case (the
  reference's TPU backend); the port's SPMD traced-rank diagnoses is held
  by tests/test_torch_communicator.py::test_split_rejections.
* ``test_comm_create_spmd_out_of_range_rank_rejected``: SPMD case (the
  reference's TPU backend); the port's SPMD split rejections is held by
  tests/test_torch_communicator.py::test_split_rejections.
* ``test_comm_create_empty_group_rejected``: SPMD case (the reference's
  TPU backend); the port's SPMD split rejections is held by
  tests/test_torch_communicator.py::test_split_rejections.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_comm_create_spmd_halves': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'comm.create is held by '
        'tests/test_torch_communicator.py::test_split_type_create_dup'
    ),
    'test_comm_create_spmd_reorders': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'comm.create reordering is held by '
        'tests/test_torch_communicator.py::test_split_key_reorders_and_nested_split'
    ),
    'test_comm_create_spmd_uneven_rejected': (
        "SPMD case (the reference's TPU backend); the port's SPMD split "
        'rejections is held by '
        'tests/test_torch_communicator.py::test_split_rejections'
    ),
    'test_group_rank_of_traced_rank_raises_loudly': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'traced-rank diagnoses is held by '
        'tests/test_torch_communicator.py::test_split_rejections'
    ),
    'test_comm_create_spmd_out_of_range_rank_rejected': (
        "SPMD case (the reference's TPU backend); the port's SPMD split "
        'rejections is held by '
        'tests/test_torch_communicator.py::test_split_rejections'
    ),
    'test_comm_create_empty_group_rejected': (
        "SPMD case (the reference's TPU backend); the port's SPMD split "
        'rejections is held by '
        'tests/test_torch_communicator.py::test_split_rejections'
    ),
}

globals().update(port_cases("test_groups", EXCLUDED))
