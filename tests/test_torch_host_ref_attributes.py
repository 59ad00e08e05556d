"""``tests/test_attributes.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_attrs_on_tpu_backend_dup``: SPMD case (the reference's TPU
  backend); the port's SPMD dup is held by
  tests/test_torch_communicator.py::test_split_type_create_dup.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_attrs_on_tpu_backend_dup': (
        "SPMD case (the reference's TPU backend); the port's SPMD dup is "
        'held by '
        'tests/test_torch_communicator.py::test_split_type_create_dup'
    ),
}

globals().update(port_cases("test_attributes", EXCLUDED))
