"""``tests/test_nonblocking.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_tpu_nonblocking_diagnostics``: SPMD case (the reference's TPU
  backend); the port's SPMD nonblocking diagnoses is held by
  tests/test_torch_communicator.py::test_nonblocking_requests.
* ``test_persistent_rejected_on_spmd``: SPMD case (the reference's TPU
  backend); the port's SPMD persistent-request diagnosis is held by
  tests/test_torch_communicator.py::test_nonblocking_requests.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_tpu_nonblocking_diagnostics': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'nonblocking diagnoses is held by '
        'tests/test_torch_communicator.py::test_nonblocking_requests'
    ),
    'test_persistent_rejected_on_spmd': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'persistent-request diagnosis is held by '
        'tests/test_torch_communicator.py::test_nonblocking_requests'
    ),
}

globals().update(port_cases("test_nonblocking", EXCLUDED))
