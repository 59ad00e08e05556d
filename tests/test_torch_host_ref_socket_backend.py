"""``tests/test_socket_backend.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_launcher_end_to_end``: runs the reference's launcher by module
  name; the port's launcher end to end is held by
  tests/test_torch_host_socket.py::test_launcher_three_ranks_end_to_end.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_launcher_end_to_end': (
        "runs the reference's launcher by module name; the port's launcher "
        'end to end is held by '
        'tests/test_torch_host_socket.py::test_launcher_three_ranks_end_to_end'
    ),
}

globals().update(port_cases("test_socket_backend", EXCLUDED))
