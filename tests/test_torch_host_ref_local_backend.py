"""``tests/test_local_backend.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {}

globals().update(port_cases("test_local_backend", EXCLUDED))
