"""``tests/test_mpit.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_cvar_io_limit_roundtrip_and_unknown``: reads the
  io_collective_buffer_limit_bytes cvar of the reference's io.py, ROADMAP
  item 16.6b (unported); the port's cvar writes are held by this file's
  test_cvar_steers_allreduce_crossover.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_cvar_io_limit_roundtrip_and_unknown': (
        "reads the io_collective_buffer_limit_bytes cvar of the reference's "
        "io.py, ROADMAP item 16.6b (unported); the port's cvar writes are "
        "held by this file's test_cvar_steers_allreduce_crossover"
    ),
}

globals().update(port_cases("test_mpit", EXCLUDED))
