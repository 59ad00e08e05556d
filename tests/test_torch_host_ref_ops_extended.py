"""``tests/test_ops_extended.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_exscan_spmd``: SPMD case (the reference's TPU backend); the
  port's SPMD exscan is held by
  tests/test_torch_communicator.py::test_scan_exscan.
* ``test_scan_exscan_consistency_spmd``: SPMD case (the reference's TPU
  backend); the port's SPMD scan/exscan is held by
  tests/test_torch_communicator.py::test_scan_exscan.
* ``test_custom_op_spmd``: SPMD case (the reference's TPU backend); the
  port's SPMD user ops is held by
  tests/test_torch_collectives.py::test_allreduce.
* ``test_maxloc_minloc_spmd``: SPMD case (the reference's TPU backend);
  the port's SPMD maxloc/minloc is held by
  tests/test_torch_communicator.py::test_maxloc_minloc.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_exscan_spmd': (
        "SPMD case (the reference's TPU backend); the port's SPMD exscan is "
        'held by tests/test_torch_communicator.py::test_scan_exscan'
    ),
    'test_scan_exscan_consistency_spmd': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'scan/exscan is held by '
        'tests/test_torch_communicator.py::test_scan_exscan'
    ),
    'test_custom_op_spmd': (
        "SPMD case (the reference's TPU backend); the port's SPMD user ops "
        'is held by tests/test_torch_collectives.py::test_allreduce'
    ),
    'test_maxloc_minloc_spmd': (
        "SPMD case (the reference's TPU backend); the port's SPMD "
        'maxloc/minloc is held by '
        'tests/test_torch_communicator.py::test_maxloc_minloc'
    ),
}

globals().update(port_cases("test_ops_extended", EXCLUDED))
