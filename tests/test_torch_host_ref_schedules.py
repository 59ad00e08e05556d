"""``tests/test_schedules.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): the reference's schedule and checker
cases, property cases included, against ``mpi_tpu_torch.schedules`` and
``mpi_tpu_torch.checker``, which drive the hand-scheduled SPMD
algorithms (``gpu/collectives.py``) and the host engine
(``communicator.py``, ``nbc.py``).  Every case is held; none is left
out.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {}

globals().update(port_cases("test_schedules", EXCLUDED))
