"""``tests/test_federation.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): the leader-lease lifecycle and its
takeover race, the admission order, the priority bump of a full queue,
the relinquish failover signal and ``retry_connect``, at the reference's
bounds.  The in-process pools' workers run on the CPU through
``MPI_TPU_DEVICE=cpu`` (the shim's ``cpu_device_env`` fixture, for each
test's duration).
Not collected (``EXCLUDED``, each with its reason and the port test that
holds the behavior):
* ``test_leader_freeze_brief_keeps_lease``,
  ``test_leader_freeze_past_bound_takeover_then_demote`` and
  ``test_restarted_server_reclaims_ghost_pool`` start ``python -m
  mpi_tpu.launcher serve`` by its string argv, so the servers and their
  workers would be the reference's; the same stories on
  ``mpi_tpu_torch.launcher serve --device cpu`` are in
  tests/test_torch_federation.py under the same names.
* ``test_saturation_bounded_queue_and_fair_share`` imports the
  reference's ``benchmarks/chaos.py``, whose server is the reference's;
  tests/test_torch_federation.py holds the same leg on the port.
"""

import pytest

from tests.test_torch_host_ref import cpu_device_env, port_cases  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_device_env")

_E2E = ("starts python -m mpi_tpu.launcher serve by its string argv (the "
        "reference's servers and workers); held on mpi_tpu_torch by "
        "tests/test_torch_federation.py::")
EXCLUDED = {
    "test_leader_freeze_brief_keeps_lease":
        _E2E + "test_leader_freeze_brief_keeps_lease",
    "test_leader_freeze_past_bound_takeover_then_demote":
        _E2E + "test_leader_freeze_past_bound_takeover_then_demote",
    "test_restarted_server_reclaims_ghost_pool":
        _E2E + "test_restarted_server_reclaims_ghost_pool",
    "test_saturation_bounded_queue_and_fair_share": (
        "imports the reference's benchmarks/chaos.py, whose server is the "
        "reference's; held on mpi_tpu_torch by tests/test_torch_federation.py"
        "::test_saturation_bounded_queue_and_fair_share"),
}

globals().update(port_cases("test_federation", EXCLUDED))
