"""``tests/test_serve.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's pool
sizes, detection bounds, load margins, assertions and timeouts; the
reference's own file runs each on the reference.  The port's workers run
on the CPU through ``MPI_TPU_DEVICE=cpu`` (the shim's ``cpu_device_env``
fixture, for each test's duration).
Not collected (``EXCLUDED``, each with its reason and the port test that
holds the behavior):
* ``test_launcher_serve_subcommand``: it starts ``python -m
  mpi_tpu.launcher serve`` by its string argv, so the server and its
  workers would be the reference's; the same story on
  ``mpi_tpu_torch.launcher serve`` is held by
  tests/test_torch_serve.py::test_launcher_serve_subcommand.
"""

import pytest

from tests.test_torch_host_ref import cpu_device_env, port_cases  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_device_env")

EXCLUDED = {
    "test_launcher_serve_subcommand": (
        "starts python -m mpi_tpu.launcher serve by its string argv (the "
        "reference's server and workers); held on mpi_tpu_torch by "
        "tests/test_torch_serve.py::test_launcher_serve_subcommand"),
}

globals().update(port_cases("test_serve", EXCLUDED))
