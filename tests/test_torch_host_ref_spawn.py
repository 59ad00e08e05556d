"""``tests/test_spawn.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_spawn_from_standalone_parent``: its child program (``WORKER``,
  :15) is a string that imports mpi_tpu, so the children would run the
  reference; the same child on mpi_tpu_torch is held by
  tests/test_torch_spawn.py::test_spawn_from_standalone_parent.
* ``test_spawn_from_multirank_parent``: ``WORKER`` as above; held by
  tests/test_torch_spawn.py::test_spawn_from_multirank_parent.
* ``test_spawn_multiple_segments``: its two child programs (:79-94)
  import mpi_tpu; held by
  tests/test_torch_spawn.py::test_spawn_multiple_segments.
* ``test_spawn_rejects_spmd_comm``: an SPMD case (``backend='tpu'``);
  held by tests/test_torch_spawn.py::test_spawn_rejects_the_spmd_comm.
"""

from tests.test_torch_host_ref import port_cases

_CHILD = ("its child program is a string that imports mpi_tpu (the "
          "children would run the reference); held on mpi_tpu_torch by "
          "tests/test_torch_spawn.py::")
EXCLUDED = {
    "test_spawn_from_standalone_parent": _CHILD
    + "test_spawn_from_standalone_parent",
    "test_spawn_from_multirank_parent": _CHILD
    + "test_spawn_from_multirank_parent",
    "test_spawn_multiple_segments": _CHILD + "test_spawn_multiple_segments",
    "test_spawn_rejects_spmd_comm": (
        "an SPMD case (backend='tpu'); held by "
        "tests/test_torch_spawn.py::test_spawn_rejects_the_spmd_comm"),
}

globals().update(port_cases("test_spawn", EXCLUDED))
