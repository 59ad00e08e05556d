"""``tests/test_io.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_short_read_at_eof``: reads ``.size`` of a read's result, an
  attribute of an ndarray; the port's reads return tensors on the
  communicator's device (``.numel()``), held by
  tests/test_torch_io.py::test_short_reads_and_ordered_reads_count_elements.
* ``test_write_read_ordered_rank_order``: reads ``.size`` of the ordered
  reads' results, as above; held by
  tests/test_torch_io.py::test_short_reads_and_ordered_reads_count_elements.
* ``test_io_rejects_spmd_comm``: an SPMD case (``backend='tpu'``); the
  port's SPMD refusal is held by
  tests/test_torch_io.py::test_io_rejects_the_spmd_comm.
* ``test_spawn_bridge_transport_closed_on_free``: its child program is a
  string that imports mpi_tpu, so the child would run the reference; the
  same child on mpi_tpu_torch is held by
  tests/test_torch_spawn.py::test_spawn_bridge_transport_closed_on_free.
"""

from tests.test_torch_host_ref import port_cases

_SIZE = ("reads .size of a read's result (an ndarray attribute); the "
         "port's reads return tensors on the communicator's device, held "
         "by tests/test_torch_io.py::"
         "test_short_reads_and_ordered_reads_count_elements")
EXCLUDED = {
    "test_short_read_at_eof": _SIZE,
    "test_write_read_ordered_rank_order": _SIZE,
    "test_io_rejects_spmd_comm": (
        "an SPMD case (backend='tpu'); held by "
        "tests/test_torch_io.py::test_io_rejects_the_spmd_comm"),
    "test_spawn_bridge_transport_closed_on_free": (
        "its child program is a string that imports mpi_tpu (the child "
        "would run the reference); held on mpi_tpu_torch by "
        "tests/test_torch_spawn.py::test_spawn_bridge_transport_closed_on_free"),
}

globals().update(port_cases("test_io", EXCLUDED))
