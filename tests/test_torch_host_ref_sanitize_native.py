"""``tests/test_sanitize_native.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_asan_smoke``: asserts the reference's build file names
  (_shmring.asan.so); the port builds shmring-<hash>.asan.so under
  mpi_tpu_torch/_build, held by
  tests/test_torch_shm.py::test_ring_builds_from_the_ports_source_into_its_build_dir.
* ``test_ubsan_smoke``: the reference's build file names, as
  test_asan_smoke; held by
  tests/test_torch_shm.py::test_ring_builds_from_the_ports_source_into_its_build_dir.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_asan_smoke': (
        "asserts the reference's build file names (_shmring.asan.so); the "
        'port builds shmring-<hash>.asan.so under mpi_tpu_torch/_build, '
        'held by '
        'tests/test_torch_shm.py::test_ring_builds_from_the_ports_source_into_its_build_dir'
    ),
    'test_ubsan_smoke': (
        "the reference's build file names, as test_asan_smoke; held by "
        'tests/test_torch_shm.py::test_ring_builds_from_the_ports_source_into_its_build_dir'
    ),
}

globals().update(port_cases("test_sanitize_native", EXCLUDED))
