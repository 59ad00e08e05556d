"""``tests/test_zero_copy_user.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_user_irecv_lands_in_place_on_socket``: sends a numpy payload,
  which rides the port's pickle path (its raw frames carry tensors), so
  no frame is steerable; the same leg with a tensor payload is held by
  tests/test_torch_zero_copy_user.py::test_user_irecv_lands_in_place.
* ``test_user_irecv_lands_in_place_on_shm``: a numpy payload, as above;
  held by tests/test_torch_zero_copy_user.py::test_user_irecv_lands_in_place.
* ``test_recv_init_user_buffer_refires_in_place``: numpy payloads, as
  above; held by
  tests/test_torch_zero_copy_user.py::test_recv_init_user_buffer_refires_in_place.
* ``test_scatter_gather_irecv_on_socket_uses_vectored_reads``: a list of
  numpy arrays rides the port's pickle path; a list of tensors is one
  multi-segment raw frame, held by
  tests/test_torch_zero_copy_user.py::test_scatter_gather_irecv.
* ``test_scatter_gather_irecv_on_shm``: as above; held by
  tests/test_torch_zero_copy_user.py::test_scatter_gather_irecv.
"""

from tests.test_torch_host_ref import port_cases

_PICKLED = ("a numpy payload, which rides the port's pickle path (its raw "
            "frames carry tensors), so no frame is steerable; held with a "
            "tensor payload by ")
EXCLUDED = {
    "test_user_irecv_lands_in_place_on_socket": _PICKLED + (
        "tests/test_torch_zero_copy_user.py::test_user_irecv_lands_in_place"),
    "test_user_irecv_lands_in_place_on_shm": _PICKLED + (
        "tests/test_torch_zero_copy_user.py::test_user_irecv_lands_in_place"),
    "test_recv_init_user_buffer_refires_in_place": _PICKLED + (
        "tests/test_torch_zero_copy_user.py::"
        "test_recv_init_user_buffer_refires_in_place"),
    "test_scatter_gather_irecv_on_socket_uses_vectored_reads": (
        "a list of numpy arrays rides the port's pickle path; a list of "
        "tensors is one multi-segment raw frame, held by "
        "tests/test_torch_zero_copy_user.py::test_scatter_gather_irecv"),
    "test_scatter_gather_irecv_on_shm": (
        "a list of numpy arrays rides the port's pickle path; held with "
        "tensors by tests/test_torch_zero_copy_user.py::"
        "test_scatter_gather_irecv"),
}

globals().update(port_cases("test_zero_copy_user", EXCLUDED))
