"""``tests/test_codec.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_raw_eligibility``: the reference's raw frames carry numpy arrays,
  the port's tensors (transport/codec.py raw_eligible); held by
  tests/test_torch_host_codec.py::test_raw_frame_round_trip_every_dtype
  and ::test_subclasses_take_the_pickle_path.
* ``test_meta_roundtrip``: numpy dtype strings in the raw meta; the port's
  meta carries torch dtype names, held by
  tests/test_torch_host_codec.py::test_raw_frame_round_trip_every_dtype.
* ``test_multi_segment_eligibility``: numpy segments; the port's
  multi-segment frames carry tensors, held by
  tests/test_torch_host_codec.py::test_odd_shapes_round_trip_over_a_socket.
* ``test_multi_segment_meta_roundtrip``: numpy segment metas, as
  test_meta_roundtrip; held by
  tests/test_torch_host_codec.py::test_odd_shapes_round_trip_over_a_socket.
* ``test_multi_segment_roundtrip``: lists of numpy arrays ride the port's
  pickle path (same values, pickled bytes counted); lists of tensors ride
  one raw frame in
  tests/test_torch_host_codec.py::test_odd_shapes_round_trip_over_a_socket.
* ``test_aliased_list_keeps_pickle_identity``: as_raw_segments of numpy
  arrays; the port's aliasing rule for tensor lists is held by
  tests/test_torch_host_codec.py::test_value_semantics.
* ``test_recv_pool_recycles_and_vetoes_aliases``: codec._BufferPool, a
  reference internal; the port's receive pool is recvpool.py, held by
  tests/test_torch_host_socket.py::test_socket_steering_lands_in_the_working_buffer.
* ``test_recv_pool_different_dtypes_share_storage``: codec._BufferPool, as
  above.
* ``test_large_count_framing_arithmetic``: codec.LEN_MASK, a reference
  internal (the port's length word is RAW_FLAG plus the body length);
  large frames are held by
  tests/test_torch_host_socket.py::test_socket_large_message_framing.
* ``test_large_count_io_syscall_loops``: patches the reference socket
  module's os functions; large frames are held by
  tests/test_torch_host_socket.py::test_socket_large_message_framing.
* ``test_large_count_python_ints_unbounded``: Status._set_count, a
  reference internal; the port's Status counts are held by
  tests/test_torch_host_local.py::test_probe_status_counts.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED = {
    'test_raw_eligibility': (
        "the reference's raw frames carry numpy arrays, the port's tensors "
        '(transport/codec.py raw_eligible); held by '
        'tests/test_torch_host_codec.py::test_raw_frame_round_trip_every_dtype '
        'and ::test_subclasses_take_the_pickle_path'
    ),
    'test_meta_roundtrip': (
        "numpy dtype strings in the raw meta; the port's meta carries torch "
        'dtype names, held by '
        'tests/test_torch_host_codec.py::test_raw_frame_round_trip_every_dtype'
    ),
    'test_multi_segment_eligibility': (
        "numpy segments; the port's multi-segment frames carry tensors, "
        'held by '
        'tests/test_torch_host_codec.py::test_odd_shapes_round_trip_over_a_socket'
    ),
    'test_multi_segment_meta_roundtrip': (
        'numpy segment metas, as test_meta_roundtrip; held by '
        'tests/test_torch_host_codec.py::test_odd_shapes_round_trip_over_a_socket'
    ),
    'test_multi_segment_roundtrip': (
        "lists of numpy arrays ride the port's pickle path (same values, "
        'pickled bytes counted); lists of tensors ride one raw frame in '
        'tests/test_torch_host_codec.py::test_odd_shapes_round_trip_over_a_socket'
    ),
    'test_aliased_list_keeps_pickle_identity': (
        "as_raw_segments of numpy arrays; the port's aliasing rule for "
        'tensor lists is held by '
        'tests/test_torch_host_codec.py::test_value_semantics'
    ),
    'test_recv_pool_recycles_and_vetoes_aliases': (
        "codec._BufferPool, a reference internal; the port's receive pool "
        'is recvpool.py, held by '
        'tests/test_torch_host_socket.py::test_socket_steering_lands_in_the_working_buffer'
    ),
    'test_recv_pool_different_dtypes_share_storage': (
        'codec._BufferPool, as above'
    ),
    'test_large_count_framing_arithmetic': (
        "codec.LEN_MASK, a reference internal (the port's length word is "
        'RAW_FLAG plus the body length); large frames are held by '
        'tests/test_torch_host_socket.py::test_socket_large_message_framing'
    ),
    'test_large_count_io_syscall_loops': (
        "patches the reference socket module's os functions; large frames "
        'are held by '
        'tests/test_torch_host_socket.py::test_socket_large_message_framing'
    ),
    'test_large_count_python_ints_unbounded': (
        "Status._set_count, a reference internal; the port's Status counts "
        'are held by '
        'tests/test_torch_host_local.py::test_probe_status_counts'
    ),
}

globals().update(port_cases("test_codec", EXCLUDED))
