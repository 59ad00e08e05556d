"""``tests/test_resilience.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): every case keeps the reference's
inputs, oracle, assertions and tolerance; the reference's own file runs
each on the reference.
Not collected (``EXCLUDED``, each with its reason and the port test
that holds the behavior):
* ``test_linkstate_seq_ack_prune``: reads LinkState.retained_bytes, an
  internal the port's link keeps as bytes_retained pvars; retention, ack
  pruning and replay are held by
  tests/test_torch_host_socket.py::test_socket_link_heals_and_replays_after_a_dropped_connection.
* ``test_linkstate_resume_prunes_and_replays_tail``: LinkState internals
  (retained_bytes), as test_linkstate_seq_ack_prune; held by
  tests/test_torch_host_socket.py::test_socket_link_heals_and_replays_after_a_dropped_connection.
* ``test_linkstate_generation_fences_stale_readers``: LinkState internals
  (retained_bytes), as test_linkstate_seq_ack_prune; the port's stream
  generations are held by tests/test_torch_host_ft.py (the socket kill
  cases).
* ``test_linkstate_purge_peer_clears_both_streams``: LinkState internals
  (retained_bytes); purge_peer on a death is held by
  tests/test_torch_host_ft.py (the socket kill cases) and
  tests/test_torch_host_membership.py.
* ``test_membership_invalidate_purges_per_dest_link_state``: LinkState
  internals (retained_bytes); membership_invalidate is held by
  tests/test_torch_host_membership.py.
* ``test_healing_disabled_streams_unretained_and_faults_terminal``: writes
  0 to the link_retry_timeout_s cvar, the reference's healing-off mode
  (frames streamed unretained, every link fault terminal), which the port
  does not have: its cvar takes a positive budget (ROADMAP 'Recorded
  differences of the host layer'); healing within the budget is held by
  tests/test_torch_host_socket.py::test_socket_link_heals_and_replays_after_a_dropped_connection.
* ``test_window_bound_one_way_flood_acked_by_flusher``: writes the
  link_window_bytes cvar, which the port does not have (the retained
  window is a constant); the bounded window is held by
  tests/test_torch_host_socket.py::test_socket_link_heals_and_replays_after_a_dropped_connection.
* ``test_bufref_touch_snapshots_before_mutation``: drives bufpool.BufRef
  with a numpy array; the port's ownership layer tracks tensors, held by
  tests/test_torch_host_socket.py::test_retained_frame_is_copied_before_an_in_place_write.
* ``test_bufref_pin_defers_release_and_skips_replay``: drives
  bufpool.BufRef with a numpy array, as above; held by
  tests/test_torch_host_socket.py::test_retained_frame_is_copied_before_an_in_place_write.
* ``test_buffer_reuse_under_resets_is_bit_exact_with_cow``: sends a reused
  numpy buffer, which the port pickles at send (its raw frames carry
  tensors), so no copy-on-write snapshot is needed or counted; the tensor
  case is held by
  tests/test_torch_host_socket.py::test_retained_frame_is_copied_before_an_in_place_write.
* ``test_epoch_grace_tolerates_laggy_catchup_only``: a wall-clock race of
  a laggy peer against epoch_grace_s that fails on a loaded box in the
  reference too (its own case timed out under 6 test workers); the port's
  epoch skew verdict is held by tests/test_torch_host_membership.py.
"""

import pytest

from tests.test_torch_host_ref import cpu_device_env, port_cases  # noqa: F401

EXCLUDED = {
    'test_linkstate_seq_ack_prune': (
        "reads LinkState.retained_bytes, an internal the port's link keeps "
        'as bytes_retained pvars; retention, ack pruning and replay are '
        'held by '
        'tests/test_torch_host_socket.py::test_socket_link_heals_and_replays_after_a_dropped_connection'
    ),
    'test_linkstate_resume_prunes_and_replays_tail': (
        'LinkState internals (retained_bytes), as '
        'test_linkstate_seq_ack_prune; held by '
        'tests/test_torch_host_socket.py::test_socket_link_heals_and_replays_after_a_dropped_connection'
    ),
    'test_linkstate_generation_fences_stale_readers': (
        'LinkState internals (retained_bytes), as '
        "test_linkstate_seq_ack_prune; the port's stream generations are "
        'held by tests/test_torch_host_ft.py (the socket kill cases)'
    ),
    'test_linkstate_purge_peer_clears_both_streams': (
        'LinkState internals (retained_bytes); purge_peer on a death is '
        'held by tests/test_torch_host_ft.py (the socket kill cases) and '
        'tests/test_torch_host_membership.py'
    ),
    'test_membership_invalidate_purges_per_dest_link_state': (
        'LinkState internals (retained_bytes); membership_invalidate is '
        'held by tests/test_torch_host_membership.py'
    ),
    'test_healing_disabled_streams_unretained_and_faults_terminal': (
        "writes 0 to the link_retry_timeout_s cvar, the reference's "
        'healing-off mode, which the port does not have (its cvar takes a '
        "positive budget, ROADMAP 'Recorded differences of the host "
        "layer'); healing within the budget is held by "
        'tests/test_torch_host_socket.py::test_socket_link_heals_and_replays_after_a_dropped_connection'
    ),
    'test_window_bound_one_way_flood_acked_by_flusher': (
        'writes the link_window_bytes cvar, which the port does not have '
        '(the retained window is a constant); the bounded window is held by '
        'tests/test_torch_host_socket.py::test_socket_link_heals_and_replays_after_a_dropped_connection'
    ),
    'test_bufref_touch_snapshots_before_mutation': (
        "drives bufpool.BufRef with a numpy array; the port's ownership "
        'layer tracks tensors, held by '
        'tests/test_torch_host_socket.py::test_retained_frame_is_copied_before_an_in_place_write'
    ),
    'test_bufref_pin_defers_release_and_skips_replay': (
        'drives bufpool.BufRef with a numpy array, as above; held by '
        'tests/test_torch_host_socket.py::test_retained_frame_is_copied_before_an_in_place_write'
    ),
    'test_buffer_reuse_under_resets_is_bit_exact_with_cow': (
        'sends a reused numpy buffer, which the port pickles at send (its '
        'raw frames carry tensors), so no copy-on-write snapshot is needed '
        'or counted; the tensor case is held by '
        'tests/test_torch_host_socket.py::test_retained_frame_is_copied_before_an_in_place_write'
    ),
    'test_epoch_grace_tolerates_laggy_catchup_only': (
        'a wall-clock race of a laggy peer against epoch_grace_s that fails '
        'on a loaded box in the reference too (its own case timed out under '
        "6 test workers); the port's epoch skew verdict is held by "
        'tests/test_torch_host_membership.py'
    ),
}

globals().update(port_cases("test_resilience", EXCLUDED))

# the serve cases' workers run on the CPU (MPI_TPU_DEVICE=cpu for the test)
for _name in ("test_server_client_connects_to_delayed_server",
              "test_serve_lease_rides_healed_links"):
    globals()[_name] = pytest.mark.usefixtures("cpu_device_env")(
        globals()[_name])
