"""``tests/test_federation_store.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``): the namespace-store conformance suite
on both backends (the port's ``FileStore`` on a directory and
``RaftStore`` on an in-process 3-node raft fabric), the ``FileStore``
frozen-holder, version-GC and tombstone cases, and the raft replay,
partition and client-RPC cases, with the reference's election bound,
keys, assertions and timeouts.  The reference's own file runs each case
on the reference.  Every case is collected (``EXCLUDED`` is empty): the
store has no device and no process of its own.
"""

from tests.test_torch_host_ref import port_cases

EXCLUDED: dict = {}

globals().update(port_cases("test_federation_store", EXCLUDED))
