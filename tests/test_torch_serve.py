"""The resident world server (``mpi_tpu_torch/serve.py``) against the
reference's (``mpi_tpu/serve.py``), side by side on the CPU.

* The same numpy-seeded payload is leased on a reference pool and on a
  port pool of 3 workers (socket and shm): every lease size's result is
  bitwise the reference's.
* The pure parts against the reference's: ``_admission_order`` on seeded
  waiters, ``prometheus_text`` byte for byte (the stats document of
  ``tests/test_telemetry.py:336`` and richer ones), and the
  ``_pack_error`` -> ``_raise_error`` round trip of every named error
  (class, MPI error class, message, failed ranks).
* The port's own contract: ``ServerBusyError`` past ``max_pending``, the
  federation entry points (a server joining a namespace, the CLI's four
  federation flags, ``connect`` of a namespace or a server list), a
  worker with no device failing ``start()`` with a named error,
  results moved to the CPU, ``launcher serve`` (the reference's
  ``test_launcher_serve_subcommand`` on the port), ``--link-retry-timeout``
  and the two cvars' environment seeds.

The module imports only numpy, pytest and the standard library at its
top: the reference's workers import it to unpickle :func:`job_seeded`.
Port workers run on the CPU through ``MPI_TPU_DEVICE=cpu``.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETECT_S = 1.5


def job_seeded(comm, seed: int, n: int):
    """The side-by-side payload, one program for both packages: each rank
    draws ``n`` float32 normals from ``(seed, rank)`` with numpy; a ring
    allreduce, an allgather of each rank's first draws and a bcast from
    the last rank.  Returns numpy arrays from lease rank 0."""
    x = np.random.default_rng([seed, comm.rank]).standard_normal(n).astype(
        np.float32)
    if type(comm).__module__.startswith("mpi_tpu_torch"):
        import torch

        x = torch.from_numpy(x).to(comm.device)
    total = comm.allreduce(x, algorithm="ring")
    heads = comm.allgather(x[:4])
    last = comm.bcast(x[:8], root=comm.size - 1)
    as_np = (lambda a: a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a))
    return (as_np(total), [as_np(h) for h in heads], as_np(last))


def _pools(backend):
    from mpi_tpu import serve as ref_serve
    from mpi_tpu_torch import serve

    kw = dict(pool_size=3, backend=backend, detect_timeout_s=DETECT_S,
              heartbeat_s=0.2)
    return (ref_serve.WorldServer(**kw),
            serve.WorldServer(env_extra={"MPI_TPU_DEVICE": "cpu"}, **kw))


@pytest.mark.parametrize("backend", ["socket", "shm"])
def test_same_payload_on_reference_and_port_pools(backend):
    from mpi_tpu import serve as ref_serve
    from mpi_tpu_torch import serve

    # by its import path, so both packages' workers can unpickle it
    from tests.test_torch_serve import job_seeded as job

    ref, port = _pools(backend)
    try:
        for srv in (ref, port):  # the two pools start side by side
            srv.start(wait_ready=False)
        port._wait_ready(120.0)
        _ref_wait(ref)
        rc, pc = ref_serve.connect(ref), serve.connect(port)
        try:
            for nranks, seed in ((1, 11), (2, 12), (3, 13)):
                want = rc.run(job, seed, 1000, nranks=nranks, timeout=60.0)
                got = pc.run(job, seed, 1000, nranks=nranks, timeout=60.0)
                np.testing.assert_array_equal(got[0], want[0])
                assert len(got[1]) == len(want[1]) == nranks
                for g, w in zip(got[1], want[1]):
                    np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(got[2], want[2])
            assert rc.run(ref_serve.job_allreduce, 64, nranks=3,
                          timeout=60.0) == pc.run(serve.job_allreduce, 64,
                                                  nranks=3, timeout=60.0)
            assert (rc.stats()["jobs_ok"], rc.stats()["epoch"]) == (
                pc.stats()["jobs_ok"], pc.stats()["epoch"]) == (4, 0)
        finally:
            rc.close()
            pc.close()
    finally:
        ref.stop()
        port.stop()


def _ref_wait(srv, timeout=120.0):
    """The reference's start() wait, for a server started without it."""
    deadline = time.monotonic() + timeout
    with srv._cond:
        while any(w.state == "starting" for w in srv._workers.values()):
            assert time.monotonic() < deadline, "reference pool not ready"
            srv._cond.wait(0.25)


def test_admission_order_matches_reference():
    from mpi_tpu import serve as ref_serve
    from mpi_tpu_torch import serve

    rng = np.random.default_rng(7)
    for _ in range(50):
        k = int(rng.integers(1, 12))
        waiters = [{"client": f"c{int(rng.integers(0, 4))}",
                    "priority": int(rng.integers(-1, 3)),
                    "nranks": int(rng.integers(1, 4)), "seq": int(s)}
                   for s in rng.permutation(100)[:k]]
        grants = {f"c{i}": int(rng.integers(0, 5)) for i in range(4)
                  if rng.random() < 0.7}
        want = [w["seq"] for w in ref_serve._admission_order(waiters, grants)]
        got = [w["seq"] for w in serve._admission_order(waiters, grants)]
        assert got == want


_STATS_336 = {"epoch": 3, "pool_size": 4, "idle": 2, "leases_active": 1,
              "worlds_per_s": 12.5, "uptime_s": 60.0,
              "leases_granted": 9, "jobs_ok": 7, "jobs_failed": 2,
              "heals_completed": 1, "workers_lost": 1,
              "workers": {0: "idle", 1: "leased"},
              "healing": [2], "worker_pvars": {"link_reconnects": 5}}
_STATS_POOLS = dict(
    _STATS_336, waiting=3, max_pending=64, busy_rejected=2, leases_denied=4,
    pools={"home": {"home": True, "epoch": 3, "size": 2,
                    "workers": {0: "idle", 1: "dead"}},
           "adopted": {"home": False, "epoch": 1, "size": 1,
                       "workers": {0: "starting"}}},
    is_leader=True,
    federation={"servers_total": 2, "servers_live": 1, "worlds_per_s": 0.25,
                "servers": {"a": {"is_leader": True, "live": True},
                            "b": {"live": False}}})
_STATS_EMPTY = {"epoch": 0, "workers": {}, "is_leader": None}


@pytest.mark.parametrize("stats", [_STATS_336, _STATS_POOLS, _STATS_EMPTY],
                         ids=["telemetry_336", "pools_federation", "empty"])
@pytest.mark.parametrize("samples", [(2e-3, 4e-3), (), (3e-5, 0.7, 1.5e-3)])
def test_prometheus_text_is_the_references_byte_for_byte(stats, samples):
    from mpi_tpu import mpit as ref_mpit
    from mpi_tpu.telemetry import metrics as ref_metrics
    from mpi_tpu_torch import mpit
    from mpi_tpu_torch.telemetry import metrics

    for m in (ref_mpit, mpit):
        m.pvar_hist_reset("lease_acquire_s")
        for s in samples:
            m.hist_record("lease_acquire_s", s)
    want = ref_metrics.prometheus_text(stats)
    assert metrics.prometheus_text(stats).encode() == want.encode()
    if samples:
        assert f"mpi_tpu_lease_acquire_seconds_count {len(samples)}" in want


def _named_errors(errors, base, serve):
    """name -> an instance of each error the wire ships by name."""
    return {
        "ProcFailedError": errors.ProcFailedError(
            "peer died", failed=(1, 3), collective="allreduce"),
        "RevokedError": errors.RevokedError("revoked"),
        "DeadlockError": errors.DeadlockError("cycle", ranks=(0, 1)),
        "EpochSkewError": errors.EpochSkewError("stale", local_epoch=1,
                                                peer_epoch=2, peer=0),
        "RejoinRefusedError": errors.RejoinRefusedError("refused"),
        "RecvTimeout": base.RecvTimeout("no message"),
        "TransportError": base.TransportError("link gone"),
        "ServerBusyError": errors.ServerBusyError("queue full"),
        "ServerLostError": serve.ServerLostError("server gone"),
        "NoQuorumError": errors.NoQuorumError("minority"),
        "ValueError": ValueError("nranks must be in [1, 3] for this pool"),
    }


@pytest.mark.parametrize("kind", [
    "ProcFailedError", "RevokedError", "DeadlockError", "EpochSkewError",
    "RejoinRefusedError", "RecvTimeout", "TransportError", "ServerBusyError",
    "ServerLostError", "NoQuorumError", "ValueError", "LeaseTimeout"])
def test_error_round_trip_matches_reference(kind):
    from mpi_tpu import errors as ref_errors
    from mpi_tpu import serve as ref_serve
    from mpi_tpu.transport import base as ref_base
    from mpi_tpu_torch import errors, serve
    from mpi_tpu_torch.transport import base

    def trip(errs, srv):
        if kind == "LeaseTimeout":
            packed = {"kind": "LeaseTimeout", "msg": "no 3 idle workers"}
        else:
            packed = srv._pack_error(_named_errors(errs[0], errs[1], srv)[kind])
        with pytest.raises(Exception) as ei:
            srv._raise_error(packed)
        e = ei.value
        return (packed, type(e).__name__, errs[0].error_class(e), str(e),
                tuple(getattr(e, "failed", ()) or ()),
                getattr(e, "collective", None))

    want = trip((ref_errors, ref_base), ref_serve)
    got = trip((errors, base), serve)
    assert got == want


def test_server_busy_past_max_pending_and_federation_entry_points(
        monkeypatch, tmp_path):
    from mpi_tpu_torch import connect, federation, serve
    from mpi_tpu_torch.errors import MPI_ERR_OTHER, ServerBusyError, error_class

    for addr in (str(tmp_path), "raft:127.0.0.1:1,127.0.0.1:2",
                 ["127.0.0.1:1", "127.0.0.1:2"]):
        client = connect(addr)  # resolves lazily: nothing is dialed yet
        assert isinstance(client, federation.FederatedClient)
        client.close()
    with pytest.raises(ValueError, match="neither a host:port"):
        connect("no-such-server")

    # the CLI's federation flags reach the server
    made = {}

    class Parsed:
        addr, metrics_addr, _closing = "127.0.0.1:1", None, True

        def __init__(self, **kw):
            made.update(kw)
            self.server_id = kw["server_id"]

        def start(self):
            return self

        def stop(self):
            made["stopped"] = True

    monkeypatch.setattr(serve, "WorldServer", Parsed)
    assert serve.main(["--federation", str(tmp_path), "--server-id", "a",
                       "--fed-lease-timeout", "3", "--orphan-timeout",
                       "9"]) == 0
    assert (made["federation"], made["server_id"], made["fed_lease_timeout_s"],
            made["orphan_timeout_s"], made["stopped"]) == (
                str(tmp_path), "a", 3.0, 9.0, True)
    monkeypatch.undo()

    monkeypatch.setenv("MPI_TPU_DEVICE", "cpu")  # the worker's device
    ns = str(tmp_path / "ns")
    with serve.WorldServer(pool_size=1, federation=ns, server_id="fed-a",
                           detect_timeout_s=DETECT_S, heartbeat_s=0.2) as fed:
        # the server joined: its endpoint record, its pool's ownership
        # record, and the leader lease (the only member takes it)
        assert federation.read_server_records(ns)["fed-a"]["ctrl"] == fed.addr
        assert federation.read_pool_owners(ns)[fed._home]["owner"] == "fed-a"
        deadline = time.monotonic() + 10.0
        while not fed.is_leader():
            assert time.monotonic() < deadline, "the only member never led"
            time.sleep(0.05)
        st = fed.stats()
        assert st["is_leader"] is True and st["store_healthy"] is True
        assert st["federation"]["servers_live"] == 1
        assert st["federation"]["leader"] == "fed-a"
    # a clean stop retracts the records and releases the lease
    assert federation.read_server_records(ns) == {}
    assert federation.read_leader(ns) is None
    with serve.WorldServer(pool_size=1, max_pending=1, detect_timeout_s=DETECT_S,
                           heartbeat_s=0.2) as srv:
        hog_client, waiter_client, late = (connect(srv) for _ in range(3))
        try:
            hog = hog_client.acquire(1, timeout=10.0)
            waited = {}
            th = threading.Thread(target=lambda: waited.setdefault(
                "lease", waiter_client.acquire(1, timeout=30.0)))
            th.start()
            deadline = time.monotonic() + 10.0
            while late.stats()["waiting"] < 1:
                assert time.monotonic() < deadline, "the waiter never queued"
                time.sleep(0.02)
            t0 = time.monotonic()
            with pytest.raises(ServerBusyError, match="admission queue full") as ei:
                late.acquire(1, timeout=30.0)
            assert time.monotonic() - t0 < 5.0  # rejected at once, not queued
            assert error_class(ei.value) == MPI_ERR_OTHER
            hog.release()
            th.join(30.0)
            assert not th.is_alive() and waited["lease"].slots == [0]
            waited["lease"].release()
            st = late.stats()
            assert (st["busy_rejected"], st["leases_granted"]) == (1, 2)
            assert st["is_leader"] is None and "federation" not in st
            assert not srv.is_leader()
            assert set(srv.owned_pool_records()) == {srv._home}
            assert srv.fed_summary()["workers"] == 1
        finally:
            for c in (hog_client, waiter_client, late):
                c.close()


def test_worker_without_a_device_fails_start_by_name():
    import torch

    from mpi_tpu_torch import serve

    if torch.cuda.is_available():
        pytest.skip("a card is present: the workers' default device is the card")
    t0 = time.monotonic()
    srv = serve.WorldServer(pool_size=2, env_extra={"MPI_TPU_DEVICE": ""})
    with pytest.raises(serve.WorkerStartError, match="MPI_TPU_DEVICE"):
        srv.start(timeout=60.0)
    assert time.monotonic() - t0 < 60.0
    assert srv._closing and not os.path.exists(srv.rdv)
    assert all(w.proc.poll() is not None for w in srv._workers.values())


def job_sleep_holding_the_link(comm, secs: float):
    """A job that wedges its worker and leaves a forked child holding the
    worker's descriptors, its control connection among them, for ``secs``:
    the server sees no end of that connection when it kills the worker."""
    pid = os.fork()
    if pid == 0:
        time.sleep(secs)
        os._exit(0)
    time.sleep(secs)
    return 0


def test_lease_timeout_declares_the_killed_worker_dead_at_once():
    """The worker killed past a lease timeout is dead in the server's
    books when the client's ``TimeoutError`` arrives: ``stats()`` says so
    at once, the release does not hand the slot back to the idle pool,
    and the pool heals to a correct full-size world.  The killed worker's
    control connection outlives it (``job_sleep_holding_the_link``) and
    the monitor ticks every 3 s, so a server that waited for either to see
    the death would still report a whole pool with nothing lost: the
    reference case ``tests/test_serve.py::
    test_lease_timeout_quarantines_wedged_worker`` then returns from its
    heal wait at once and fails, as it did under load, where a torch
    worker's exit is slow to close its connection."""
    from mpi_tpu_torch import serve

    # by its import path, so the workers can unpickle it
    from tests.test_torch_serve import job_sleep_holding_the_link as job

    srv = serve.WorldServer(pool_size=3, backend="socket", detect_timeout_s=10.0,
                            heartbeat_s=3.0, rejoin_timeout_s=60.0,
                            env_extra={"MPI_TPU_DEVICE": "cpu"})
    with srv:
        client = serve.connect(srv)
        try:
            lease = client.acquire(1, timeout=30.0)
            with pytest.raises(TimeoutError, match="did not complete"):
                lease.run(job, 20.0, timeout=1.0)
            st = client.stats()
            assert st["workers_lost"] == 1 and st["epoch"] == 1, st
            lease.release()
            st = client.stats()
            assert st["idle"] == 2, st
            deadline = time.monotonic() + 90.0
            while not (st["idle"] == 3 and not st["healing"]):
                assert time.monotonic() < deadline, st
                time.sleep(0.2)
                st = client.stats()
            assert st["workers_lost"] == 1
            assert client.run(serve.job_allreduce, 64, nranks=3, timeout=60.0) == 6.0
        finally:
            client.close()


def test_results_move_to_the_cpu():
    import torch

    from mpi_tpu_torch import serve

    x = torch.arange(3.0)
    out = serve._to_cpu({"a": (x, [x, 1]), "b": "s"})
    assert isinstance(out["a"], tuple) and isinstance(out["a"][1], list)
    assert torch.equal(out["a"][0], x) and out["a"][1][1] == 1
    assert out["b"] == "s" and out["a"][0].device.type == "cpu"


def test_launcher_serve_subcommand(tmp_path):
    """``python -m mpi_tpu_torch.launcher serve --addr-file F --device cpu``
    brings a pool up, ``mpi_tpu_torch.connect(F)`` leases a world from it
    and a client shutdown stops the server with exit code 0 (the
    reference's ``tests/test_serve.py::test_launcher_serve_subcommand``)."""
    import mpi_tpu_torch
    from mpi_tpu_torch import serve

    addr_file = tmp_path / "serve.addr"
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "serve",
         "--pool-size", "2", "--addr-file", str(addr_file),
         "--detect-timeout", str(DETECT_S), "--device", "cpu",
         "--metrics-port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 90.0
        while not addr_file.exists():
            assert proc.poll() is None, proc.communicate()[1][-900:]
            assert time.monotonic() < deadline, "server never published"
            time.sleep(0.1)
        client = mpi_tpu_torch.connect(str(addr_file))
        assert client.run(serve.job_allreduce, 64, nranks=2,
                          timeout=30.0) == 3.0
        assert client.stats()["metrics_addr"]
        client.shutdown()
        client.close()
        assert proc.wait(timeout=30.0) == 0
        assert "metrics on http://" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10.0)


def test_link_retry_timeout_reaches_the_ranks(monkeypatch):
    """``--link-retry-timeout`` travels as ``MPI_TPU_LINK_RETRY_S``, which
    seeds the ``link_retry_timeout_s`` cvar in a fresh process, as
    ``MPI_TPU_CONNECT_RETRY_S`` seeds ``connect_retry_timeout_s``."""
    from mpi_tpu_torch import launcher

    seen = {}
    monkeypatch.setattr(launcher, "launch",
                        lambda n, argv, **kw: seen.update(kw) or 0)
    assert launcher.main(["-n", "2", "--link-retry-timeout", "2.5",
                          "prog.py"]) == 0
    assert seen["env_extra"]["MPI_TPU_LINK_RETRY_S"] == "2.5"
    with pytest.raises(SystemExit):
        launcher.main(["-n", "2", "--link-retry-timeout", "0", "prog.py"])
    res = subprocess.run(
        [sys.executable, "-c",
         "from mpi_tpu_torch import mpit; print(mpit.cvar_read("
         "'link_retry_timeout_s'), mpit.cvar_read('connect_retry_timeout_s'))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, MPI_TPU_LINK_RETRY_S="2.5",
                 MPI_TPU_CONNECT_RETRY_S="0.75"))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["2.5", "0.75"]



def test_serve_help_lists_the_references_options(capsys):
    import re

    from mpi_tpu import serve as ref_serve
    from mpi_tpu_torch import serve

    def options(main):
        with pytest.raises(SystemExit):
            main(["--help"])
        return set(re.findall(r"(?<![\w-])--[a-z][a-z-]+", capsys.readouterr().out))

    want = options(ref_serve.main)
    assert "--federation" in want and "--max-pending" in want
    assert options(serve.main) == want | {"--device"}
