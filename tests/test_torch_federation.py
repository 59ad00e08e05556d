"""Server federation on the port (``mpi_tpu_torch/federation.py``,
``federation_store.py`` and the serve seams) on the CPU.

* The reference's end-to-end cases that start ``mpi_tpu.launcher serve``
  by its string argv (``tests/test_federation.py:241-442``), here with
  ``python -m mpi_tpu_torch.launcher serve --federation ... --device
  cpu`` under the same names, bounds and assertions: the brief leader
  freeze that keeps the lease, the freeze past the bound with takeover,
  demotion and orphan re-registration, and the restarted server that
  reclaims its ghost pool.
* The saturation leg of the reference's ``benchmarks/chaos.py``
  (``run_federation_saturation``, quick mode) as a port-owned copy at its
  pool, queue bound and flood.
* Parity with the reference: the same seeded sequence of ``cas`` /
  ``put`` / ``delete`` / ``append`` / ``scan`` on a reference
  ``FileStore`` and a port ``FileStore`` gives the same versions and
  byte-identical files; ``federation_stats`` of the same records is the
  reference's; a federated port server's ``stats()`` renders the
  reference's Prometheus text byte for byte, its ``mpi_tpu_fed_*``
  gauges equal to ``stats()["federation"]``.
* ``examples/host_federation.py --kill-leader`` (chip_smoke.py phase 28's
  program) on the CPU.

Servers shut down through their clients at the end of each case, so the
adopted orphans stop with their new owner.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mpi_tpu_torch import federation, serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DETECT_S = 1.5
FED_LEASE_S = 2.0
# server + workers + pytest exceed this box's cores: the reference's
# load-scaled margin (tests/test_federation.py:28)
LOAD_MARGIN_S = 25.0 if (os.cpu_count() or 1) < 4 else 8.0


def _spawn_server(idx, ns, tmp, pool=2):
    addr_file = os.path.join(tmp, f"s{idx}.addr")
    log = open(os.path.join(tmp, f"s{idx}.log"), "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "serve",
         "--pool-size", str(pool), "--addr-file", addr_file,
         "--detect-timeout", str(DETECT_S), "--heartbeat", "0.2",
         "--federation", ns, "--fed-lease-timeout", str(FED_LEASE_S),
         "--server-id", f"s{idx}", "--orphan-timeout", "60",
         "--device", "cpu"],
        cwd=REPO, stdout=log, stderr=log)
    return {"proc": proc, "addr_file": addr_file, "log": log,
            "id": f"s{idx}"}


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _fabric_up(ns, servers):
    for s in servers:
        _wait(lambda: os.path.exists(s["addr_file"])
              and s["proc"].poll() is None,
              90.0 + LOAD_MARGIN_S, f"{s['id']} addr file")
        with open(s["addr_file"]) as f:
            s["addr"] = f.read().strip()
    _wait(lambda: len([r for r in
                       federation.read_server_records(ns).values()
                       if federation.record_live(r)]) == len(servers),
          30.0 + LOAD_MARGIN_S, "all endpoint records live")
    _wait(lambda: federation.read_leader(ns) is not None,
          15.0 + LOAD_MARGIN_S, "a leader")


def _teardown(servers):
    """Shut the live servers down through their clients (each stops the
    workers it serves, adopted orphans included), then kill stragglers."""
    for s in servers:
        if s["proc"].poll() is None and s.get("addr"):
            os.kill(s["proc"].pid, signal.SIGCONT)  # a frozen one answers
            host, port = s["addr"].rsplit(":", 1)
            try:
                with serve.ServerClient(host, int(port), timeout=10.0,
                                        dial_retry_s=2.0) as c:
                    c.shutdown()
            except OSError:
                pass
    for s in servers:
        try:
            s["proc"].wait(30.0)
        except subprocess.TimeoutExpired:
            s["proc"].kill()
            s["proc"].wait(10.0)
        s["log"].close()


def test_leader_freeze_brief_keeps_lease(tmp_path):
    """SIGSTOP the leader for well under the lease bound, SIGCONT: nobody
    fails over, ownership is unchanged, the fabric keeps serving and the
    authority log shows no overlap (``tests/test_federation.py:280``)."""
    ns = str(tmp_path / "ns")
    servers = [_spawn_server(i, ns, str(tmp_path)) for i in range(2)]
    try:
        _fabric_up(ns, servers)
        leader_id = federation.read_leader(ns)["id"]
        leader = next(s for s in servers if s["id"] == leader_id)
        owners_before = {p: r["owner"] for p, r
                         in federation.read_pool_owners(ns).items()}
        os.kill(leader["proc"].pid, signal.SIGSTOP)
        time.sleep(0.4 * FED_LEASE_S)
        os.kill(leader["proc"].pid, signal.SIGCONT)
        time.sleep(2.0 * FED_LEASE_S)  # several renew ticks
        assert federation.read_leader(ns)["id"] == leader_id, \
            "a brief freeze must not cost the lease"
        assert not [n for n in os.listdir(ns)
                    if n.startswith("takeover.")], "nobody failed over"
        owners_after = {p: r["owner"] for p, r
                        in federation.read_pool_owners(ns).items()}
        assert owners_after == owners_before
        federation.assert_no_leader_overlap(ns)
        with federation.FederatedClient(namespace=ns) as client:
            assert client.run(serve.job_allreduce, 64, nranks=2,
                              timeout=30.0) == 3.0
    finally:
        _teardown(servers)


def test_leader_freeze_past_bound_takeover_then_demote(tmp_path):
    """SIGSTOP the leader past the lease bound: the follower takes the
    lease and adopts the frozen server's pool, whose workers defect while
    their master is still frozen; on SIGCONT the ex-leader demotes and
    relinquishes, and no two servers' authority intervals overlap
    (``tests/test_federation.py:314``)."""
    ns = str(tmp_path / "ns")
    servers = [_spawn_server(i, ns, str(tmp_path)) for i in range(2)]
    try:
        _fabric_up(ns, servers)
        leader_id = federation.read_leader(ns)["id"]
        leader = next(s for s in servers if s["id"] == leader_id)
        follower = next(s for s in servers if s["id"] != leader_id)
        os.kill(leader["proc"].pid, signal.SIGSTOP)
        new = _wait(lambda: (federation.read_leader(ns) or {}).get(
            "id") == follower["id"] and federation.read_leader(ns),
            6.0 * FED_LEASE_S + LOAD_MARGIN_S, "lease takeover")
        assert new["term"] >= 2
        _wait(lambda: all(
            r["owner"] == follower["id"] for r
            in federation.read_pool_owners(ns).values()),
            20.0 + LOAD_MARGIN_S, "pool adoption")
        with federation.FederatedClient(namespace=ns) as client:
            assert client.run(serve.job_allreduce, 64, nranks=2,
                              timeout=30.0) == 3.0
        # the frozen-master escape: the orphans defect on their own
        fhost, fport = follower["addr"].rsplit(":", 1)
        fclient = serve.ServerClient(fhost, int(fport))
        try:
            _wait(lambda: fclient.stats()["idle"] == 4,
                  30.0 + LOAD_MARGIN_S,
                  "orphans defected from the still-frozen master")
            os.kill(leader["proc"].pid, signal.SIGCONT)
            st = fclient.stats()
            assert st["pools_adopted"] >= 1
            assert st["orphans_reregistered"] >= 2
            assert st["is_leader"] is True
        finally:
            fclient.close()
        lhost, lport = leader["addr"].rsplit(":", 1)
        lclient = serve.ServerClient(lhost, int(lport))
        try:
            _wait(lambda: lclient.stats()["pools_relinquished"] >= 1,
                  15.0 + LOAD_MARGIN_S, "ex-leader relinquish")
            st = lclient.stats()
            assert st["is_leader"] is False, "thawed ex-leader demotes"
            assert not st["pools"], "relinquished pools are dropped"
        finally:
            lclient.close()
        assert federation.read_leader(ns)["id"] == follower["id"]
        federation.assert_no_leader_overlap(ns)
        # the survivor serves both pools: two concurrent 2-rank leases land
        # on different pools and both run correctly
        fclient2 = serve.ServerClient(fhost, int(fport))
        try:
            la = fclient2.acquire(2, timeout=15.0)
            lb = fclient2.acquire(2, timeout=15.0)
            assert la.pool != lb.pool, (la.pool, lb.pool)
            assert la.run(serve.job_allreduce, 64, timeout=30.0) == 3.0
            assert lb.run(serve.job_allreduce, 64, timeout=30.0) == 3.0
            la.release()
            lb.release()
            # the thawed ex-leader saw its defected orphans' connections
            # close: it handed the pool over and killed none of them
            assert fclient2.stats()["workers_lost"] == 0
        finally:
            fclient2.close()
    finally:
        _teardown(servers)


def test_restarted_server_reclaims_ghost_pool(tmp_path):
    """With no survivor to adopt (one server), a SIGKILLed server's pool
    record keeps naming its id; the restarted incarnation under the same
    ``--server-id`` reclaims the ghost pool itself, its warm orphans
    registering beside the fresh home pool, whose start barrier holds
    (``tests/test_federation.py:407``)."""
    ns = str(tmp_path / "ns")
    servers = [_spawn_server(0, ns, str(tmp_path))]
    try:
        _fabric_up(ns, servers)
        old_pool = set(federation.read_pool_owners(ns))
        assert len(old_pool) == 1
        os.kill(servers[0]["proc"].pid, signal.SIGKILL)
        servers[0]["proc"].wait(10.0)
        os.makedirs(str(tmp_path / "restart"), exist_ok=True)
        servers.append(_spawn_server(0, ns, str(tmp_path / "restart")))
        _fabric_up(ns, servers[1:])
        host, port = servers[1]["addr"].rsplit(":", 1)
        client = serve.ServerClient(host, int(port))
        try:
            _wait(lambda: client.stats()["idle"] == 4,
                  40.0 + LOAD_MARGIN_S, "ghost pool reclaimed")
            st = client.stats()
            assert st["pools_adopted"] >= 1
            assert set(st["pools"]) >= old_pool
            assert st["orphans_reregistered"] >= 2
            # the reclaimed orphans and the fresh pool both serve
            la = client.acquire(2, timeout=15.0)
            lb = client.acquire(2, timeout=15.0)
            assert {la.pool, lb.pool} == set(st["pools"])
            assert la.run(serve.job_allreduce, 64, timeout=30.0) == 3.0
            assert lb.run(serve.job_allreduce, 64, timeout=30.0) == 3.0
            la.release()
            lb.release()
        finally:
            client.close()
    finally:
        _teardown(servers)


def test_saturation_bounded_queue_and_fair_share(monkeypatch):
    """``benchmarks/chaos.py``'s ``run_federation_saturation(quick=True)``
    on the port: 8 flooding clients against a pool of 2 with a queue
    bound of 3 for 5 s; the queue depth never exceeds the bound, the
    excess is rejected with the named ``ServerBusyError``, and the
    priority-1 client keeps completing leases."""
    from mpi_tpu_torch.errors import ServerBusyError

    monkeypatch.setenv("MPI_TPU_DEVICE", "cpu")
    pool, max_pending, duration_s, nflood = 2, 3, 5.0, 8
    counts = {"flood_ok": 0, "flood_busy": 0, "flood_timeout": 0,
              "good_ok": 0, "good_busy": 0}
    max_waiting_seen = [0]
    lock = threading.Lock()
    errors = []
    with serve.WorldServer(pool_size=pool, backend="socket",
                           detect_timeout_s=1.5, heartbeat_s=0.2,
                           world_lease_timeout_s=8.0,
                           max_pending=max_pending) as srv:
        stop = threading.Event()

        def flood():
            client = serve.connect(srv)
            while not stop.is_set():
                try:
                    lease = client.acquire(1, timeout=1.5)
                    try:
                        lease.run(serve.job_sleep, 0.15, timeout=6.0)
                        with lock:
                            counts["flood_ok"] += 1
                    finally:
                        lease.release()
                except ServerBusyError:
                    with lock:
                        counts["flood_busy"] += 1
                    time.sleep(0.05)
                except TimeoutError:
                    with lock:
                        counts["flood_timeout"] += 1
                except Exception as e:  # noqa: BLE001 - asserted below
                    if not stop.is_set():
                        errors.append(e)
                    break
            client.close()

        def good():
            client = serve.connect(srv, priority=1)
            while not stop.is_set():
                try:
                    lease = client.acquire(1, timeout=6.0)
                    try:
                        lease.run(serve.job_sleep, 0.02, timeout=6.0)
                        with lock:
                            counts["good_ok"] += 1
                    finally:
                        lease.release()
                except ServerBusyError:
                    with lock:
                        counts["good_busy"] += 1
                    time.sleep(0.05)
                except Exception as e:  # noqa: BLE001 - asserted below
                    if not stop.is_set():
                        errors.append(e)
                    break
                time.sleep(0.05)
            client.close()

        def sampler():
            while not stop.is_set():
                st = srv.stats()
                with lock:
                    max_waiting_seen[0] = max(max_waiting_seen[0],
                                              st["waiting"])
                time.sleep(0.05)

        threads = [threading.Thread(target=flood, daemon=True)
                   for _ in range(nflood)]
        threads += [threading.Thread(target=good, daemon=True),
                    threading.Thread(target=sampler, daemon=True)]
        for th in threads:
            th.start()
        time.sleep(duration_s)
        stop.set()
        for th in threads:
            th.join(timeout=20.0)
        assert not any(th.is_alive() for th in threads)
        st = srv.stats()
    assert not errors, errors
    good_floor = max(2, int(duration_s * 1.0))
    assert st["busy_rejected"] > 0
    assert max_waiting_seen[0] <= max_pending
    assert counts["good_ok"] >= good_floor, counts
    assert counts["flood_timeout"] + counts["flood_ok"] \
        + counts["flood_busy"] > 0


# -- parity with the reference ------------------------------------------------


def _store_ops(fstore_mod, root, seed, clock):
    """A seeded sequence of store operations on one ``FileStore``; returns
    what each returned (Recs as tuples)."""
    rng = np.random.default_rng(seed)
    st = fstore_mod.FileStore(root)
    keys = ["leader.lease", "server.a", "server.b", "pool.p0", "takeover.a"]
    out = []
    for i in range(200):
        clock[0] += float(rng.uniform(0.001, 0.5))
        if i == 150:
            clock[0] += 120.0  # past the tombstone GC horizon
        key = keys[int(rng.integers(len(keys)))]
        op = int(rng.integers(6))
        val = {"i": i, "x": float(rng.standard_normal()),
               "tag": f"t{int(rng.integers(100))}"}
        if op == 0:
            cur = st.get(key)
            ev = None if cur is None else cur.ver
            if rng.random() < 0.3 and ev is not None:
                ev -= 1  # a stale expectation: must lose
            got = st.cas(key, ev, val)
        elif op == 1:
            got = st.put(key, val)
        elif op == 2:
            got = st.delete(key, None if rng.random() < 0.5
                            else (st.get(key) or (0, 0, 0))[1])
        elif op == 3:
            st.append(f"leader.log.{key}", val)
            got = None
        elif op == 4:
            got = sorted((k, tuple(r)) for k, r in st.scan("").items())
        else:
            got = sorted(st.log_scan("leader.log.").items())
        out.append((op, key, tuple(got) if isinstance(got, tuple) else got))
    return out


def _files(root):
    return {n: open(os.path.join(root, n), "rb").read()
            for n in sorted(os.listdir(root))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filestore_writes_the_references_files(tmp_path, monkeypatch, seed):
    from mpi_tpu import federation_store as ref_fstore
    from mpi_tpu_torch import federation_store as fstore

    results = []
    for mod, name in ((ref_fstore, "ref"), (fstore, "port")):
        clock = [1.7e9]
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
        results.append((_store_ops(mod, str(tmp_path / name), seed, clock),
                        _files(str(tmp_path / name))))
        monkeypatch.undo()
    (want_ops, want_files), (got_ops, got_files) = results
    assert got_ops == want_ops
    assert list(got_files) == list(want_files)
    assert got_files == want_files
    assert any(n.endswith(".json") for n in got_files)
    assert any(n.startswith("leader.log.") for n in got_files)


def _records(fed_mod, ns, now):
    """Endpoint records of every liveness case, a lease and a pool."""
    st = fed_mod._store(ns)
    me = os.getpid()
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    summary = {"pools": 1, "workers": 2, "idle": 1, "leases_active": 1,
               "waiting": 3, "worlds_per_s": 1.25, "backend": "socket"}
    for sid, pid, host, age, lead in (
            ("live", me, None, 0.5, True), ("stale", me, None, 30.0, False),
            ("dead", dead.pid, None, 0.1, False),
            ("remote", 1, "other-host", 2.0, False),
            ("quiet", me, None, 9.0, False)):
        rec = {"id": sid, "pid": pid, "ctrl": f"127.0.0.1:{1000 + len(sid)}",
               "renewed_at": now - age, "is_leader": lead,
               "summary": summary}
        if host is not None:
            rec["host"] = host
        st.put(f"server.{sid}", rec)
    st.put("leader.lease", {"id": "live", "pid": me, "term": 4})
    fed_mod.write_pool_owner(ns, "p0", "live", "127.0.0.1:1", "/r", "socket",
                             2, 1, 4, since=now)


def test_federation_stats_is_the_references(tmp_path, monkeypatch):
    from mpi_tpu import federation as ref_federation

    now = 1.7e9
    monkeypatch.setattr(time, "time", lambda: now)
    ns = str(tmp_path / "ns")
    _records(ref_federation, ns, now)
    want = ref_federation.federation_stats(ns)
    got = federation.federation_stats(ns)
    assert got == want
    assert got["servers_live"] == 3 and got["leader_term"] == 4
    assert {s: r["live"] for s, r in got["servers"].items()} == {
        "dead": False, "live": True, "quiet": True, "remote": True,
        "stale": False}
    # and records the port wrote read the same in the reference
    ns2 = str(tmp_path / "ns2")
    _records(federation, ns2, now)
    assert ref_federation.federation_stats(ns2) == \
        federation.federation_stats(ns2)


def test_federated_scrape_is_the_references(tmp_path, monkeypatch):
    from mpi_tpu import mpit as ref_mpit
    from mpi_tpu.telemetry import metrics as ref_metrics
    from mpi_tpu_torch import mpit
    from mpi_tpu_torch.telemetry import metrics

    monkeypatch.setenv("MPI_TPU_DEVICE", "cpu")
    with serve.WorldServer(pool_size=1, federation=str(tmp_path / "ns"),
                           server_id="m", detect_timeout_s=DETECT_S,
                           heartbeat_s=0.2) as srv:
        assert srv.stats()["federation"]["servers_live"] == 1
        with serve.connect(srv) as c:
            assert c.run(serve.job_allreduce, 8, nranks=1,
                         timeout=30.0) == 1.0
        stats = _wait(lambda: (lambda st: (
            st["is_leader"] and st["federation"]["worlds_per_s"] > 0
            and st["federation"]["servers"]["m"]["is_leader"] and st))(
                srv.stats()), 10.0, "leadership and the rate in the record")
    for m in (ref_mpit, mpit):
        m.pvar_hist_reset("lease_acquire_s")
        m.hist_record("lease_acquire_s", 2e-3)
    text = metrics.prometheus_text(stats)
    assert text.encode() == ref_metrics.prometheus_text(stats).encode()
    fed = stats["federation"]
    gauges = {line.split(" ")[0][len("mpi_tpu_fed_"):]: float(line.split(" ")[1])
              for line in text.splitlines()
              if line.startswith("mpi_tpu_fed_") and "{" not in line}
    assert gauges == {k: float(fed[k]) for k in metrics._FED_GAUGE_KEYS}
    assert 'mpi_tpu_fed_server_live{server="m",leader="true"} 1' in text
    assert "mpi_tpu_serve_is_leader 1" in text


def test_store_pvars_read_zero_without_a_node_and_count_with_one():
    """The five store pvars (``mpi_tpu/mpit.py:409-428``) read 0 in a
    process without a raft node (a fresh interpreter), and a partitioned
    in-process fabric moves them."""
    res = subprocess.run(
        [sys.executable, "-c",
         "from mpi_tpu_torch import mpit; import sys; "
         "print([mpit.pvar_read(p) for p in ('store_elections', "
         "'store_entries_truncated', 'store_partition_dropped', "
         "'store_term', 'store_commit_index')], "
         "'mpi_tpu_torch.federation_store' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("]")[0] + "]" == "[0, 0, 0, 0, 0]"
    assert res.stdout.strip().endswith("False")

    import socket

    from mpi_tpu_torch import federation_store as fstore
    from mpi_tpu_torch import mpit

    before = {p: mpit.pvar_read(p) for p in (
        "store_elections", "store_partition_dropped")}
    socks = [socket.socket() for _ in range(3)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    addrs = ["127.0.0.1:%d" % sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    nodes = [fstore.RaftNode(i, addrs, elect_timeout_s=0.3) for i in range(3)]
    try:
        store = fstore.RaftStore(nodes[0], owns_node=False)
        rec = None
        deadline = time.monotonic() + 30.0
        while rec is None:
            assert time.monotonic() < deadline, "no commit"
            try:
                rec = store.put("k", {"v": 1})
            except fstore.NoQuorumError:
                time.sleep(0.05)
        assert mpit.pvar_read("store_term") >= 1
        assert mpit.pvar_read("store_commit_index") >= rec.ver
        # every live node of this process (closed ones of earlier cases
        # may linger until collected)
        assert fstore.install_store_partition({0: 0, 1: 1, 2: 1}) >= 3
        _wait(lambda: mpit.pvar_read("store_partition_dropped")
              > before["store_partition_dropped"], 10.0, "dropped frames")
        fstore.install_store_partition(None)
        assert mpit.pvar_read("store_elections") > before["store_elections"]
    finally:
        for nd in nodes:
            nd.close()


def test_host_federation_example_kill_leader(tmp_path):
    """chip_smoke.py phase 28's program on the CPU: two federated servers,
    a checked lease through the namespace, the leader SIGKILLed, the same
    client leasing on the survivor, the orphans adopted with their pids,
    the scrape equal to ``stats()["federation"]``, a clean shutdown."""
    import json

    out = tmp_path / "fed.json"
    res = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.examples.host_federation",
         "--ns", str(tmp_path / "ns"), "--servers", "2", "--pool-size", "2",
         "--mib", "1", "--device", "cpu", "--require", "cpu",
         "--kill-leader", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(out.read_text())
    kill = got["kill"]
    assert got["ok"] and got["rdv_left"] == []
    assert (kill["pools_adopted"], kill["orphans_reregistered"]) == (1, 2)
    assert kill["orphans_after"] and all(
        tuple(p) in {tuple(q) for q in kill["orphans_before"]}
        for p in kill["orphans_after"])
    assert kill["survivor"] != kill["leader"] and kill["is_leader"] is True
    assert kill["kill_to_adoption_s"] < 6 * FED_LEASE_S + 30.0
    assert got["server_rcs"][kill["survivor"]] == 0
