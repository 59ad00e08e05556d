"""A federation of world servers, checked and timed: the README's
federation usage.  Start N servers on one namespace, lease through the
namespace, kill the leader and lease again through the same client::

    python -m mpi_tpu_torch.examples.host_federation --ns /tmp/fedns \\
        --servers 2 --pool-size 2 --mib 64 --require cuda --kill-leader

    python -m mpi_tpu_torch.examples.host_federation --ns /tmp/fedns \\
        --servers 2 --pool-size 2 --mib 1 --device cpu --require cpu \\
        --kill-leader

Each server is ``python -m mpi_tpu_torch.launcher serve --federation NS
--server-id f<i>`` (on the card unless ``--device`` names one; its workers
take ``slot % device_count``).  Once every endpoint record is live and a
leader holds the lease, ``connect(NS)`` returns a ``FederatedClient`` and
one 2-rank lease runs ``host_serve.job_allreduce_checked`` (``--mib`` MiB
of float32 a rank, every element checked on the workers).  With
``--kill-leader`` the leader's server process (not its workers) is
SIGKILLed and the same client must lease again on a survivor; the dead
server's pool must be adopted (``read_pool_owners``, the survivor's
``pools_adopted`` and ``orphans_reregistered``), its orphaned workers
must keep their pids and their device, a 2-rank lease on the adopted pool
must be exact, the leader-authority log must show no overlap, and the
survivor's ``/metrics`` must give ``mpi_tpu_fed_*`` gauges equal to its
``stats()["federation"]``.  At the end every server is shut down through
its client (the survivor stops the adopted workers too) and no
rendezvous directory or ``/dev/shm`` segment of the run is left.  The result is one JSON line
(and ``--out``); a failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from mpi_tpu_torch import connect, federation, serve
from mpi_tpu_torch.examples.host_serve import job_allreduce_checked

TIMEOUT_S = 120.0   # the acquire's and each job's bound
FED_LEASE_S = 2.0   # the servers' leader-lease bound
DETECT_S = 2.0      # the pools' fault-detection bound
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def job_pids(comm) -> list:
    """Every leased worker's ``(pid, device)``, in lease rank order."""
    return comm.allgather((os.getpid(), str(comm.device)))


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise RuntimeError(f"host_federation: timed out ({timeout} s) "
                               f"waiting for {what}")
        time.sleep(0.05)


def _scrape_fed(addr: str) -> dict:
    """The unlabelled ``mpi_tpu_fed_*`` samples of a ``/metrics`` scrape."""
    import urllib.request

    text = urllib.request.urlopen(f"http://{addr}/metrics",
                                  timeout=10).read().decode()
    out = {}
    for line in text.splitlines():
        if line.startswith("mpi_tpu_fed_") and "{" not in line:
            name, value = line.rsplit(" ", 1)
            out[name[len("mpi_tpu_fed_"):]] = float(value)
    return out


def _devices_ok(devices, require):
    return require is None or all(d.split(":")[0] == require for d in devices)


def start_servers(ns: str, n: int, pool_size: int, workdir: str,
                  device=None) -> list:
    """Start ``n`` federated ``launcher serve`` processes on ``ns``."""
    servers = []
    for i in range(n):
        sid = f"f{i}"
        addr_file = os.path.join(workdir, f"{sid}.addr")
        log = open(os.path.join(workdir, f"{sid}.log"), "wb")
        argv = [sys.executable, "-m", "mpi_tpu_torch.launcher", "serve",
                "--pool-size", str(pool_size), "--backend", "socket",
                "--federation", ns, "--server-id", sid,
                "--fed-lease-timeout", str(FED_LEASE_S),
                "--detect-timeout", str(DETECT_S),
                "--addr-file", addr_file, "--metrics-port", "0"]
        if device is not None:
            argv += ["--device", device]
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=log, stderr=log)
        servers.append({"id": sid, "proc": proc, "addr_file": addr_file,
                        "log": log})
    return servers


def stop_servers(servers: list) -> dict:
    """Shut every live server down through its client (a server stops its
    adopted workers too), then reap; returns each server's exit code."""
    for s in servers:
        if s["proc"].poll() is None and s.get("addr"):
            host, port = s["addr"].rsplit(":", 1)
            try:
                with serve.ServerClient(host, int(port), timeout=10.0,
                                        dial_retry_s=2.0) as c:
                    c.shutdown()
            except OSError:
                pass
    rcs = {}
    for s in servers:
        try:
            rcs[s["id"]] = s["proc"].wait(60.0)
        except subprocess.TimeoutExpired:
            s["proc"].kill()
            rcs[s["id"]] = s["proc"].wait(10.0)
        s["log"].close()
    return rcs


def run(ns: str, servers: list, pool_size: int, nranks: int, mib: int,
        require, kill_leader: bool) -> dict:
    """The checked story on started servers; raises on a failed check."""
    t0 = time.perf_counter()
    for s in servers:
        _wait(lambda: os.path.exists(s["addr_file"])
              or s["proc"].poll() is not None, 180.0,
              f"{s['id']}'s address file")
        if s["proc"].poll() is not None:
            raise RuntimeError(f"server {s['id']} exited with "
                               f"{s['proc'].returncode} before publishing")
        with open(s["addr_file"]) as f:
            s["addr"] = f.read().strip()
    _wait(lambda: len([r for r in federation.read_server_records(ns).values()
                       if federation.record_live(r)]) == len(servers),
          60.0, "every endpoint record live")
    leader_id = _wait(lambda: (federation.read_leader(ns) or {}).get("id"),
                      30.0, "a leader")
    res = {"servers": len(servers), "pool_size": pool_size, "nranks": nranks,
           "fabric_up_s": time.perf_counter() - t0, "leader": leader_id}
    want = nranks * (nranks + 1) / 2.0
    client = connect(ns)
    if not isinstance(client, federation.FederatedClient):
        raise RuntimeError(f"connect({ns!r}) gave {type(client).__name__}")
    try:
        t1 = time.perf_counter()
        big = client.run(job_allreduce_checked, mib, nranks=nranks,
                         timeout=TIMEOUT_S)
        head = big.pop("head")
        big["head"] = head.tolist()
        res["lease"] = {**big, "wall_ms": (time.perf_counter() - t1) * 1e3,
                        "server": client.addr}
        if not (all(big["ok"]) and big["head"] == [want] * 4
                and _devices_ok(big["devices"], require)):
            raise RuntimeError(f"the first lease: {big}")
        if kill_leader:
            res["kill"] = _kill_leader(ns, servers, leader_id, client,
                                       pool_size, nranks, want, require,
                                       mib)
    finally:
        client.close()
    return res


def _kill_leader(ns, servers, leader_id, client, pool_size, nranks, want,
                 require, mib):
    # the job by its import path: run as __main__, this module's own names
    # would pickle as __main__.*, which no worker can import
    from mpi_tpu_torch.examples.host_federation import job_pids

    leader = next(s for s in servers if s["id"] == leader_id)
    owners = federation.read_pool_owners(ns)
    dead_pools = sorted(p for p, r in owners.items()
                        if r["owner"] == leader_id)
    # the leader's workers, before the kill: a lease of its whole pool
    host, port = leader["addr"].rsplit(":", 1)
    with serve.ServerClient(host, int(port)) as lc:
        before = lc.run(job_pids, nranks=pool_size, timeout=TIMEOUT_S)
    failovers = client.failovers
    os.kill(leader["proc"].pid, signal.SIGKILL)
    t_kill = time.perf_counter()
    leader["proc"].wait(30.0)  # reaped: its endpoint record's pid is dead
    # the same client, on a survivor
    big = client.run(job_allreduce_checked, mib, nranks=nranks,
                     timeout=TIMEOUT_S)
    kill_to_lease_s = time.perf_counter() - t_kill
    head = big.pop("head")
    big["head"] = head.tolist()
    if not (all(big["ok"]) and big["head"] == [want] * 4
            and _devices_ok(big["devices"], require)):
        raise RuntimeError(f"the lease after the kill: {big}")
    survivor = next(s for s in servers if s["id"] != leader_id
                    and s["proc"].poll() is None)
    shost, sport = survivor["addr"].rsplit(":", 1)
    with serve.ServerClient(shost, int(sport)) as sc:
        def adopted():
            own = federation.read_pool_owners(ns)
            st = sc.stats()
            return (all(own.get(p, {}).get("owner") == survivor["id"]
                        for p in dead_pools)
                    and st["pools_adopted"] >= 1
                    and st["orphans_reregistered"] >= pool_size
                    and st["idle"] == sum(p["size"]
                                          for p in st["pools"].values())
                    # the survivor's endpoint record renewed since
                    and st["federation"]["pools"] == len(st["pools"])
                    and st)

        st = _wait(adopted, 6 * FED_LEASE_S + 30.0, "the pool's adoption")
        kill_to_adoption_s = time.perf_counter() - t_kill
        if (st["pools_adopted"], st["orphans_reregistered"]) != (1, pool_size):
            raise RuntimeError(f"the survivor's counts: pools_adopted "
                               f"{st['pools_adopted']}, orphans_reregistered "
                               f"{st['orphans_reregistered']}")
        # two concurrent leases land on different pools (a lease never
        # spans pools): one of them runs on the adopted orphans
        la = sc.acquire(nranks, timeout=TIMEOUT_S)
        lb = sc.acquire(nranks, timeout=TIMEOUT_S)
        try:
            on = {la.pool: la, lb.pool: lb}
            if not set(dead_pools) <= set(on):
                raise RuntimeError(f"no lease on the adopted pool "
                                   f"{dead_pools}: {sorted(on)}")
            orphan_lease = on[dead_pools[0]]
            after = orphan_lease.run(job_pids, timeout=TIMEOUT_S)
            adopted_big = orphan_lease.run(job_allreduce_checked, mib,
                                           timeout=TIMEOUT_S)
        finally:
            la.release()
            lb.release()
        adopted_head = adopted_big.pop("head")
        adopted_big["head"] = adopted_head.tolist()
        if not {tuple(p) for p in after} <= {tuple(p) for p in before} \
                or not _devices_ok([d for _, d in after], require):
            raise RuntimeError(f"the orphans changed: before {before}, "
                               f"after {after}")
        if not (all(adopted_big["ok"])
                and adopted_big["head"] == [want] * 4):
            raise RuntimeError(f"the lease on the adopted pool: "
                               f"{adopted_big}")
        intervals = federation.assert_no_leader_overlap(ns)
        # the scrape against stats(): records renew every tick, so read
        # until a scrape lands between two equal stats() documents
        keys = ("servers_total", "servers_live", "worlds_per_s", "workers",
                "idle", "pools", "leases_active", "waiting", "leader_term")
        metrics = None
        for _ in range(50):
            fed0 = sc.stats()["federation"]
            scraped = _scrape_fed(st["metrics_addr"])
            fed1 = sc.stats()["federation"]
            want_g = {k: float(fed0[k]) for k in keys}
            if want_g == {k: float(fed1[k]) for k in keys} \
                    and {k: scraped.get(k) for k in keys} == want_g:
                metrics = {"scrape": scraped, "federation": want_g}
                break
            time.sleep(0.1)
        if metrics is None:
            raise RuntimeError(f"the mpi_tpu_fed_* scrape never equalled "
                               f"stats()['federation']: {scraped} vs {fed0}")
        final = sc.stats()
    return {"leader": leader_id, "survivor": survivor["id"],
            "adopted_pools": dead_pools,
            "kill_to_lease_s": kill_to_lease_s,
            "kill_to_adoption_s": kill_to_adoption_s,
            "lease_after_kill": big, "failovers": client.failovers - failovers,
            "orphans_before": before, "orphans_after": after,
            "adopted_lease": adopted_big,
            "pools_adopted": final["pools_adopted"],
            "orphans_reregistered": final["orphans_reregistered"],
            "is_leader": final["is_leader"],
            "leader_term": final["federation"]["leader_term"],
            "authority_intervals": len(intervals), "metrics": metrics}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ns", default=None,
                    help="the namespace directory (default: a fresh one)")
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--pool-size", type=int, default=2)
    ap.add_argument("--nranks", type=int, default=2)
    ap.add_argument("--mib", type=int, default=64,
                    help="float32 MiB a rank of the checked allreduce")
    ap.add_argument("--device", default=None,
                    help="every worker's device (launcher serve --device); "
                         "default: card slot %% device_count")
    ap.add_argument("--require", default=None, choices=("cuda", "cpu"),
                    help="the device type every worker must report")
    ap.add_argument("--kill-leader", action="store_true",
                    help="SIGKILL the leader's server and lease again")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.kill_leader and args.servers < 2:
        ap.error("--kill-leader needs a survivor: --servers 2 or more")
    if args.nranks > args.pool_size:
        ap.error("--nranks must fit one pool: a lease never spans pools")

    workdir = tempfile.mkdtemp(prefix="mtt_fed_example_")
    ns = args.ns or os.path.join(workdir, "ns")
    servers = start_servers(ns, args.servers, args.pool_size, workdir,
                            device=args.device)
    res, err, rdvs = None, None, set()
    try:
        res = run(ns, servers, args.pool_size, args.nranks, args.mib,
                  args.require, args.kill_leader)
        rdvs = {r["rdv"] for r in federation.read_pool_owners(ns).values()}
    except Exception as e:  # noqa: BLE001 - reported after the shutdown
        err = e
    finally:
        rcs = stop_servers(servers)
        logs = "".join(open(s["log"].name, errors="replace").read()[-2000:]
                       for s in servers)
        shutil.rmtree(workdir, ignore_errors=True)
    if err is not None:
        print(f"host_federation: {type(err).__name__}: {err}\n{logs}",
              file=sys.stderr)
        return 1
    from mpi_tpu_torch.transport.shm import shm_prefix

    leftover = sorted(p for p in rdvs if os.path.exists(p))
    leftover += sorted(
        n for n in (os.listdir("/dev/shm") if os.path.isdir("/dev/shm")
                    else ())
        for p in rdvs
        if n.startswith(shm_prefix(os.path.basename(p.rstrip("/")))))
    res["server_rcs"] = rcs
    res["rdv_left"] = leftover
    res["ok"] = not leftover and all(
        rc == 0 for sid, rc in rcs.items()
        if sid != (res.get("kill") or {}).get("leader"))
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    if not res["ok"]:
        print(f"host_federation: shutdown: server exit codes {rcs}, "
              f"rendezvous dirs and segments left {leftover}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
