"""The port's elastic membership against the reference's
(``tests/test_membership.py`` without its shm cases, ROADMAP 16.4): the
rendezvous protocol files (claim, announce, refusal until
``failure_ack``, a claimer that died mid-handshake, a double rejoin, the
incarnation registry) run through both packages' ``membership`` modules
alike; the epoch bookkeeping of shrink on the local world, bitwise and
epoch for epoch against the reference's ``run_local``; the socket
transport's epoch-stamped hello (a stale straggler's EpochSkewError, a
survivor's transition dropping its endpoints) against the reference's
socket transport; and the whole story in rank processes on the CPU —
kill, detect, revoke, shrink, agree, ``accept_rejoin`` and a fresh
process's ``membership.rejoin`` into the vacant slot at epoch 1."""

import os
import time

import numpy as np
import pytest

from mpi_tpu import membership as ref_membership
from mpi_tpu import mpit as ref_mpit
from mpi_tpu.errors import EpochSkewError as RefEpochSkew
from mpi_tpu.errors import RejoinRefusedError as RefRefused
from mpi_tpu.transport.base import TransportError as RefTransportError
from mpi_tpu.transport.socket import SocketTransport as RefSocket
from mpi_tpu_torch import membership, mpit
from mpi_tpu_torch.errors import EpochSkewError, RejoinRefusedError
from mpi_tpu_torch.transport.base import TransportError
from mpi_tpu_torch.transport.socket import SocketTransport
from tests.test_torch_host_ft import _killed, wait_failed
from tests.test_torch_host_local import assert_same, seeded
from tests.test_torch_host_nbc import PORT, REF, cvars  # noqa: F401

DETECT_S = 0.5


@pytest.fixture(autouse=True)
def tight_detection(cvars):
    cvars("fault_detect_timeout_s", DETECT_S)
    cvars("fault_heartbeat_interval_s", 0.05)


# each package's membership module with its own error classes
MODS = [pytest.param((ref_membership, RefRefused), id="reference"),
        pytest.param((membership, RejoinRefusedError), id="port")]


def _dir(tmp_path, mod):
    d = tmp_path / mod.__name__.replace(".", "_")
    d.mkdir()
    return str(d)


# -- protocol files ----------------------------------------------------------


@pytest.mark.parametrize("mod", MODS)
def test_claim_is_exclusive(tmp_path, mod):
    m, _ = mod
    rdv = _dir(tmp_path, m)
    assert m.claim_slot(rdv, 1, 2, inc="aaa")
    assert not m.claim_slot(rdv, 1, 2, inc="aaa")
    assert not m.claim_slot(rdv, 1, 2, inc="bbb")
    assert m.claim_slot(rdv, 1, 3, inc="bbb")
    assert m.claim_slot(rdv, 2, 2, inc="ccc")
    assert m.read_claim(rdv, 1, 2)["incarnation"] == "aaa"


@pytest.mark.parametrize("mod", MODS)
def test_announce_roundtrip_and_latest(tmp_path, mod):
    m, _ = mod
    rdv = _dir(tmp_path, m)
    m.announce_rejoin(rdv, 1, {2: {"ousted": None, "acked": False}}, 4, "socket")
    m.announce_rejoin(rdv, 3, {1: {"ousted": "xyz", "acked": True}}, 4, "socket")
    assert m.read_announce(rdv, 1)["backend"] == "socket"
    latest = m.latest_announce(rdv)
    assert latest["epoch"] == 3 and latest["slots"]["1"]["ousted"] == "xyz"


@pytest.mark.parametrize("mod", MODS)
def test_false_suspicion_refused_until_acked(tmp_path, mod):
    m, Refused = mod
    rdv = _dir(tmp_path, m)
    slots = {1: {"ousted": "live-zombie", "acked": False}}
    m.announce_rejoin(rdv, 1, slots, 3, "socket")
    assert m.claim_slot(rdv, 1, 1, inc="live-zombie")
    m.process_claims(rdv, 1, slots)
    with pytest.raises(Refused, match="failure_ack"):
        m.wait_admitted(rdv, 1, 1, "live-zombie", time.monotonic() + 5.0)
    assert m.claim_slot(rdv, 1, 1, inc="fresh-worker")
    m.process_claims(rdv, 1, slots)
    m.wait_admitted(rdv, 1, 1, "fresh-worker", time.monotonic() + 5.0)
    slots2 = {2: {"ousted": "live-zombie", "acked": True}}
    m.announce_rejoin(rdv, 2, slots2, 3, "socket")
    assert m.claim_slot(rdv, 2, 2, inc="live-zombie")
    m.process_claims(rdv, 2, slots2)
    m.wait_admitted(rdv, 2, 2, "live-zombie", time.monotonic() + 5.0)


@pytest.mark.parametrize("mod", MODS)
def test_dead_claimers_are_swept(tmp_path, mod):
    """A claimer that died between claim and ready, or right after ready,
    is swept by the validation pass: the slot is claimed again under the
    same epoch and the replacement completes the handshake."""
    m, _ = mod
    rdv = _dir(tmp_path, m)
    slots = {0: {"ousted": None, "acked": False}}
    assert m.claim_slot(rdv, 1, 0, inc="doomed", pid=2 ** 22 + 17)
    m.process_claims(rdv, 1, slots)
    assert m.claim_slot(rdv, 1, 0, inc="ghost", pid=2 ** 22 + 23)
    m.publish_ready(rdv, 1, 0, inc="ghost")
    m.process_claims(rdv, 1, slots)
    assert m.claim_slot(rdv, 1, 0, inc="replacement")
    m.process_claims(rdv, 1, slots)
    m.wait_admitted(rdv, 1, 0, "replacement", time.monotonic() + 5.0)
    m.publish_ready(rdv, 1, 0, inc="replacement")
    m.wait_ready(rdv, 1, slots, time.monotonic() + 5.0, validate=True)


@pytest.mark.parametrize("mod", MODS)
def test_double_rejoin_same_worker_id_refused(tmp_path, monkeypatch, mod):
    m, Refused = mod
    rdv = _dir(tmp_path, m)
    m.announce_rejoin(rdv, 1, {0: {"ousted": None, "acked": False}}, 2, "socket")
    monkeypatch.setattr(m, "_PROCESS_INCARNATION", "me-again")
    m.publish_ready(rdv, 1, 0, inc="me-again")
    with pytest.raises(Refused, match="double rejoin"):
        m.rejoin_transport(rdv, slot=0, epoch=1, timeout=2.0)


@pytest.mark.parametrize("mod", MODS)
def test_incarnation_registry_and_heartbeat_age(tmp_path, mod):
    m, _ = mod
    rdv = _dir(tmp_path, m)
    inc = m.publish_incarnation(rdv, 3)
    assert m.read_incarnation(rdv, 3) == inc
    assert m.read_incarnation(rdv, 4) is None
    assert m.publish_incarnation(rdv, 5) == inc  # one identity per process
    assert m.heartbeat_age(rdv, 0) is None
    open(os.path.join(rdv, "hb.0"), "w").close()
    assert 0 <= m.heartbeat_age(rdv, 0) < 60


# -- epoch bookkeeping (local world) -----------------------------------------


def test_shrink_bumps_membership_epoch_and_acks_world_level():
    data = seeded(3, (6,), np.float32, seed=9)

    def prog(c, m):
        start = c.membership_epoch
        if c.rank == 1:
            raise _killed(m)
        wait_failed(c, [1])
        acked_before = set(c._ft.world.acked_world)
        c.failure_ack()
        new = c.shrink()
        return (start, c.membership_epoch, new.membership_epoch, c._t.epoch,
                acked_before, set(c._ft.world.acked_world),
                new.allreduce(m.arr(data[c.rank])))

    out = {pkg.port: pkg.run(prog, 3, fault_tolerance=True) for pkg in (REF, PORT)}
    for r in (0, 2):
        assert_same(out[False][r], out[True][r], f"rank {r}")
        assert out[True][r][:6] == (0, 1, 1, 1, set(), {1})


def test_subcomm_shrink_does_not_bump_epoch():
    def prog(c, m):
        sub = c.split(0 if c.rank < 2 else None)
        if c.rank == 2:
            return "bystander"
        if c.rank == 1:
            raise _killed(m)
        t0 = time.monotonic()
        while 1 not in c.get_failed():
            assert time.monotonic() - t0 < 6 * DETECT_S
            time.sleep(0.02)
        shrunk_sub = sub.shrink()
        after_sub = c.membership_epoch
        new = c.shrink()
        return (shrunk_sub.size, after_sub, c.membership_epoch,
                new._ctx in c._t._gen_ctxs)

    for pkg in (REF, PORT):
        res = pkg.run(prog, 3, fault_tolerance=True)
        assert res[0] == (1, 0, 1, True) and res[2] == "bystander", (pkg.port, res)


# -- socket epoch stamping (in process) --------------------------------------


def _socket(port, rank, size, rdv, **kw):
    return (SocketTransport(rank, size, rdv, device="cpu", **kw) if port
            else RefSocket(rank, size, rdv, **kw))


@pytest.mark.parametrize("port", [False, True], ids=["reference", "port"])
def test_socket_stale_straggler_diagnosed(tmp_path, port, cvars):
    cvars("epoch_grace_s", 0.2)
    rdv = _dir(tmp_path, membership if port else ref_membership)
    m = mpit if port else ref_mpit
    base = m.pvar_read("epoch_skews_detected")
    survivor = _socket(port, 0, 2, rdv, epoch=2)
    survivor.min_peer_epoch[1] = 2
    straggler = _socket(port, 1, 2, rdv, epoch=0)
    try:
        with pytest.raises(EpochSkewError if port else RefEpochSkew) as ei:
            straggler.send(0, 0, 5, b"stale hello")
        assert (ei.value.local_epoch, ei.value.peer_epoch, ei.value.peer) == (0, 2, 0)
        assert m.pvar_read("epoch_skews_detected") > base
    finally:
        survivor.close()
        straggler.close()


@pytest.mark.parametrize("port", [False, True], ids=["reference", "port"])
def test_socket_survivor_transition_drops_endpoints(tmp_path, port):
    mod = membership if port else ref_membership
    rdv = _dir(tmp_path, mod)
    a = _socket(port, 0, 2, rdv)
    b = _socket(port, 1, 2, rdv)
    try:
        a.send(1, 0, 7, b"warm the connection")
        assert b.recv(0, 0, 7)[0] == b"warm the connection"
        assert 1 in a._conns
        mod.survivor_transition(a, 1, [1])
        assert a.epoch == 1 and a.min_peer_epoch[1] == 1
        assert 1 not in a._conns
        # the replaced slot's OLD incarnation (epoch 0) is never adopted
        a._connect_timeout = 1.0
        with pytest.raises(TransportError if port else RefTransportError,
                           match="epoch >= 1"):
            a.send(1, 0, 8, b"nobody new there yet")
    finally:
        a.close()
        b.close()


# -- the whole story in rank processes ----------------------------------------


def test_rejoin_e2e_socket_processes(tmp_path):
    """4 socket rank processes on the CPU (``MPI_TPU_FT=1``,
    ``MPI_TPU_PROGRESS=thread``): rank 1 ``os._exit(42)``s inside a ring
    allreduce; rank 0 gets ProcFailedError naming it, ranks 2-3
    RevokedError, within 3 x the detection bound + 8 s; the survivors
    shrink to epoch 1, agree, allreduce (float64-checked, bitwise across
    ranks); a fresh process rejoins slot 1 at epoch 1 and the full
    world's allreduce is checked the same way — the reference's
    ``test_rejoin_e2e`` and ``test_kill_mid_allreduce_detect_revoke_shrink``
    on the port."""
    from mpi_tpu_torch.examples import host_ft

    res = host_ft.drive(str(tmp_path / "out"), ranks=4, mib=1, device="cpu",
                        detect=2.0, heartbeat=0.2, timeout=120.0)
    recs = res["records"]
    assert "rank 1: exit code 42" in res["exit_summary"]
    assert recs[0]["outcome"] == "ProcFailedError" and recs[0]["failed"] == [1]
    assert recs[0]["collective"] == "allreduce"
    assert recs[2]["outcome"] == recs[3]["outcome"] == "RevokedError"
    for r in (0, 2, 3):
        assert recs[r]["detect_s"] < 3 * 2.0 + 8.0
        pv = recs[r]["pvars"]
        assert pv["shrinks_completed"] == pv["rejoins_completed"] == 1
        assert pv["nbc_threads_spawned"] == 0 and pv["progress_wakeups"] > 0
    assert recs["joiner"]["rank"] == 1 and recs["joiner"]["epoch"] == 1
    assert recs["joiner"]["rejoins_completed"] == 1


def test_rejoin_e2e_shm_processes(tmp_path):
    """The same story over the native shm rings (the reference's
    ``test_rejoin_e2e[shm]`` and ``test_kill_mid_allreduce_detect_revoke_shrink[shm]``):
    detection through the heartbeat files, not the ring's stall bound;
    the survivors recreate their inbound rings from the dead slot and
    re-stamp their readiness at epoch 1 before the joiner opens them."""
    from mpi_tpu_torch.examples import host_ft

    res = host_ft.drive(str(tmp_path / "out"), ranks=4, mib=1, device="cpu",
                        detect=2.0, heartbeat=0.2, timeout=120.0,
                        backend="shm")
    recs = res["records"]
    assert "rank 1: exit code 42" in res["exit_summary"]
    assert recs[0]["outcome"] == "ProcFailedError" and recs[0]["failed"] == [1]
    assert recs[2]["outcome"] == recs[3]["outcome"] == "RevokedError"
    for r in (0, 2, 3):
        assert recs[r]["detect_s"] < 3 * 2.0 + 8.0
        assert recs[r]["pvars"]["rejoins_completed"] == 1
    assert recs["joiner"]["rank"] == 1 and recs["joiner"]["epoch"] == 1
