"""The port's rendezvous plane (``dmlc_tpu_torch/rendezvous``: the
service, its client and the elastic rules) and the launcher and
supervisor wiring around it, held to the reference's
``tests/test_elastic.py``: ``TestElasticRecovery`` (a killed worker's
replacement replays the identical stream; a partial run is a prefix),
``TestRendezvousMembership`` (deterministic ranks, monotonic epochs,
heartbeat-grace flap suppression, the epoch fence, the peer tier's dead
rank), ``test_shrink_gang_byte_identical_coverage`` and
``test_grow_reshard_visible_on_trace_gang_and_ledger``, whose ledger
check is left out: the control ledger is the analytic obs planes', which
the port does not have.

Beside the twins, across the packages: the port's client joins the
reference's service (and the reference's the port's) and sees the same
ranks and epochs as the reference's client; ``assign_parts``,
``owner_of``, ``resume_skip``, ``reshard_plan`` and ``content_owner``
agree over a seeded grid; a real ``launch_local(rendezvous=True)`` gang
shrinks at once when a member dies (the supervisor's death report), and
an epoch bump refreshes the process peer tier. Every wait is bounded.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dmlc_tpu_torch import rendezvous as rndv
from dmlc_tpu_torch.rendezvous import RendezvousClient, elastic
from dmlc_tpu_torch.rendezvous import service as rsvc
from dmlc_tpu_torch.rendezvous.service import RendezvousService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the worker prints one line per block: "<blocks_done> <running_hash>"
_WORKER = r"""
import hashlib, sys
from dmlc_tpu_torch.data.parser import Parser
uri, part, nparts, seed, epoch = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), int(sys.argv[4]),
                                  int(sys.argv[5]))
h = hashlib.sha256()
p = Parser.create(uri, part, nparts, format="libsvm", chunk_size=65536)
n = 0
for _ in range(epoch + 1):       # deterministic epoch replay
    p.before_first()
    while p.next():
        h.update(p.value().copy().content_hash().encode())
        n += 1
        print(f"{n} {h.hexdigest()}", flush=True)
if hasattr(p, "destroy"):
    p.destroy()
"""

_SHUFFLE_WORKER = r"""
import hashlib, sys
from dmlc_tpu_torch.io.input_split_shuffle import InputSplitShuffle
uri, part, nparts, seed, epoch = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), int(sys.argv[4]),
                                  int(sys.argv[5]))
sp = InputSplitShuffle.create(uri, part, nparts, "text",
                              num_shuffle_parts=4, seed=seed)
h = hashlib.sha256()
for e in range(epoch + 1):       # epoch-reshuffled but seed-deterministic
    sp.before_first()
    n = 0
    while True:
        rec = sp.next_record()
        if rec is None:
            break
        h.update(rec)
        n += 1
        print(f"{n} {h.hexdigest()}", flush=True)
"""


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    rng = np.random.RandomState(3)
    lines = [f"{i % 2} " + " ".join(
        f"{j}:{rng.rand():.5f}"
        for j in np.sort(rng.choice(500, rng.randint(1, 9), replace=False)))
        for i in range(30000)]
    p = tmp_path_factory.mktemp("el") / "d.libsvm"
    p.write_bytes(("\n".join(lines) + "\n").encode())
    return str(p)


def _env():
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}


def _run_worker(code, args, kill_after_lines=None, timeout=120):
    """Run the worker; optionally SIGKILL it after N progress lines.
    Returns the progress lines seen."""
    proc = subprocess.Popen([sys.executable, "-c", code]
                            + [str(a) for a in args],
                            env=_env(), stdout=subprocess.PIPE, text=True)
    lines = []
    try:
        deadline = time.monotonic() + timeout
        for line in proc.stdout:
            lines.append(line.strip())
            if kill_after_lines and len(lines) >= kill_after_lines:
                os.kill(proc.pid, signal.SIGKILL)  # die mid-epoch, hard
                break
            if time.monotonic() > deadline:
                raise TimeoutError("worker too slow")
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return lines


@pytest.fixture(autouse=True)
def _no_client():
    """No process rendezvous client or peer tier survives a test."""
    from dmlc_tpu_torch.io.objstore import peer as peer_mod
    rndv.uninstall()
    yield
    rndv.uninstall()
    peer_mod.reset()


class TestElasticRecovery:
    def test_killed_worker_replacement_replays_identical_stream(
            self, data_file):
        clean = _run_worker(_WORKER, [data_file, 1, 3, 0, 0])
        assert len(clean) >= 3, "fixture should produce several blocks"
        killed = _run_worker(_WORKER, [data_file, 1, 3, 0, 0],
                             kill_after_lines=1)
        assert len(killed) >= 1 and killed[0] == clean[0]
        replay = _run_worker(_WORKER, [data_file, 1, 3, 0, 0])
        assert replay == clean, \
            "replacement worker diverged from the killed worker's stream"

    def test_partial_progress_is_a_prefix(self, data_file):
        clean = _run_worker(_WORKER, [data_file, 0, 3, 0, 0])
        killed = _run_worker(_WORKER, [data_file, 0, 3, 0, 0],
                             kill_after_lines=2)
        assert killed == clean[:len(killed)]

    def test_second_epoch_stream_is_deterministic(self, data_file):
        a = _run_worker(_WORKER, [data_file, 2, 3, 0, 1])
        b = _run_worker(_WORKER, [data_file, 2, 3, 0, 1])
        assert a and a == b

    def test_shuffled_split_recovers_by_seed(self, data_file):
        clean = _run_worker(_SHUFFLE_WORKER, [data_file, 0, 2, 7, 1])
        assert len(clean) > 10
        _run_worker(_SHUFFLE_WORKER, [data_file, 0, 2, 7, 1],
                    kill_after_lines=3)
        replay = _run_worker(_SHUFFLE_WORKER, [data_file, 0, 2, 7, 1])
        assert replay == clean
        other = _run_worker(_SHUFFLE_WORKER, [data_file, 0, 2, 8, 1])
        assert other != clean


class TestRendezvousMembership:
    """The service + client unit contracts: deterministic rank
    assignment, monotonic epoch delivery, heartbeat-grace flap
    suppression, and the epoch fence."""

    def test_rank_assignment_deterministic(self):
        with RendezvousService() as s1, RendezvousService() as s2:
            rosters = []
            for svc in (s1, s2):
                for m in ("a", "b", "c"):
                    resp = svc.handle({"op": "join", "gang": "det",
                                       "member": m, "host": "h",
                                       "port": None, "attempt": 0})
                    assert resp["ok"]
                rosters.append(resp["roster"])
            assert rosters[0] == rosters[1]
            assert [e["rank"] for e in rosters[0]] == [0, 1, 2]
        for num_parts in (1, 3, 7, 16):
            for world in (1, 2, 3, 5):
                covered = sorted(
                    p for r in range(world)
                    for p in elastic.assign_parts(num_parts, world, r))
                assert covered == list(range(num_parts))
                for r in range(world):
                    for p in elastic.assign_parts(num_parts, world, r):
                        assert elastic.owner_of(p, world) == r
        plan = elastic.reshard_plan(7, 3, {"0": 5, "3": 2})
        assert plan[0] == [(0, 5), (3, 2), (6, 0)]
        assert sorted(p for parts in plan.values()
                      for p, _ in parts) == list(range(7))

    def test_epoch_monotonic_roster_delivery(self):
        with RendezvousService() as svc:
            epochs = []
            script = [("join", "a"), ("join", "b"), ("join", "c"),
                      ("leave", "b"), ("report_death", "c"),
                      ("join", "a"),  # alive rejoin: NO flap
                      ("join", "d")]
            for op, member in script:
                resp = svc.handle({"op": op, "gang": "mono",
                                   "member": member, "host": "h",
                                   "port": None, "attempt": 0})
                assert resp["ok"]
                assert [e["rank"] for e in resp["roster"]] == \
                    list(range(resp["world"]))
                epochs.append(resp["epoch"])
            assert epochs == [1, 2, 3, 4, 5, 5, 6]
            final = svc.handle({"op": "roster", "gang": "mono"})
            assert [e["member"] for e in final["roster"]] == ["a", "d"]

    def test_heartbeat_grace_flap_suppression(self, monkeypatch):
        with RendezvousService(heartbeat_grace_s=0.8) as svc:
            a = RendezvousClient("127.0.0.1", svc.port, gang="flap",
                                 member="a")
            b = RendezvousClient("127.0.0.1", svc.port, gang="flap",
                                 member="b")
            a.join()
            b.join()
            a.heartbeat()
            assert (a.epoch, a.world) == (2, 2)
            # a flaky wire: EVERY beat's first attempt fails — the
            # rendezvous.* retry seam must absorb it as a counted
            # retry, never as a membership flap
            real = rsvc.call
            calls = {"n": 0}

            def flaky(host, port, payload, timeout_s=2.0):
                calls["n"] += 1
                if calls["n"] % 2 == 1:
                    raise IOError("flaky wire")
                return real(host, port, payload, timeout_s=timeout_s)

            monkeypatch.setattr(rsvc, "call", flaky)
            for _ in range(5):
                assert a.heartbeat() and b.heartbeat()
                time.sleep(0.02)
            assert calls["n"] >= 20  # the flakiness was real
            assert (a.epoch, a.world) == (2, 2), \
                "a retried-but-delivered heartbeat flapped the roster"
            monkeypatch.setattr(rsvc, "call", real)
            deadline = time.monotonic() + 10
            while a.world != 1:
                assert time.monotonic() < deadline, \
                    "grace never reaped the silent member"
                time.sleep(0.05)
                a.heartbeat()
            assert (a.epoch, a.rank) == (3, 0)
            assert b.heartbeat()
            assert (b.epoch, b.world, b.rank) == (4, 2, 1)

    def test_fenced_commit_rejects_stale_epoch(self):
        with RendezvousService() as svc:
            a = RendezvousClient("127.0.0.1", svc.port, gang="fence",
                                 member="a")
            b = RendezvousClient("127.0.0.1", svc.port, gang="fence",
                                 member="b")
            a.join()
            stale = a.epoch
            b.join()  # the roster moves; a's view is now stale
            assert a.commit(5, 10, epoch=stale) is False, \
                "a stale-fenced commit must NOT merge"
            assert a.epoch == b.epoch and a.world == 2
            assert a.progress.get("5", 0) == 0
            assert a.commit(5, 10, epoch=a.epoch) is True
            assert a.progress["5"] == 10

    def test_peer_tier_dead_rank_reassigns_to_survivors(self):
        from dmlc_tpu_torch.io.objstore.peer import PeerTier
        t = PeerTier([7001, 7002, 7003], self_port=7001)
        assert t.owner_index(1) == 1
        t.mark_dead(1)
        assert not t.available(1)
        assert [t.owner_index(g) for g in (1, 4, 7, 10)] == \
            [2, None, 2, None]
        t.refresh([7001, 7003], self_port=7003)
        assert t.self_index == 1
        assert t.available(0) and t.available(1)
        assert t.owner_index(0) == 0 and t.owner_index(1) is None

    def test_epoch_bump_refreshes_the_process_peer_tier(self):
        """A membership change reaches the process peer tier: the roster
        (ranks and serve ports) becomes its topology, with a
        ``gang/member/reshard`` instant, the rendezvous counters and the
        on_change callbacks."""
        from dmlc_tpu_torch.io.objstore import peer as peer_mod
        from dmlc_tpu_torch.obs import trace as obs_trace
        from dmlc_tpu_torch.obs.export import chrome_events
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        peer_mod.reset()
        seen = []
        with RendezvousService() as svc:
            a = RendezvousClient("127.0.0.1", svc.port, gang="tier",
                                 member="a", serve_port=7101)
            b = RendezvousClient("127.0.0.1", svc.port, gang="tier",
                                 member="b", serve_port=7102)
            a.on_change(seen.append)
            a.join()
            r0 = REGISTRY.counter("rendezvous.reshard").value
            rec = obs_trace.start()
            try:
                b.join()
                assert a.heartbeat()
            finally:
                obs_trace.stop()
            t = peer_mod.tier()
            assert t is not None and t.ports == [7101, 7102]
            assert t.self_index == 0
            assert REGISTRY.counter("rendezvous.reshard").value == r0 + 1
            assert [v["world"] for v in seen] == [2]
            assert any(e.get("name") == "gang/member/reshard"
                       for e in chrome_events(rec))
        peer_mod.reset()

    def test_a_joiner_and_the_members_agree_on_ownership(self):
        """Ranks follow join order, serve ports the launcher's order: a
        member joining a gang of two or more takes its tier's topology
        from the roster at once (the reference's client waits for the
        next epoch bump), so after the first member's next beat both
        tiers agree on every group's owner."""
        from dmlc_tpu_torch.io.objstore import peer as peer_mod
        with RendezvousService() as svc:
            first = RendezvousClient("127.0.0.1", svc.port, gang="own",
                                     member="worker-1", serve_port=7202)
            first.join()
            # the second member: this process's tier, built from the
            # env order (worker-0's port first), then its join
            peer_mod.configure(ports=[7201, 7202], self_port=7201)
            second = RendezvousClient("127.0.0.1", svc.port, gang="own",
                                      member="worker-0", serve_port=7201)
            second.join()
            t = peer_mod.tier()
            assert (second.rank, t.ports, t.self_index) == \
                (1, [7202, 7201], 1)
            owners = [t.owner_index(g) for g in range(4)]
            # the first member's view of the same roster, after its beat
            first.heartbeat()
            mine = peer_mod.PeerTier([e["port"] for e in first.roster],
                                     self_port=7202)
            assert [mine.owner_index(g) for g in range(4)] == \
                [None, 1, None, 1]
            assert owners == [0, None, 0, None]

    def test_install_if_env_contract(self, monkeypatch):
        with RendezvousService() as svc:
            monkeypatch.delenv(rndv.ENV_RNDV_URI, raising=False)
            assert rndv.install_if_env() is None
            monkeypatch.setenv(rndv.ENV_RNDV_URI, svc.host)
            monkeypatch.setenv(rndv.ENV_RNDV_PORT, str(svc.port))
            monkeypatch.setenv(rndv.ENV_RNDV_GANG, "envgang")
            monkeypatch.setenv(rndv.ENV_RNDV_HB_S, "0.05")
            monkeypatch.setenv("DMLC_TPU_TASK_ID", "3")
            monkeypatch.setenv("DMLC_TPU_SERVE_PORT", "7777")
            cli = rndv.install_if_env()
            try:
                assert cli is rndv.active() is rndv.install_if_env()
                assert (cli.gang, cli.member, cli.serve_port) == \
                    ("envgang", "worker-3", 7777)
                assert cli.rank == 0 and cli.world == 1
                assert elastic.gang_metadata() == {
                    "gang": "envgang", "member": "worker-3", "rank": 0,
                    "epoch": cli.epoch, "world": 1}
            finally:
                rndv.uninstall()
        assert rndv.active() is None
        assert elastic.gang_metadata() is None


def _consume_elastic(cli, records, out, stop, batch=3):
    """One gang member's elastic consume loop: ownership, resume offset
    and commit fence from ONE view snapshot per pass; a batch counts as
    consumed IFF the epoch-fenced commit lands."""
    num_parts = len(records)
    while not stop.is_set():
        v = cli.view()
        if v["rank"] is None or v["epoch"] is None:
            return
        if all(int(v["progress"].get(str(p), 0)) >= len(records[p])
               for p in range(num_parts)):
            return
        progressed = False
        for p in elastic.assign_parts(num_parts, v["world"], v["rank"]):
            start = elastic.resume_skip(v["progress"], p)
            if start >= len(records[p]):
                continue
            end = min(start + batch, len(records[p]))
            chunk = records[p][start:end]
            if cli.commit(p, end, epoch=v["epoch"]):
                out.extend(chunk)
                progressed = True
            break  # one batch per pass: re-derive ownership
        if not progressed:
            cli.heartbeat()
            time.sleep(0.002)


class TestElasticGangAcceptance:
    def test_shrink_gang_byte_identical_coverage(self):
        records = {p: [f"{p}:{i}".encode() for i in range(40)]
                   for p in range(5)}
        want = sorted(r for recs in records.values() for r in recs)
        baseline = hashlib.sha256(b"\n".join(want)).hexdigest()
        outs = {m: [] for m in "abc"}
        stops = {m: threading.Event() for m in "abc"}
        with RendezvousService(heartbeat_grace_s=30.0) as svc:
            clis = {m: RendezvousClient("127.0.0.1", svc.port,
                                        gang="shrink", member=m)
                    for m in "abc"}
            threads = {}
            for m in "abc":
                clis[m].join()
                threads[m] = threading.Thread(
                    target=_consume_elastic,
                    args=(clis[m], records, outs[m], stops[m]),
                    daemon=True)
            for t in threads.values():
                t.start()
            deadline = time.monotonic() + 30
            while len(outs["b"]) < 6:
                assert time.monotonic() < deadline, \
                    "victim never committed a batch"
                time.sleep(0.005)
            stops["b"].set()
            threads["b"].join(timeout=10)
            assert not threads["b"].is_alive()
            resp = svc.handle({"op": "report_death", "gang": "shrink",
                               "member": "b"})
            assert resp["ok"] and resp["world"] == 2
            for m in "ac":
                threads[m].join(timeout=60)
                assert not threads[m].is_alive(), \
                    f"survivor {m!r} hung after the shrink"
            assert clis["a"].world == 2
            assert clis["a"].epoch >= 4  # 3 joins + the death
            assert all(e["member"] != "b" for e in clis["a"].roster)
        got = sorted(outs["a"] + outs["b"] + outs["c"])
        assert got == want
        assert hashlib.sha256(b"\n".join(got)).hexdigest() == baseline
        assert outs["b"], "the victim's prefix should be real work"

    def test_grow_reshard_visible_on_trace_gang_and_ledger(self):
        """Twin of the reference's test, without its third check: the
        membership record on the control ledger waits for the analytic
        obs planes (``obs.control``), which the port does not have. A
        mid-epoch grow is on the merged trace (the service's join
        instants, the member's reshard instant with its world
        transition) and on ``/gang``'s live roster."""
        import json as _json
        import urllib.request

        from dmlc_tpu_torch.io.objstore import peer as peer_mod
        from dmlc_tpu_torch.obs import trace as obs_trace
        from dmlc_tpu_torch.obs.serve import StatusServer

        rec = obs_trace.start()
        svc = srv = None
        try:
            svc = RendezvousService(heartbeat_grace_s=30.0)
            a = RendezvousClient("127.0.0.1", svc.port, gang="grow",
                                 member="a", serve_port=7101)
            b = RendezvousClient("127.0.0.1", svc.port, gang="grow",
                                 member="b", serve_port=7102)
            a.join()
            b.join()
            a.heartbeat()
            assert (a.epoch, a.world) == (2, 2)
            rndv.install(client=a)  # a's membership IS /gang here
            srv = StatusServer(port=0)
            # the mid-epoch GROW: a third member joins the running
            # gang; a learns at its next beat and reshards
            c = RendezvousClient("127.0.0.1", svc.port, gang="grow",
                                 member="c", serve_port=7103)
            c.join()
            assert (c.world, c.rank) == (3, 2)
            a.heartbeat()
            assert a.world == 3
            # 1) the merged trace: service-side join instants AND the
            # member-side reshard instant, with the world transition
            names = [e[1] for e in rec.events()]
            assert "gang/member/join" in names
            assert "gang/member/reshard" in names
            ev = [e for e in rec.events()
                  if e[1] == "gang/member/reshard"][-1]
            assert ev[6]["old_world"] == 2
            assert ev[6]["new_world"] == 3
            # 2) /gang: the live roster over HTTP
            with urllib.request.urlopen(srv.url("/gang"),
                                        timeout=5) as r:
                doc = _json.loads(r.read())
            mem = doc["membership"]
            assert mem["world"] == 3 and mem["epoch"] == a.epoch
            assert [m["member"] for m in mem["roster"]] == \
                ["a", "b", "c"]
        finally:
            rndv.uninstall()
            obs_trace.stop()
            peer_mod.reset()  # the joins set the process peer tier
            if srv is not None:
                srv.close()
            if svc is not None:
                svc.close()

    def test_launch_local_gang_shrinks_on_a_death(self, tmp_path):
        """A real ``launch_local(rendezvous=True)`` gang of 2: both join
        through ``install_if_env``; rank 1 exits 3; the supervisor's
        death report shrinks the membership at once (the grace is 30 s)
        and rank 0 sees world 1 at a higher epoch; the launch returns
        [0, 3]."""
        from dmlc_tpu_torch.parallel.launch import launch_local
        script = tmp_path / "w.py"
        script.write_text(
            "import json, os, sys, time\n"
            "from dmlc_tpu_torch import rendezvous\n"
            "cli = rendezvous.install_if_env()\n"
            "assert cli is not None\n"
            "rank = int(os.environ['DMLC_TPU_TASK_ID'])\n"
            "out = sys.argv[1]\n"
            "deadline = time.time() + 60\n"
            "while cli.world < 2 and time.time() < deadline:\n"
            "    time.sleep(0.02)\n"
            "first = cli.view()\n"
            "open(os.path.join(out, f'up-{rank}'), 'w').close()\n"
            "if rank == 1:\n"
            "    sys.exit(3)\n"
            "while cli.world != 1 and time.time() < deadline:\n"
            "    time.sleep(0.02)\n"
            "json.dump([first, cli.view()],\n"
            "          open(os.path.join(out, 'rank0.json'), 'w'))\n")
        codes = launch_local(2, [sys.executable, str(script), str(tmp_path)],
                             env={"PYTHONPATH": REPO}, rendezvous=True,
                             heartbeat_grace_s=30.0, timeout=120)
        assert codes == [0, 3]
        first, last = json.load(open(tmp_path / "rank0.json"))
        assert first["world"] == 2 and last["world"] == 1
        assert last["epoch"] > first["epoch"]
        assert [e["member"] for e in last["roster"]] == ["worker-0"]


# ------------------------------------------------ cross-package checks

class TestCrossPackage:
    @pytest.mark.parametrize("port_side", ["client", "service"])
    def test_line_protocol_interoperates(self, port_side):
        """The same join/heartbeat/commit/leave script, once with the
        port's clients against the reference's service and once with the
        reference's clients against the port's: each delivered view
        (rank, epoch, world, roster, progress) equals what the
        reference's clients see against the reference's service."""
        from dmlc_tpu.rendezvous import RendezvousClient as RefClient
        from dmlc_tpu.rendezvous.service import (
            RendezvousService as RefService,
        )

        def script(service_cls, client_cls):
            views = []
            with service_cls(heartbeat_grace_s=30.0) as svc:
                clis = [client_cls("127.0.0.1", svc.port, gang="x",
                                   member=f"worker-{i}",
                                   serve_port=8000 + i)
                        for i in range(3)]
                for c in clis:
                    c.join()
                    views.append(c.view())
                for c in clis:
                    c.heartbeat({0: 3})
                    views.append(c.view())
                stale = clis[0].epoch
                views.append(clis[1].commit(2, 7, epoch=clis[1].epoch))
                clis[2].leave()
                views.append(clis[0].commit(1, 5, epoch=stale))
                views.append(clis[0].commit(1, 5, epoch=clis[0].epoch))
                for c in clis[:2]:
                    c.heartbeat()
                    views.append(c.view())
            return views

        want = script(RefService, RefClient)
        if port_side == "client":
            got = script(RefService, RendezvousClient)
        else:
            got = script(RendezvousService, RefClient)
        assert got == want
        assert want[-1]["world"] == 2 and want[-1]["progress"] == {
            "0": 3, "1": 5, "2": 7}

    def test_elastic_rules_agree_on_a_seeded_grid(self):
        from dmlc_tpu.rendezvous import elastic as ref_elastic
        rng = np.random.default_rng(20)
        for _ in range(200):
            num_parts = int(rng.integers(1, 40))
            world = int(rng.integers(1, 9))
            rank = int(rng.integers(0, world))
            assert elastic.assign_parts(num_parts, world, rank) == \
                ref_elastic.assign_parts(num_parts, world, rank)
            part = int(rng.integers(0, 1000))
            assert elastic.owner_of(part, world) == \
                ref_elastic.owner_of(part, world)
            progress = {str(p): int(rng.integers(0, 100))
                        for p in rng.choice(num_parts,
                                            int(rng.integers(0, num_parts)),
                                            replace=False)}
            if rng.integers(0, 2):
                progress = {int(k): v for k, v in progress.items()}
            for p in range(num_parts):
                assert elastic.resume_skip(progress, p) == \
                    ref_elastic.resume_skip(progress, p)
            assert elastic.reshard_plan(num_parts, world, progress) == \
                ref_elastic.reshard_plan(num_parts, world, progress)
            digest = hashlib.sha256(rng.bytes(16)).hexdigest()
            assert elastic.content_owner(digest, world) == \
                ref_elastic.content_owner(digest, world)
        assert elastic.resume_skip(None, 3) == \
            ref_elastic.resume_skip(None, 3) == 0
        assert elastic.resume_skip({"3": "x"}, 3) == \
            ref_elastic.resume_skip({"3": "x"}, 3) == 0
