"""The gang half of the port's remote checkpoints: the rendezvous stamp
in ``meta.json`` and the restore fanout over the objstore peer tier
(``prefetch``, ``_peer_or_wire_page``, ``last_restore_peer_bytes``),
held to the reference's ``tests/test_checkpoint.py``
(``test_multi_writer_gang_save``) and to its config 21's
different-world restore (a 3-writer save restored by 2 ranks).

The two "ranks" of the restore here are one process playing each in
turn: each has its own page store, the process peer tier configured
with its own port in the gang's list, and rank 1's ``/pages`` served by
a real ``StatusServer`` over its store. (A real two-process gang runs
in ``tests/test_torch_bench_suite.py``'s config 21.) Across the
packages: a save inside a rendezvous gang writes a stamped ``meta.json``
and objects byte-identical to the reference's. Trees come from seeded
numpy generators; restored leaves equal the saved ones bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from dmlc_tpu_torch.io import checkpoint as ck
from dmlc_tpu_torch.io.objstore import peer as peer_mod
from dmlc_tpu_torch.obs.serve import StatusServer
from dmlc_tpu_torch.rendezvous import elastic

ShardedCheckpoint = ck.ShardedCheckpoint
WRITERS, LEAVES = 3, 8


@pytest.fixture
def remote(tmp_path, monkeypatch):
    """The port's objstore over a fresh emulator, the page-store root
    switchable per "rank" (the reference's page store fresh too), both
    packages' clients, options, peer tiers and rendezvous clients
    restored afterwards."""
    import dmlc_tpu.io.objstore as ref_objstore
    import dmlc_tpu.io.objstore.fs as ref_ofs
    import dmlc_tpu.io.pagestore as ref_ps
    import dmlc_tpu_torch.io.objstore as objstore
    import dmlc_tpu_torch.io.objstore.fs as ofs
    import dmlc_tpu_torch.io.pagestore as ps
    from dmlc_tpu_torch import rendezvous as rndv
    from dmlc_tpu_torch.io.objstore.emulator import EmulatedObjectStore
    monkeypatch.delenv(ofs.ENV_ROOT, raising=False)
    monkeypatch.delenv("DMLC_TPU_SERVE_PORTS", raising=False)
    monkeypatch.delenv("DMLC_TPU_SERVE_PORT", raising=False)
    store = {"root": str(tmp_path / "pagestore")}
    monkeypatch.setattr(ps, "default_store_dir", lambda: store["root"])
    # the reference's saves recognize unchanged pages from its own store
    monkeypatch.setattr(ref_ps, "default_store_dir",
                        lambda: str(tmp_path / "ref_pagestore"))
    saved, ref_saved = ofs.options(), ref_ofs.options()
    em = EmulatedObjectStore(str(tmp_path / "objroot"))
    objstore.configure(em, peer=True)
    peer_mod.reset()
    try:
        yield em, store
    finally:
        peer_mod.reset()
        rndv.uninstall()
        for mod, opts in ((objstore, saved), (ref_objstore, ref_saved)):
            mod.configure(
                None, block_bytes=opts["block_bytes"],
                coalesce=opts["coalesce"], parallel=opts["parallel"],
                hydrate=opts["hydrate"], peer=opts["peer"],
                put_part_bytes=opts["put_part_bytes"],
                put_parallel=opts["put_parallel"])


def _leaf(writer, i, elems):
    # distinct seeds gang-wide: every page its own digest
    rng = np.random.RandomState(1000 + writer * 100 + i)
    return rng.rand(elems).astype(np.float32)


def _tree(writer, elems=3000):
    return {f"w{writer}": {f"l{i}": _leaf(writer, i, elems)
                           for i in range(LEAVES)}}


def _flat(writer, elems=3000):
    return {f"w{writer}/l{i}": _leaf(writer, i, elems)
            for i in range(LEAVES)}


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def _gang_save(step=5):
    """A WRITERS-writer save with the committer (writer 0) last."""
    c = ShardedCheckpoint("obj://b/ck")
    for w in list(range(1, WRITERS)) + [0]:
        c.save(step, _tree(w), metadata={"step": step}, writer=w,
               num_writers=WRITERS)
    want = {}
    for w in range(WRITERS):
        want.update(_flat(w))
    return want


def test_multi_writer_gang_save(remote):
    """Two writers with DISJOINT leaves converge on one committed step:
    writer 1 publishes its shard index first, writer 0 commits only
    after seeing every index."""
    rng = np.random.RandomState(0)
    t0 = {"w0": rng.rand(32, 8).astype(np.float32)}
    t1 = {"w1": rng.rand(16, 4).astype(np.float32)}
    c = ShardedCheckpoint("obj://b/ck")
    c.save(9, {"w1": torch.from_numpy(t1["w1"])}, writer=1, num_writers=2)
    assert c.latest_step() is None
    c.save(9, {"w0": torch.from_numpy(t0["w0"])}, writer=0, num_writers=2)
    assert c.latest_step() == 9
    like = {"w0": torch.zeros(32, 8), "w1": torch.zeros(16, 4)}
    restored, _ = c.restore(like=like)
    _equal(restored, {"w0": t0["w0"], "w1": t1["w1"]})


def test_no_tier_means_no_fanout(remote):
    """Outside a gang ``_tier()`` is None, ``prefetch`` stages nothing
    and every page of a cold restore is wire bytes."""
    em, store = remote
    want = _gang_save()
    store["root"] = store["root"] + "-cold"
    c = ShardedCheckpoint("obj://b/ck")
    assert c._tier() is None
    c.prefetch()
    got, _ = c.restore(like=None)
    _equal(got, want)
    assert c.last_restore_peer_bytes == 0
    assert c.last_restore_wire_bytes == c.last_restore_bytes_read > 0


def test_different_world_restore_splits_the_wire(remote, tmp_path):
    """A 3-writer checkpoint restored by 2 ranks, each with its own page
    store: each rank's prefetch stages exactly the pages
    ``content_owner`` gives it at world 2; rank 0's restore takes every
    page rank 1 owns from rank 1's ``/pages`` (peer bytes) and its own
    from the wire once; the two ranks' splits are complementary and
    every leaf equals the saved one bit for bit."""
    em, store = remote
    want = _gang_save()
    roots = [str(tmp_path / f"store-{r}") for r in range(2)]
    nbytes = {}
    with StatusServer(pages_root=roots[1]) as srv1:
        # a port number nobody serves stands for rank 0's own server
        # (rank 1 never asks it: its prefetch only reads the wire)
        import socket
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p0 = s.getsockname()[1]
        s.close()
        ports = [p0, srv1.port]
        splits = {}
        for rank in (1, 0):
            store["root"] = roots[rank]
            peer_mod.configure(ports=ports, self_port=ports[rank])
            c = ShardedCheckpoint("obj://b/ck")
            t = c._tier()
            assert t is not None and t.self_index == rank and t.world == 2
            em.reset_counters()
            c.prefetch()
            staged = sorted(n for n in os.listdir(roots[rank])
                            if n.endswith(".pages"))
            index = c._load_index_remote(c._step_key(5))
            owned = {e["digest"]: e["nbytes"]
                     for es in index.values() for e in es
                     if elastic.content_owner(e["digest"], 2) == rank}
            assert staged == sorted(ck._PAGE_PREFIX + d + ".pages"
                                    for d in owned)
            nbytes[rank] = sum(owned.values())
            if rank == 0:
                got, user = c.restore(like=None)
                _equal(got, want)
                assert user == {"step": 5}
                splits[rank] = {"local": c.last_restore_local_bytes,
                                "peer": c.last_restore_peer_bytes,
                                "wire": c.last_restore_wire_bytes}
    total = nbytes[0] + nbytes[1]
    assert 0 < nbytes[0] < total and 0 < nbytes[1] < total
    assert splits[0] == {"local": 0, "peer": nbytes[1], "wire": nbytes[0]}
    # every page of the checkpoint is now in rank 0's store: a second
    # restore there is all local
    store["root"] = roots[0]
    c = ShardedCheckpoint("obj://b/ck")
    got, _ = c.restore(like=None)
    _equal(got, want)
    assert c.last_restore_local_bytes == total
    assert c.last_restore_peer_bytes == c.last_restore_wire_bytes == 0


def test_dead_owner_degrades_to_the_wire(remote, tmp_path):
    """A restore whose page owner does not answer takes the page from
    the wire: the leaves still restore bit for bit, peer bytes 0."""
    import socket
    em, store = remote
    want = _gang_save()
    store["root"] = str(tmp_path / "store-0")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    peer_mod.configure(ports=[12345, dead], self_port=12345, timeout_s=0.5)
    from dmlc_tpu_torch.resilience import RetryPolicy, reset_policies
    from dmlc_tpu_torch.resilience import set_policy
    set_policy("io.objstore.peer",
               RetryPolicy(max_attempts=1, sleep=lambda _s: None))
    try:
        c = ShardedCheckpoint("obj://b/ck")
        got, _ = c.restore(like=None)
    finally:
        reset_policies()
    _equal(got, want)
    assert c.last_restore_peer_bytes == 0
    assert c.last_restore_wire_bytes == c.last_restore_bytes_read


@pytest.mark.parametrize("remote_root", [True, False])
def test_save_inside_a_rendezvous_gang_stamps_meta(remote, tmp_path,
                                                    remote_root):
    """Inside a rendezvous gang (an installed client) a save's meta.json
    carries ``rendezvous``: the gang, member, rank, epoch and world of
    the saver; outside one it carries none."""
    import json

    from dmlc_tpu_torch import rendezvous as rndv
    from dmlc_tpu_torch.io.stream import MemoryStream
    from dmlc_tpu_torch.utils.json_util import json_load
    root = "obj://b/ck" if remote_root else str(tmp_path / "local")

    def meta(step):
        c = ShardedCheckpoint(root)
        if remote_root:
            return json_load(MemoryStream(
                c._get_object(f"{c._step_key(step)}/meta.json")))
        with open(os.path.join(root, f"step-{step:08d}",
                               "meta.json")) as f:
            return json.load(f)

    tree = {"x": torch.arange(6, dtype=torch.float32)}
    ShardedCheckpoint(root).save(1, tree)
    assert "rendezvous" not in meta(1)
    with rndv.RendezvousService() as svc:
        cli = rndv.RendezvousClient(svc.host, svc.port, gang="g",
                                    member="worker-0")
        cli.join()
        rndv.install(cli)
        try:
            ShardedCheckpoint(root).save(2, tree)
        finally:
            rndv.uninstall()
    assert meta(2)["rendezvous"] == {"gang": "g", "member": "worker-0",
                                     "rank": 0, "epoch": 1, "world": 1}


def test_stamped_objects_equal_the_references(remote, tmp_path):
    """The same 2-writer tree saved by each package inside a rendezvous
    gang of its own (the same gang name, member, rank, epoch and world)
    into two emulator roots: the same object keys, each byte-identical,
    meta.json's stamp included."""
    import dmlc_tpu.io.checkpoint as ref_ck
    import dmlc_tpu.io.objstore as ref_objstore
    import dmlc_tpu.rendezvous as ref_rndv
    from dmlc_tpu.io.objstore.emulator import EmulatedObjectStore
    from dmlc_tpu_torch import rendezvous as rndv
    em, store = remote
    ref_root = str(tmp_path / "ref_objroot")
    ref_objstore.configure(EmulatedObjectStore(ref_root))
    trees = [_tree(w, elems=500) for w in range(2)]
    for pkg, mod, cls in (("port", rndv, ShardedCheckpoint),
                          ("reference", ref_rndv,
                           ref_ck.ShardedCheckpoint)):
        with mod.RendezvousService() as svc:
            cli = mod.RendezvousClient(svc.host, svc.port, gang="local",
                                       member="worker-0")
            cli.join()
            mod.install(cli)
            try:
                for w in (1, 0):
                    tree = trees[w]
                    if pkg == "port":
                        tree = {k: {n: torch.from_numpy(a)
                                    for n, a in v.items()}
                                for k, v in tree.items()}
                    cls("obj://b/ck").save(3, tree, metadata={"e": 1},
                                           writer=w, num_writers=2)
            finally:
                mod.uninstall()

    def walk(root):
        out = {}
        for d, _, names in os.walk(root):
            for n in names:
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
        return out

    port, ref = walk(em.root), walk(ref_root)
    assert sorted(port) == sorted(ref)
    for k in port:
        assert port[k] == ref[k], k
    metas = [k for k in port if k.endswith("meta.json")]
    assert len(metas) == 1 and b'"rendezvous"' in port[metas[0]]
