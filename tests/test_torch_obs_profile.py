"""The port's sampling profiler (``dmlc_tpu_torch/obs/profile.py``) and
its renderers (``obs/export.py``) against the reference's.

Twins of ``tests/test_obs_profile.py``: wait classification on the same
frames; the same adds give the same trie (its coarsening under the byte
budget conserves the total sample weight and folds into the
``[coarsened]`` leaf); collapsed-stack, speedscope and ``hot_frames``
output of one profile document equal the reference's; the pinned
constants (``PROFILE_SCHEMA``, ``StackProfiler.MAX_DUTY``, the duty
window) are the reference's; a live sampler attributes a hot loop and
separates waits; ``/profile`` serves the continuous trie and a burst;
and, once the port's engine runs, its phase beacons come back through
``native/bindings.prof_read`` (sharded subs tagged with their shard) as
``native:*`` leaves beside the Python threads.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from dmlc_tpu.obs import export as ref_export
from dmlc_tpu.obs import profile as ref_prof
from dmlc_tpu_torch.obs import export
from dmlc_tpu_torch.obs import profile as obs_prof
from dmlc_tpu_torch.obs.serve import StatusServer


@pytest.fixture(autouse=True)
def _profilers_clean():
    """No profiler of either package outlives a test, and each starts
    without the previous test's duty-guard prior."""
    for m in (obs_prof, ref_prof):
        m.uninstall()
        m._tick_cost_prior_s = 0.0
    yield
    for m in (obs_prof, ref_prof):
        m.uninstall()


def _get(url):
    with urllib.request.urlopen(url, timeout=15.0) as resp:
        return json.loads(resp.read())


def _frame_weight(doc, predicate):
    total = 0

    def visit(node):
        nonlocal total
        if predicate(node.get("name") or ""):
            total += int(node.get("self") or 0)
        for c in node.get("children") or []:
            visit(c)

    for root in (doc.get("threads") or {}).values():
        visit(root)
    return total


def test_constants_are_the_references():
    assert obs_prof.PROFILE_SCHEMA == ref_prof.PROFILE_SCHEMA
    assert obs_prof.StackProfiler.MAX_DUTY == ref_prof.StackProfiler.MAX_DUTY
    assert obs_prof.StackProfiler._DUTY_WINDOW == \
        ref_prof.StackProfiler._DUTY_WINDOW
    for name in ("FOLDED_FRAME", "WAIT_FRAME", "ENV_PROFILE_HZ",
                 "ENV_PROFILE_BYTES", "DEFAULT_HZ"):
        assert getattr(obs_prof, name) == getattr(ref_prof, name), name
    assert obs_prof._NATIVE_PHASES == ref_prof._NATIVE_PHASES


@pytest.mark.parametrize("filename,func", [
    ("threading.py", "wait"), ("queue.py", "get"),
    ("selectors.py", "select"), ("socket.py", "recv"),
    ("anything.py", "acquire"), ("worker.py", "sleep"),
    ("parser.py", "tokenize"), ("queue.py", "qsize"),
    ("x.py", "get_value"), ("threading.py", "run")])
def test_wait_classification_matches_reference(filename, func):
    assert obs_prof.classify_wait(filename, func) == \
        ref_prof.classify_wait(filename, func)


def _adds(trie, n, seed=0):
    """n seeded stacks into ``trie``: cold unique leaves, a hot path
    and wait-shaped leaves."""
    import numpy as np
    rng = np.random.RandomState(seed)
    for i in range(n):
        k = int(rng.randint(0, 10))
        if k < 6:
            trie.add("main", [f"mod{i % 7}.py:f", f"leaf_{i}.py:g{i}"])
        elif k < 9:
            trie.add("worker", ["mod0.py:f", "hot.py:hot"])
        else:
            trie.add("io", ["c.py:h", "threading.py:wait",
                            obs_prof.WAIT_FRAME], wait=True)


@pytest.mark.parametrize("budget,n", [(16 << 10, 4000), (64 << 10, 2000),
                                      (1 << 20, 500)])
def test_trie_matches_reference_and_conserves_weight(budget, n):
    t, r = obs_prof.FrameTrie(budget_bytes=budget), \
        ref_prof.FrameTrie(budget_bytes=budget)
    _adds(t, n)
    _adds(r, n)
    doc = t.to_dict()
    assert doc == r.to_dict()
    assert doc["approx_bytes"] <= doc["budget_bytes"]
    total = sum(w for _, w in export._walk_profile(doc))
    assert total == doc["samples"] == n
    if doc["coarsenings"]:
        assert any(obs_prof.FOLDED_FRAME in ln
                   for ln in export.collapsed_lines(doc))


def _doc():
    t = obs_prof.FrameTrie()
    t.add("main", ["a.py:f", "b.py:g"])
    t.add("main", ["a.py:f", "b.py:g"])
    t.add("main", ["a.py:f", "parser.py:tokenize"])
    t.add("io", ["c.py:h", "threading.py:wait", obs_prof.WAIT_FRAME],
          wait=True)
    t.add("native/worker-0", ["native:parse"])
    t.add("native/worker-0", ["native:parse"])
    t.add("native/reader", ["native:reader_wait"], wait=True)
    d = {"schema": obs_prof.PROFILE_SCHEMA, "hz": 10.0, "duration_s": 1.0,
         "burst": False}
    d.update(t.to_dict())
    return d


def test_collapsed_lines_match_reference(tmp_path):
    doc = _doc()
    lines = export.collapsed_lines(doc)
    assert lines == ref_export.collapsed_lines(doc)
    assert "main;a.py:f;b.py:g 2" in lines
    assert f"io;c.py:h;threading.py:wait;{obs_prof.WAIT_FRAME} 1" in lines
    p, q = str(tmp_path / "a.collapsed"), str(tmp_path / "b.collapsed")
    export.write_collapsed(doc, p)
    ref_export.write_collapsed(doc, q)
    assert open(p).read() == open(q).read()


def test_speedscope_matches_reference(tmp_path):
    doc = _doc()
    got = export.speedscope_doc(doc, name="p")
    want = ref_export.speedscope_doc(doc, name="p")
    assert {k: v for k, v in got.items() if k != "exporter"} == \
        {k: v for k, v in want.items() if k != "exporter"}
    assert got["exporter"] == "dmlc_tpu_torch.obs"
    prof = got["profiles"][0]
    assert prof["endValue"] == sum(prof["weights"]) == doc["samples"]
    p = str(tmp_path / "s.json")
    export.write_speedscope(doc, p, name="p")
    assert json.load(open(p)) == got


@pytest.mark.parametrize("bound", [None, "parse", "assemble", "xfer",
                                   "wire"])
def test_hot_frames_match_reference(bound):
    doc = _doc()
    assert obs_prof.hot_frames(doc, bound) == ref_prof.hot_frames(doc, bound)


def _hot_spin(seconds):
    x = 0
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        for i in range(2000):
            x += i * i
    return x


def test_live_sampler_attributes_a_hot_loop_and_a_wait():
    prof = obs_prof.StackProfiler(hz=200)
    ev = threading.Event()
    waiter = threading.Thread(target=lambda: ev.wait(5.0),
                              name="prof-waiter")
    spinner = threading.Thread(target=_hot_spin, args=(0.6,),
                               name="prof-spinner")
    prof.start()
    try:
        waiter.start()
        spinner.start()
        spinner.join()
    finally:
        ev.set()
        waiter.join()
        prof.stop()
    doc = prof.to_dict()
    assert doc["samples"] > 0 and doc["wait_samples"] > 0
    assert _frame_weight(doc, lambda s: s.endswith(":_hot_spin")) > 0
    assert "prof-spinner" in doc["threads"]
    waits = doc["threads"].get("prof-waiter")
    assert waits is not None
    assert _frame_weight({"threads": {"w": waits}},
                         lambda s: s == obs_prof.WAIT_FRAME) > 0


def test_install_if_env(monkeypatch):
    monkeypatch.delenv(obs_prof.ENV_PROFILE_HZ, raising=False)
    assert obs_prof.install_if_env() is None
    monkeypatch.setenv(obs_prof.ENV_PROFILE_HZ, "50")
    prof = obs_prof.install_if_env()
    assert prof is not None and obs_prof.active() is prof
    assert prof.hz == 50.0 and obs_prof.install_if_env() is prof
    assert ref_prof.active() is None


def test_profile_endpoint_serves_trie_and_burst():
    with StatusServer() as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url("/profile"))
        assert e.value.code == 404
        obs_prof.install(hz=100)
        t = threading.Thread(target=_hot_spin, args=(0.3,),
                             name="endpoint-spin")
        t.start()
        t.join()
        doc = _get(srv.url("/profile"))
        assert doc["schema"] == obs_prof.PROFILE_SCHEMA
        assert doc["burst"] is False and doc["samples"] > 0
        burst = _get(srv.url("/profile?seconds=0.2&hz=100"))
        assert burst["burst"] is True and burst["hz"] == 100.0


def _corpus(tmp_path, rows=400000):
    p = tmp_path / "beacon.libsvm"
    with open(p, "w") as f:
        for i in range(rows):
            f.write(f"{i % 2} {i % 97}:1.5 {(i * 7) % 89}:2.25 "
                    f"{(i * 3) % 53}:0.5 {(i * 11) % 61}:0.125\n")
    return str(p)


def test_native_beacons_join_the_profile(tmp_path):
    """The port's engine's phase beacons become ``native:*`` leaves under
    ``native/*`` labels beside the Python threads, and every slot is
    released with its parser."""
    from dmlc_tpu_torch.native import bindings, native_available
    assert native_available()
    path = _corpus(tmp_path)
    prof = obs_prof.install(hz=500)
    seen = set()
    for _ in range(20):
        par = bindings.NativeLibSVMParser(path, nthreads=2,
                                          chunk_size=16384)
        while par.next():
            seen.update(k for k, _, phase, _ in bindings.prof_read()
                        if phase)
            prof.sample_now(force=True)
        par.destroy()
        doc = prof.to_dict()
        if _frame_weight(doc, lambda s: s.startswith("native:")) > 0:
            break
    assert bindings.prof_read() == []
    labels = set(doc["threads"])
    assert seen & {1, 2}, seen
    assert any(lb.startswith("native/") for lb in labels), labels
    assert any(not lb.startswith("native/") for lb in labels), labels
    assert _frame_weight(doc, lambda s: s.startswith("native:")) > 0


def test_sharded_subs_carry_shard_tags(tmp_path):
    from dmlc_tpu_torch.native import bindings
    path = _corpus(tmp_path, rows=120000)
    shards = set()
    for _ in range(5):
        sp = bindings.NativeShardedTextParser(
            path, shards=2, format="libsvm", nthreads=2, chunk_size=16384)
        while sp.next_padded(4096, row_bucket=4096,
                             nnz_bucket=4096 * 4) is not None:
            shards.update(shard for kind, _, _, shard
                          in bindings.prof_read() if kind in (1, 2))
        sp.destroy()
        if {0, 1} <= shards:
            break
    assert {0, 1} <= shards, shards
    assert bindings.prof_read() == []
