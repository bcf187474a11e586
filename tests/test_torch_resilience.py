"""The port's resilience plane (``dmlc_tpu_torch/resilience``) against
the JAX package's (``dmlc_tpu/resilience``) on the CPU.

Cross-package parity: one spec string and one seed give the same
``spec()`` and the same fire/no-fire sequence in both packages (``p=``
clauses included); ``RetryPolicy.delay_for`` gives the same backoff
schedule; spill files, page caches and checkpoints the port writes under
an armed fault plan are byte-identical to the reference's fault-free
files on the same input; and a port gang crashed mid-epoch and restarted
by its supervisor writes the same block count and sha256 as the
reference's fault-free gang. Then twins of the reference's
``tests/test_resilience.py`` (``TestRetryPolicy``, ``TestFaultPlan``,
``TestInstrumentedSeams`` but the ``obs.scrape`` case, which waits for
the status server, ``TestGangSupervision``, ``TestGangCrashAcceptance``
without its HTTP ``/metrics`` read, ``TestBenchChaos``), run against the
port, and a CUDA-shaped ``RuntimeError`` that ``guarded`` must not retry.
Gang launches carry a launch timeout, well inside the suite's limit.
"""

import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.row_iter import DiskRowIter as RefDiskRowIter
from dmlc_tpu.data.row_iter import RoundSpillWriter as RefSpillWriter
from dmlc_tpu.data.rowblock import RowBlock as RefRowBlock
from dmlc_tpu.io import checkpoint as ref_ck
from dmlc_tpu.parallel import launch as ref_launch
from dmlc_tpu.resilience import inject as ref_inject
from dmlc_tpu.resilience import policy as ref_policy
from dmlc_tpu_torch.data.rowblock import RowBlock
from dmlc_tpu_torch.resilience import (
    CRASH_EXIT, AttemptTimeout, FaultPlan, GangMember, GangSupervisor,
    RestartPolicy, RetryBudget, RetryPolicy, guarded, inject, policy_for,
    reset_policies, retry_counts, set_policy,
)
from dmlc_tpu_torch.utils.logging import DMLCError

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT = 120  # seconds a test's gang may run before it is killed


def _noop_sleep(_s):
    pass


@pytest.fixture(autouse=True)
def _clean_plane():
    """Every test leaves both packages chaos-free and policy-default."""
    yield
    inject.uninstall()
    reset_policies()
    ref_inject.uninstall()
    ref_policy.reset_policies()


def _gang_env(extra=None):
    env = {"JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [_REPO] + [p for p in
                          os.environ.get("PYTHONPATH", "").split(
                              os.pathsep) if p])}
    if extra:
        env.update(extra)
    return env


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------ cross-package parity

_SPECS = [
    ("site=io.stream.read,fault=ioerror,times=2", 0),
    ("site=a.*,fault=ioerror,nth=3;site=a.b,fault=ioerror,times=1", 5),
    ("site=p.*,fault=ioerror,p=0.5", 7),
    ("site=p.*,fault=ioerror,p=0.25;site=p.x,fault=ioerror,p=0.5,seed=3",
     11),
    ("site=*,fault=ioerror,p=0.1;site=q.?,fault=delay,delay_s=0.0,times=4",
     2 ** 31 - 1),
]
_SCRIPT = ["p.x", "a.b", "p.y", "io.stream.read", "a.c", "q.1", "p.x",
           "z", "a.b"] * 12


def _fire_sequence(plan):
    out = []
    for site in _SCRIPT:
        try:
            plan.fire(site)
            out.append(0)
        except IOError:
            out.append(1)
    return out


@pytest.mark.parametrize("spec,seed", _SPECS)
def test_fault_sequence_matches_reference(spec, seed):
    port = FaultPlan.parse(spec, seed=seed)
    ref = ref_inject.FaultPlan.parse(spec, seed=seed)
    assert port.spec() == ref.spec()
    assert port.seed == ref.seed
    got, want = _fire_sequence(port), _fire_sequence(ref)
    assert got == want
    assert port.injected == ref.injected
    assert [(e["site"], e["fault"], e["clause"]) for e in port.events()] \
        == [(e["site"], e["fault"], e["clause"]) for e in ref.events()]


@pytest.mark.parametrize("kw", [{}, {"jitter": 0.0},
                                {"base_delay_s": 0.01, "multiplier": 3.0,
                                 "jitter": 0.5, "jitter_seed": 99},
                                {"max_delay_s": 0.2, "jitter": 0.25}])
def test_backoff_schedule_matches_reference(kw):
    port = RetryPolicy(**kw)
    ref = ref_policy.RetryPolicy(**kw)
    sites = ["io.stream.read", "io.stream.open", "spill.commit",
             "checkpoint.save", "data.pages.build", "gang.block", ""]
    for site in sites:
        for attempt in range(1, 9):
            assert port.delay_for(site, attempt) == \
                ref.delay_for(site, attempt), (site, attempt)


def test_env_policy_contract_matches_reference(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_RETRY",
                       "attempts=6,base=0.02;site=spill.*,attempts=2,"
                       "jitter=0.0;site=io.*,timeout=1.5")
    reset_policies()
    ref_policy.reset_policies()
    for site in ("spill.commit", "io.stream.read", "checkpoint.save",
                 "obs.scrape", "io.objstore.put", "rendezvous.join"):
        p, r = policy_for(site), ref_policy.policy_for(site)
        for field in ("max_attempts", "base_delay_s", "max_delay_s",
                      "multiplier", "jitter", "attempt_timeout_s"):
            assert getattr(p, field) == getattr(r, field), (site, field)


def _rounds(seed, nparts=3, rounds=4):
    rng = np.random.RandomState(seed)
    out = []
    for r in range(rounds):
        row = []
        for p in range(nparts):
            n = 0 if (r == rounds - 1 and p == 0) else 5 + r + p
            lengths = rng.randint(0, 7, n)
            offset = np.concatenate([[0], np.cumsum(lengths)]).astype(
                np.int64)
            nnz = int(offset[-1])
            row.append({"offset": offset,
                        "label": rng.randn(n).astype(np.float32),
                        "index": rng.randint(0, 2 ** 31, nnz).astype(
                            np.uint32),
                        "value": rng.randn(nnz).astype(np.float32)})
        out.append(row)
    return out


@pytest.mark.parametrize("level", [0, 6])
def test_chaos_spill_file_matches_reference(tmp_path, level):
    """The port's round spill, committed through injected commit and
    open faults, is byte for byte the reference's fault-free file."""
    rounds = _rounds(level)
    meta = {"fingerprint": [["/data/x.libsvm", 1234, 5678]], "k": "v"}
    port_path = str(tmp_path / "port" / "rounds-a-p1-1.pages")
    ref_path = str(tmp_path / "ref" / "rounds-a-p1-1.pages")
    rw = RefSpillWriter(ref_path, 3, meta, codec_level=level)
    for row in rounds:
        rw.add_row([RefRowBlock(**a) for a in row])
    rw.commit()
    from dmlc_tpu_torch.data.row_iter import RoundSpillFile, RoundSpillWriter
    set_policy("*", RetryPolicy(max_attempts=4, sleep=_noop_sleep))
    plan = inject.install("site=spill.commit,fault=ioerror,times=2;"
                          "site=io.stream.open,fault=ioerror,times=1")
    w = RoundSpillWriter(port_path, 3, meta, codec_level=level)
    for row in rounds:
        w.add_row([RowBlock(**a) for a in row])
    f = w.commit()
    assert plan.injected == 3
    assert retry_counts() == {"spill.commit": 2, "io.stream.open": 1}
    assert _read(port_path) == _read(ref_path)
    assert _read(port_path + ".meta.json") == _read(ref_path + ".meta.json")
    # a page read under truncation-free read faults replays every round
    inject.install("site=io.stream.read,fault=ioerror,p=0.2", seed=4)
    got = [[b.content_hash() for b in row] for row in f.iter_rows()]
    want = [[RowBlock(**a).content_hash() for a in row] for row in rounds]
    assert got == want
    assert retry_counts()["io.stream.read"] > 0
    assert isinstance(f, RoundSpillFile)


def test_chaos_page_cache_matches_reference(tmp_path):
    """A DiskRowIter cache built through a failed first build, commit
    faults and read faults is the reference's fault-free cache."""
    rng = np.random.RandomState(3)
    lines = [f"{i % 2} " + " ".join(
        f"{j}:{rng.rand():.4f}"
        for j in np.sort(rng.choice(300, rng.randint(1, 9), replace=False)))
        for i in range(1500)]
    src = str(tmp_path / "d.libsvm")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    ref_cache = str(tmp_path / "ref" / "cache.pages")
    port_cache = str(tmp_path / "port" / "cache.pages")
    RefDiskRowIter(lambda: RefParser.create(src, 0, 1, format="libsvm",
                                            engine="python"),
                   ref_cache, rows_per_page=128)
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.data.row_iter import DiskRowIter
    set_policy("*", RetryPolicy(max_attempts=4, sleep=_noop_sleep))
    inject.install("site=data.pages.build,fault=ioerror,times=1;"
                   "site=data.pages.commit,fault=ioerror,times=2;"
                   "site=io.stream.read,fault=ioerror,nth=5;"
                   "site=io.filesys.*,fault=ioerror,times=1")
    it = DiskRowIter(lambda: Parser.create(src, 0, 1, format="libsvm",
                                           engine="python"),
                     port_cache, rows_per_page=128)
    counts = retry_counts()
    for site in ("data.pages.build", "data.pages.commit"):
        assert counts.get(site, 0) >= 1, counts
    assert _read(port_cache) == _read(ref_cache)
    it.before_first()
    rows = 0
    while it.next():
        rows += it.value().size
    assert rows == 1500


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.rand(37).astype(np.float32),
            "b": np.float32(rng.rand()),
            "V": rng.rand(11, 3, 2).astype(np.float32),
            "opt": {"m": rng.rand(5).astype(np.float32),
                    "steps": np.int64(17)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_chaos_checkpoints_match_reference(tmp_path):
    """``save_pytree`` and a ``ShardedCheckpoint`` step written under
    save, open and read faults are the reference's fault-free files;
    both restore the saved tree bit for bit under restore faults."""
    from dmlc_tpu_torch.io import checkpoint as ck
    tree = _params(5)
    ref_ck.save_pytree(tree, str(tmp_path / "ref.bin"))
    d_ref = ref_ck.ShardedCheckpoint(str(tmp_path / "ref")).save(
        3, tree, metadata={"epoch": 1})
    set_policy("*", RetryPolicy(max_attempts=4, sleep=_noop_sleep))
    inject.install("site=checkpoint.save,fault=ioerror,times=2;"
                   "site=checkpoint.restore,fault=ioerror,times=2;"
                   "site=io.stream.open,fault=ioerror,nth=2;"
                   "site=io.stream.read,fault=ioerror,nth=3")
    ck.save_pytree(_torch_tree(tree), str(tmp_path / "port.bin"))
    port = ck.ShardedCheckpoint(str(tmp_path / "port"))
    d_port = port.save(3, _torch_tree(tree), metadata={"epoch": 1})
    assert _read(str(tmp_path / "port.bin")) == _read(str(tmp_path /
                                                          "ref.bin"))
    for name in sorted(os.listdir(d_ref)):
        assert _read(os.path.join(d_port, name)) == \
            _read(os.path.join(d_ref, name)), name
    got = ck.load_pytree(str(tmp_path / "port.bin"), like=_torch_tree(tree))
    restored, user = port.restore(like=_torch_tree(tree))
    assert user == {"epoch": 1}
    for out in (got, restored):
        for k in ("w", "b", "V"):
            assert torch.equal(out[k], _torch_tree(tree)[k])
        assert torch.equal(out["opt"]["m"], _torch_tree(tree)["opt"]["m"])
    counts = retry_counts()
    for site in ("checkpoint.save", "checkpoint.restore", "io.stream.open",
                 "io.stream.read"):
        assert counts.get(site, 0) >= 1, counts


# ---------------------------------------------------------------- policy

class TestRetryPolicy:
    def test_retries_then_succeeds(self):
        calls = []
        pol = RetryPolicy(max_attempts=4, sleep=_noop_sleep)

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise IOError("transient")
            return "ok"

        assert pol.call("t.basic", fn) == "ok"
        assert len(calls) == 3
        assert retry_counts()["t.basic"] == 2

    def test_backoff_schedule_is_deterministic(self):
        slept_a, slept_b = [], []
        for slept in (slept_a, slept_b):
            calls = [0]
            pol = RetryPolicy(max_attempts=4, base_delay_s=0.1,
                              multiplier=2.0, jitter=0.2,
                              sleep=slept.append)

            def fn():
                calls[0] += 1
                if calls[0] < 4:
                    raise IOError("x")
                return calls[0]

            pol.call("t.backoff", fn)
        assert slept_a == slept_b  # jitter is seeded, not random
        assert slept_a == [pol.delay_for("t.backoff", a)
                           for a in (1, 2, 3)]
        # exponential shape survives the +-20% jitter
        assert slept_a[0] < slept_a[1] < slept_a[2]

    def test_non_retryable_raises_immediately(self):
        pol = RetryPolicy(sleep=_noop_sleep)
        calls = []

        def bad_value():
            calls.append(1)
            raise ValueError("parse error")

        with pytest.raises(ValueError):
            pol.call("t.cls", bad_value)
        assert len(calls) == 1

        def missing():
            calls.append(1)
            raise FileNotFoundError("gone")

        calls.clear()
        with pytest.raises(FileNotFoundError):
            pol.call("t.cls", missing)
        assert len(calls) == 1  # permanent OSError subclasses: no retry

    def test_runtime_error_inside_guarded_not_retried(self):
        # a CUDA error reaches Python as a RuntimeError: a seam must
        # surface it at once, never retry device work as if it were I/O
        set_policy("t.cuda", RetryPolicy(max_attempts=5,
                                         sleep=_noop_sleep))
        calls = []

        def launch():
            calls.append(1)
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

        with pytest.raises(RuntimeError, match="CUDA error"):
            guarded("t.cuda", launch)
        assert len(calls) == 1
        assert "t.cuda" not in retry_counts()
        assert not RetryPolicy().is_retryable(RuntimeError("CUDA error"))
        assert not RetryPolicy().is_retryable(
            torch.cuda.OutOfMemoryError("CUDA out of memory"))

    def test_attempts_exhausted_reraises_last(self):
        pol = RetryPolicy(max_attempts=3, sleep=_noop_sleep)
        calls = []

        def fn():
            calls.append(1)
            raise IOError(f"fail {len(calls)}")

        with pytest.raises(IOError, match="fail 3"):
            pol.call("t.exhaust", fn)
        assert len(calls) == 3

    def test_budget_shared_across_sites(self):
        budget = RetryBudget(1)
        pol = RetryPolicy(max_attempts=5, budget=budget,
                          sleep=_noop_sleep)
        a_calls, b_calls = [], []

        def flaky(calls, ok_after):
            calls.append(1)
            if len(calls) < ok_after:
                raise IOError("x")
            return True

        assert pol.call("pipe.a", lambda: flaky(a_calls, 2))
        assert budget.remaining == 0
        # the pool is spent: site B gets its first attempt, no retries
        with pytest.raises(IOError):
            pol.call("pipe.b", lambda: flaky(b_calls, 2))
        assert len(b_calls) == 1

    def test_attempt_timeout_retries_hung_attempt(self):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) == 1:
                time.sleep(0.5)  # a hung first attempt
            return "done"

        pol = RetryPolicy(max_attempts=2, attempt_timeout_s=0.05,
                          sleep=_noop_sleep)
        assert pol.call("t.hang", fn) == "done"
        assert len(calls) == 2

    def test_attempt_timeout_exhaustion_raises_timeout(self):
        pol = RetryPolicy(max_attempts=2, attempt_timeout_s=0.05,
                          sleep=_noop_sleep)
        with pytest.raises(AttemptTimeout):
            pol.call("t.hang2", lambda: time.sleep(0.5))

    def test_attempt_timeout_polices_first_attempt_via_guarded(self):
        set_policy("t.firsthang",
                   RetryPolicy(max_attempts=2, attempt_timeout_s=0.05,
                               sleep=_noop_sleep))
        calls = []

        def fn():
            calls.append(1)
            if len(calls) == 1:
                time.sleep(2.0)  # would block guarded() for 2s
            return "ok"

        t0 = time.monotonic()
        assert guarded("t.firsthang", fn) == "ok"
        assert time.monotonic() - t0 < 1.0
        assert len(calls) == 2

    def test_env_only_timeout_polices_first_attempt(self, monkeypatch):
        monkeypatch.setenv("DMLC_TPU_RETRY",
                           "site=t.envhang,timeout=0.05,attempts=2,"
                           "base=0.0,jitter=0.0")
        reset_policies()
        calls = []

        def fn():
            calls.append(1)
            if len(calls) == 1:
                time.sleep(2.0)
            return "ok"

        t0 = time.monotonic()
        assert guarded("t.envhang", fn) == "ok"
        assert time.monotonic() - t0 < 1.0
        assert len(calls) == 2

    def test_env_contract_configures_sites(self, monkeypatch):
        monkeypatch.setenv(
            "DMLC_TPU_RETRY",
            "attempts=7,base=0.01;site=obs.*,attempts=1")
        reset_policies()
        assert policy_for("io.stream.read").max_attempts == 7
        assert policy_for("io.stream.read").base_delay_s == 0.01
        assert policy_for("obs.scrape").max_attempts == 1

    def test_env_contract_rejects_unknown_key(self, monkeypatch):
        monkeypatch.setenv("DMLC_TPU_RETRY", "nope=3")
        reset_policies()
        with pytest.raises(DMLCError, match="unknown key"):
            policy_for("any.site")

    def test_set_default_policy_flows_into_site_overrides(self):
        from dmlc_tpu_torch.resilience import set_default_policy
        slept = []
        record = slept.append
        set_default_policy(RetryPolicy(base_delay_s=0.0, sleep=record))
        pol = policy_for("obs.scrape")
        assert pol.max_attempts == 2       # the built-in change
        assert pol.sleep is record         # the new default's sleep
        assert policy_for("io.stream.read").sleep is record
        assert policy_for("io.stream.read").base_delay_s == 0.0


# ---------------------------------------------------------------- inject

class TestFaultPlan:
    def test_parse_spec_roundtrip(self):
        spec = ("site=io.stream.read,fault=ioerror,times=2;"
                "site=gang.*,fault=crash,nth=3,rank=1,attempt=0")
        plan = FaultPlan.parse(spec, seed=5)
        assert plan.spec() == spec
        assert plan.seed == 5

    def test_parse_rejects_garbage(self):
        with pytest.raises(DMLCError, match="unknown fault"):
            FaultPlan.parse("site=x,fault=explode")
        with pytest.raises(DMLCError, match="unknown key"):
            FaultPlan.parse("site=x,fault=ioerror,frequency=2")
        with pytest.raises(DMLCError, match="site= and fault="):
            FaultPlan.parse("fault=ioerror")

    def test_times_trigger_fires_first_n(self):
        plan = FaultPlan.parse("site=a.b,fault=ioerror,times=2")
        for _ in range(2):
            with pytest.raises(IOError, match="injected fault"):
                plan.fire("a.b")
        plan.fire("a.b")  # third and later matches pass clean
        plan.fire("a.b")
        assert plan.injected == 2

    def test_nth_trigger_fires_exactly_once(self):
        plan = FaultPlan.parse("site=a.*,fault=ioerror,nth=3")
        plan.fire("a.x")
        plan.fire("a.y")
        with pytest.raises(IOError):
            plan.fire("a.z")
        plan.fire("a.x")
        assert plan.injected == 1

    def test_probability_trigger_is_seed_deterministic(self):
        def pattern(seed):
            plan = FaultPlan.parse("site=p.*,fault=ioerror,p=0.5",
                                   seed=seed)
            hits = []
            for _ in range(64):
                try:
                    plan.fire("p.x")
                    hits.append(0)
                except IOError:
                    hits.append(1)
            return hits

        assert pattern(7) == pattern(7)      # same seed => same faults
        assert pattern(7) != pattern(8)      # the seed is real
        assert 10 < sum(pattern(7)) < 54     # and it is ~a coin

    def test_rank_and_attempt_scoping(self, monkeypatch):
        monkeypatch.setenv("DMLC_TPU_TASK_ID", "1")
        monkeypatch.setenv("DMLC_TPU_ATTEMPT", "0")
        plan = FaultPlan.parse(
            "site=s,fault=ioerror,rank=1,attempt=0")
        with pytest.raises(IOError):
            plan.fire("s")
        # a restarted process (attempt bumped) runs clean
        monkeypatch.setenv("DMLC_TPU_ATTEMPT", "1")
        plan2 = FaultPlan.parse(
            "site=s,fault=ioerror,rank=1,attempt=0")
        plan2.fire("s")
        # another rank never matches
        monkeypatch.setenv("DMLC_TPU_ATTEMPT", "0")
        monkeypatch.setenv("DMLC_TPU_TASK_ID", "0")
        plan3 = FaultPlan.parse(
            "site=s,fault=ioerror,rank=1,attempt=0")
        plan3.fire("s")
        assert plan.injected == 1
        assert plan2.injected == plan3.injected == 0

    def test_counts_hold_under_threads(self):
        """More firing threads than cores, a short switch interval: a
        times= clause injects exactly its count, the event log and the
        per-site retry totals lose no update."""
        import threading
        plan = inject.install("site=s.*,fault=ioerror,times=300")
        # attempts enough that no call outlasts the clause and raises
        set_policy("s.*", RetryPolicy(max_attempts=1000,
                                      sleep=_noop_sleep))
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def work(i):
                for _ in range(50):
                    guarded(f"s.{i % 4}", lambda: None)

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(4 * (os.cpu_count() or 2))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        assert plan.injected == 300 == len(plan.events())
        assert sum(retry_counts().values()) == 300

    def test_delay_fault_sleeps_not_raises(self):
        plan = FaultPlan.parse(
            "site=d,fault=delay,delay_s=0.05,times=1")
        t0 = time.perf_counter()
        plan.fire("d")
        assert time.perf_counter() - t0 >= 0.04
        assert plan.events()[0]["fault"] == "delay"


# ---------------------------------------------------------------- seams

class TestInstrumentedSeams:
    def test_stream_open_retry_until_success(self, tmpfile):
        path = tmpfile("seam.bin", b"z" * 64)
        set_policy("io.stream.open",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        inject.install("site=io.stream.open,fault=ioerror,times=2")
        from dmlc_tpu_torch.io.stream import create_stream
        with create_stream(path, "r") as s:
            assert s.read_all() == b"z" * 64
        assert retry_counts()["io.stream.open"] == 2

    def test_stream_read_retry_until_success(self, tmpfile):
        path = tmpfile("seam2.bin", b"q" * 128)
        set_policy("io.stream.read",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        from dmlc_tpu_torch.io.stream import create_stream
        with create_stream(path, "r") as s:
            inject.install("site=io.stream.read,fault=ioerror,times=1")
            assert s.read_exact(128) == b"q" * 128
        assert retry_counts()["io.stream.read"] == 1

    def test_stream_read_truncation_surfaces_as_short_read(self,
                                                           tmpfile):
        path = tmpfile("seam3.bin", b"w" * 100)
        from dmlc_tpu_torch.io.stream import create_stream
        with create_stream(path, "r") as s:
            inject.install(
                "site=io.stream.read,fault=truncate,times=1")
            with pytest.raises(DMLCError, match="unexpected EOF"):
                s.read_exact(100)

    def test_midfile_truncation_is_eof_not_silent_shift(self, tmpfile):
        payload = bytes(range(200)) + bytes(range(56))
        path = tmpfile("seam3b.bin", payload)
        from dmlc_tpu_torch.io.stream import create_stream
        with create_stream(path, "r") as s:
            inject.install(
                "site=io.stream.read,fault=truncate,times=1")
            with pytest.raises(DMLCError, match="unexpected EOF"):
                s.read_exact(100)

    def test_readinto_truncation_covered(self, tmpfile):
        path = tmpfile("seam3c.bin", b"r" * 100)
        from dmlc_tpu_torch.io.stream import create_stream
        with create_stream(path, "r") as s:
            inject.install(
                "site=io.stream.read,fault=truncate,times=1")
            buf = bytearray(100)
            n = s.readinto(buf)
            assert n == 50 and bytes(buf[:n]) == b"r" * 50
            assert s.readinto(bytearray(50)) == 0  # EOF-pinned

    def test_read_retry_restores_file_position(self):
        from dmlc_tpu_torch.io.stream import FileStream

        class FlakyFile:
            def __init__(self, data):
                self.data = data
                self.pos = 0
                self.failed = False

            def read(self, n):
                if not self.failed:
                    self.failed = True
                    self.pos += 3  # consumed bytes, then the error
                    raise IOError("EIO mid-read")
                out = self.data[self.pos:self.pos + n]
                self.pos += len(out)
                return out

            def tell(self):
                return self.pos

            def seek(self, pos):
                self.pos = pos

        set_policy("io.stream.read",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        s = FileStream(FlakyFile(bytes(range(64))))
        assert s.read_exact(64) == bytes(range(64))

    def test_filesys_stat_retry(self, tmpfile):
        path = tmpfile("seam4.bin", b"s")
        set_policy("io.filesys.*",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        inject.install("site=io.filesys.stat,fault=ioerror,times=1")
        from dmlc_tpu_torch.io.filesys import URI, FileSystem
        u = URI(path)
        info = FileSystem.get_instance(u).get_path_info(u)
        assert info.size == 1
        assert retry_counts()["io.filesys.stat"] == 1

    def test_filesys_list_retry(self, tmp_path):
        # the directory expansion of a split: a listing that fails once
        # is retried, and the split still sees every file
        d = tmp_path / "parts"
        d.mkdir()
        for i in range(3):
            (d / f"p{i}.libsvm").write_text("1 1:1\n" * (i + 1))
        set_policy("io.filesys.*",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        inject.install("site=io.filesys.list,fault=ioerror,times=2")
        from dmlc_tpu_torch.io.input_split import list_split_files
        got = list_split_files(str(d))
        assert [os.path.basename(p) for p, _ in got] == \
            ["p0.libsvm", "p1.libsvm", "p2.libsvm"]
        assert retry_counts()["io.filesys.list"] == 2

    def test_spill_commit_retry(self, tmp_path):
        from dmlc_tpu_torch.data.row_iter import RoundSpillWriter
        set_policy("spill.commit",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        block = RowBlock(offset=[0, 2], label=[1.0],
                         index=np.array([0, 3], np.uint32),
                         value=[0.5, 1.5])
        w = RoundSpillWriter(str(tmp_path / "r.pages"), nparts=1)
        w.add_row([block])
        inject.install("site=spill.commit,fault=ioerror,times=2")
        f = w.commit()
        assert os.path.exists(f.path) and f.rounds == 1
        rows = list(f.iter_rows())
        assert len(rows) == 1
        np.testing.assert_array_equal(rows[0][0].index, block.index)
        assert retry_counts()["spill.commit"] == 2

    def test_spill_commit_is_a_span(self, tmp_path):
        from dmlc_tpu_torch.data.row_iter import RoundSpillWriter
        from dmlc_tpu_torch.obs import trace
        w = RoundSpillWriter(str(tmp_path / "s.pages"), nparts=1)
        w.add_row([RowBlock(offset=[0, 1], label=[0.0],
                            index=np.array([2], np.uint32), value=[1.0])])
        rec = trace.start()
        try:
            w.commit()
        finally:
            trace.stop()
        spans = [e for e in rec.events()
                 if e[0] == "X" and e[1] == "spill.commit"]
        assert len(spans) == 1 and spans[0][6]["rounds"] == 1

    def test_checkpoint_save_restore_retry(self, tmp_path):
        set_policy("checkpoint.*",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        from dmlc_tpu_torch.io.checkpoint import load_pytree, save_pytree
        path = str(tmp_path / "ck.bin")
        inject.install("site=checkpoint.save,fault=ioerror,times=2;"
                       "site=checkpoint.restore,fault=ioerror,times=2")
        save_pytree({"a": np.arange(5)}, path)
        out = load_pytree(path)
        np.testing.assert_array_equal(out["a"], np.arange(5))
        counts = retry_counts()
        assert counts["checkpoint.save"] == 2
        assert counts["checkpoint.restore"] == 2

    def test_checkpoint_save_exhaustion_raises(self, tmp_path):
        set_policy("checkpoint.save",
                   RetryPolicy(max_attempts=2, sleep=_noop_sleep))
        from dmlc_tpu_torch.io.checkpoint import save_pytree
        inject.install("site=checkpoint.save,fault=ioerror,times=9")
        with pytest.raises(IOError, match="injected fault"):
            save_pytree({"a": np.zeros(2)}, str(tmp_path / "ck2.bin"))

    def test_disk_row_iter_build_retries_transient_factory(
            self, tmpfile, tmp_path):
        data = tmpfile("d.libsvm",
                       b"1 0:1 3:2\n0 1:1\n1 2:5 4:1\n" * 50)
        set_policy("data.pages.build",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        from dmlc_tpu_torch.data.parser import Parser
        from dmlc_tpu_torch.data.row_iter import DiskRowIter
        calls = []

        def factory():
            calls.append(1)
            if len(calls) == 1:
                raise IOError("transient source")
            return Parser.create(data, 0, 1, format="libsvm")

        it = DiskRowIter(factory, str(tmp_path / "d.pages"))
        it.before_first()
        rows = 0
        while it.next():
            rows += it.value().size
        assert rows == 150
        assert len(calls) == 2
        assert retry_counts()["data.pages.build"] == 1

    def test_disk_row_iter_build_permanent_error_not_retried(
            self, tmp_path):
        from dmlc_tpu_torch.data.row_iter import DiskRowIter
        calls = []

        def factory():
            calls.append(1)
            raise FileNotFoundError("no such corpus")

        with pytest.raises(FileNotFoundError):
            DiskRowIter(factory, str(tmp_path / "x.pages"))
        assert len(calls) == 1

    def test_retry_is_counted_and_traced(self, tmpfile):
        from dmlc_tpu_torch.obs import trace
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        path = tmpfile("seam5.bin", b"t" * 32)
        set_policy("io.stream.open",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        before = REGISTRY.counter("resilience.retry").value
        injected0 = REGISTRY.counter("resilience.fault.injected").value
        inject.install("site=io.stream.open,fault=ioerror,times=1")
        from dmlc_tpu_torch.io.stream import create_stream
        rec = trace.start()
        try:
            with create_stream(path, "r") as s:
                assert s.read_all() == b"t" * 32
        finally:
            trace.stop()
        assert REGISTRY.counter("resilience.retry").value == before + 1
        assert REGISTRY.counter("resilience.fault.injected").value \
            == injected0 + 1
        names = [e[1] for e in rec.events() if e[0] == "i"]
        assert "retry/io.stream.open" in names
        assert "fault/io.stream.open" in names
        snap = REGISTRY.snapshot()["collectors"]["resilience"]
        assert snap["retry"]["io.stream.open"] == 1


# ------------------------------------------------------------ supervision

def _supervise(tmp_path, roles, script, timeout=None):
    """A GangSupervisor over ``roles`` (one member each) running
    ``script``, with the PS env a launcher would give each role."""
    path = tmp_path / "node.py"
    path.write_text(script)
    members = []
    for i, role in enumerate(roles):
        env = dict(os.environ)
        env.update(_gang_env({"DMLC_ROLE": role}))
        members.append(GangMember(f"{role}-{i}", role, i,
                                  [sys.executable, str(path)], env))
    return GangSupervisor(members, timeout=timeout).run()


class TestGangSupervision:
    def test_worker_exit0_early_keeps_gang_running(self, tmp_path):
        from dmlc_tpu_torch.parallel.launch import launch_local
        script = tmp_path / "w.py"
        script.write_text(
            "import os, sys, time\n"
            "rank = os.environ['DMLC_TPU_TASK_ID']\n"
            "if rank == '0':\n"
            "    sys.exit(0)  # finishes immediately\n"
            "time.sleep(1.0)\n"
            f"open(os.path.join({str(tmp_path)!r}, 'slow-done'), "
            "'w').close()\n")
        t0 = time.monotonic()
        codes = launch_local(2, [sys.executable, str(script)],
                             timeout=60)
        assert codes == [0, 0]
        assert time.monotonic() - t0 >= 1.0
        assert (tmp_path / "slow-done").exists()

    def test_ps_roles_drained_after_workers_finish(self, tmp_path):
        # launch_local's PS role set is not ported: the supervisor that
        # would own it drains service roles that outlive every worker
        t0 = time.monotonic()
        codes = _supervise(
            tmp_path, ["worker", "scheduler", "server"],
            "import os, sys, time\n"
            "role = os.environ.get('DMLC_ROLE', 'worker')\n"
            "if role == 'worker':\n"
            "    sys.exit(0)\n"
            "time.sleep(300)  # a real scheduler/server never exits\n")
        assert codes == [0, 0, 0]
        assert time.monotonic() - t0 < 60

    def test_ps_drain_beats_a_short_launch_timeout(self, tmp_path):
        codes = _supervise(
            tmp_path, ["worker", "scheduler", "server"],
            "import os, sys, time\n"
            "if os.environ.get('DMLC_ROLE', 'worker') == 'worker':\n"
            "    sys.exit(0)\n"
            "time.sleep(300)\n", timeout=10)
        assert codes == [0, 0, 0]

    def test_restart_survives_injected_crash(self, tmp_path):
        from dmlc_tpu_torch.parallel.launch import launch_local
        script = tmp_path / "w.py"
        script.write_text(
            "import os\n"
            "from dmlc_tpu_torch.resilience import inject\n"
            "inject.install_if_env()\n"
            "inject.fire('work.step')\n"
            f"open(os.path.join({str(tmp_path)!r}, 'ok-'\n"
            "     + os.environ['DMLC_TPU_TASK_ID'] + '-'\n"
            "     + os.environ['DMLC_TPU_ATTEMPT']), 'w').close()\n")
        codes = launch_local(
            2, [sys.executable, str(script)], env=_gang_env(),
            faults="site=work.step,fault=crash,rank=1,attempt=0",
            restart_policy=RestartPolicy(max_restarts=2,
                                         backoff_base_s=0.05),
            timeout=GANG_TIMEOUT)
        assert codes == [0, 0]
        assert (tmp_path / "ok-0-0").exists()
        assert (tmp_path / "ok-1-1").exists()
        assert not (tmp_path / "ok-1-0").exists()
        assert CRASH_EXIT != 0

    def test_launch_faults_plan_seed_reaches_workers(self, tmp_path):
        from dmlc_tpu_torch.parallel.launch import launch_local
        script = tmp_path / "w.py"
        script.write_text(
            "import os\n"
            "from dmlc_tpu_torch.resilience import inject\n"
            "plan = inject.install_if_env()\n"
            f"open(os.path.join({str(tmp_path)!r}, 'seed'), 'w')"
            ".write(str(plan.seed))\n")
        plan = FaultPlan.parse("site=never.fires,fault=ioerror,nth=999",
                               seed=42)
        codes = launch_local(1, [sys.executable, str(script)],
                             env=_gang_env(), faults=plan, timeout=60)
        assert codes == [0]
        assert (tmp_path / "seed").read_text() == "42"

    def test_budget_exhausted_tears_down_with_flight_bundle(
            self, tmp_path):
        from dmlc_tpu_torch.parallel.launch import launch_local
        flight_dir = tmp_path / "flight"
        script = tmp_path / "w.py"
        script.write_text(
            "from dmlc_tpu_torch.resilience import inject\n"
            "inject.install_if_env()\n"
            "inject.fire('work.step')\n")
        t0 = time.monotonic()
        with pytest.raises(DMLCError,
                           match="restart budget exhausted"):
            launch_local(
                1, [sys.executable, str(script)], env=_gang_env(),
                # every attempt crashes: no attempt= scope
                faults="site=work.step,fault=crash",
                restart_policy=RestartPolicy(max_restarts=1,
                                             backoff_base_s=0.05),
                flight_dir=str(flight_dir), timeout=GANG_TIMEOUT)
        assert time.monotonic() - t0 < 90  # teardown, not a hang
        bundles = [d for d in os.listdir(flight_dir)
                   if d.startswith("flight-")]
        assert bundles, "no launcher-side flight bundle written"
        reasons = []
        for b in bundles:
            with open(flight_dir / b / "MANIFEST.json") as f:
                reasons.append(json.load(f)["reason"])
        assert "gang_restart_budget_exhausted" in reasons

    def test_no_policy_keeps_first_failure_teardown(self, tmp_path):
        # without a restart policy the gang keeps the reference's
        # contract: the first nonzero exit kills it and the call raises
        from dmlc_tpu_torch.parallel.launch import launch_local
        script = tmp_path / "w.py"
        script.write_text(
            "import os, sys, time\n"
            "if os.environ['DMLC_TPU_TASK_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
        t0 = time.monotonic()
        with pytest.raises(DMLCError, match="gang killed on first"):
            launch_local(2, [sys.executable, str(script)],
                         env=_gang_env(), timeout=GANG_TIMEOUT)
        assert time.monotonic() - t0 < 30


# ------------------------------------------------------- gang acceptance

_GANG_WORKER = r"""
import hashlib, os, sys
from {pkg}.resilience import inject
inject.install_if_env()
from {pkg}.data.parser import Parser
uri, out_dir = sys.argv[1], sys.argv[2]
rank = int(os.environ["DMLC_TPU_TASK_ID"])
nparts = int(os.environ["DMLC_TPU_NUM_WORKER"])
h = hashlib.sha256()
count = 0
p = Parser.create(uri, rank, nparts, format="libsvm", chunk_size=16384)
p.before_first()
while p.next():
    inject.fire("gang.block")      # the armed mid-epoch crash site
    h.update(p.value().copy().content_hash().encode())
    count += 1
if hasattr(p, "destroy"):
    p.destroy()
tmp = os.path.join(out_dir, f"out-{{rank}}.tmp")
with open(tmp, "w") as f:
    f.write(f"{{count}} {{h.hexdigest()}}\n")
os.replace(tmp, os.path.join(out_dir, f"out-{{rank}}.txt"))
"""


@pytest.fixture(scope="module")
def gang_data(tmp_path_factory):
    rng = np.random.RandomState(11)
    lines = [f"{i % 2} " + " ".join(
        f"{j}:{rng.rand():.5f}"
        for j in np.sort(rng.choice(400, rng.randint(2, 8),
                                    replace=False)))
        for i in range(20000)]
    p = tmp_path_factory.mktemp("resg") / "g.libsvm"
    p.write_bytes(("\n".join(lines) + "\n").encode())
    return str(p)


class TestGangCrashAcceptance:
    """A real 2-process port gang + an injected mid-epoch crash ->
    auto-restart -> the reference's fault-free epoch output, byte for
    byte, with the restart in the launcher's counter and on the merged
    gang trace."""

    def _run_gang(self, mod, pkg, data, out_dir, tmp_path, faults=None,
                  restart_policy=None, trace_dir=None):
        worker = tmp_path / f"gw_{pkg}.py"
        worker.write_text(_GANG_WORKER.format(pkg=pkg))
        os.makedirs(out_dir, exist_ok=True)
        codes = mod.launch_local(
            2, [sys.executable, str(worker), data, out_dir],
            env=_gang_env(), faults=faults,
            restart_policy=restart_policy, trace_dir=trace_dir,
            timeout=GANG_TIMEOUT)
        return codes, {r: open(os.path.join(out_dir, f"out-{r}.txt"))
                       .read() for r in range(2)}

    def test_gang_survives_midepoch_crash_byte_identical(
            self, gang_data, tmp_path):
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        from dmlc_tpu_torch.parallel import launch
        trace_dir = str(tmp_path / "traces")
        # golden: the reference's fault-free gang
        codes, clean = self._run_gang(ref_launch, "dmlc_tpu", gang_data,
                                      str(tmp_path / "clean"), tmp_path)
        assert codes == [0, 0]
        assert all(int(v.split()[0]) > 3 for v in clean.values())

        # chaos: port rank 1 hard-crashes at its 3rd block, attempt 0
        before = REGISTRY.counter("resilience.restart").value
        codes, chaos = self._run_gang(
            launch, "dmlc_tpu_torch", gang_data, str(tmp_path / "chaos"),
            tmp_path,
            faults="site=gang.block,fault=crash,nth=3,rank=1,attempt=0",
            restart_policy=RestartPolicy(max_restarts=2,
                                         backoff_base_s=0.05),
            trace_dir=trace_dir)
        assert codes == [0, 0]
        # the restarted worker replayed its identical shard stream
        assert chaos == clean
        assert REGISTRY.counter("resilience.restart").value == before + 1
        assert REGISTRY.gauge("resilience.gang.restarts").value == 1
        with open(os.path.join(trace_dir, "trace-gang.json")) as f:
            merged = json.load(f)
        names = [e.get("name") for e in merged["traceEvents"]]
        assert names.count("gang/restart/worker-1") == 1
        assert sum(n.startswith("gang/spawn/") for n in names if n) == 3


# ---------------------------------------------------------- bench chaos

class TestBenchChaos:
    def test_bench_suite_chaos_degrades_not_aborts(
            self, tmpfile, monkeypatch, capsys):
        from dmlc_tpu_torch import bench_suite
        data = tmpfile("bench.bin", b"y" * 4096)
        set_policy("io.stream.*",
                   RetryPolicy(max_attempts=4, sleep=_noop_sleep))

        def chaos_probe(mb, dev):
            from dmlc_tpu_torch.io.stream import create_stream
            t0 = time.perf_counter()
            with create_stream(data, "r") as s:
                payload = s.read_exact(4096)
            dt = time.perf_counter() - t0
            return {"config": "chaos_probe", "gbps": 4096 / dt / 1e9,
                    "bytes": len(payload)}

        def doomed(mb, dev):
            inject.fire("bench.doomed")  # always-armed ioerror below
            return {"config": "doomed", "gbps": 0.0}

        # one main() over BOTH configs (doomed first) so the per-config
        # delta baselines are exercised across a failing config
        monkeypatch.setattr(bench_suite, "CONFIGS",
                            {98: ("doomed", doomed),
                             99: ("chaos_probe", chaos_probe)})
        bench_suite.main([
            "--mb", "1", "--cold",
            "--chaos",
            "site=bench.doomed,fault=ioerror;"
            "site=io.stream.open,fault=ioerror,times=1;"
            "site=io.stream.read,fault=ioerror,times=1"])
        out = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.strip()]
        assert len(out) == 2
        assert "error" in out[0]
        assert "error" not in out[1]
        assert out[1]["bytes"] == 4096
        assert out[1]["chaos"]["injected"] == 2
        assert out[1]["chaos"]["retries"]["io.stream.open"] == 1
        assert "bench.doomed" not in out[1]["chaos"]["retries"]
