"""The port's utility layer (``dmlc_tpu_torch.utils``) against the JAX
package's: ``Config``, the blocking queues, ``ThreadGroup`` with
``ManualEvent`` and ``ThreadLocalStore``, the tagged ``serialize``/
``deserialize`` and the package's export list. Each case runs the
reference and the port on the same input (made from a seed with numpy
where it is random) and compares what they give: values, orders and
errors, and for the serializer the bytes, each package reading the
other's."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import dmlc_tpu.utils as ref_utils
from dmlc_tpu.io.stream import MemoryStream as RefMemoryStream
from dmlc_tpu.utils import serializer as ref_ser
from dmlc_tpu.utils.concurrency import (
    ConcurrentBlockingQueue as RefQueue,
    PriorityBlockingQueue as RefPriorityQueue,
)
from dmlc_tpu.utils.config import Config as RefConfig
from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
from dmlc_tpu.utils.thread_group import (
    ManualEvent as RefManualEvent, ThreadGroup as RefThreadGroup,
    ThreadLocalStore as RefThreadLocalStore,
)
import dmlc_tpu_torch.utils as utils
from dmlc_tpu_torch.io.stream import MemoryStream
from dmlc_tpu_torch.utils import serializer as ser
from dmlc_tpu_torch.utils.concurrency import (
    ConcurrentBlockingQueue, PriorityBlockingQueue,
)
from dmlc_tpu_torch.utils.config import Config
from dmlc_tpu_torch.utils.logging import DMLCError
from dmlc_tpu_torch.utils.thread_group import (
    ManualEvent, ThreadGroup, ThreadLocalStore,
)

# ---------------------------------------------------------------- Config

CONFIG_TEXTS = {
    "basic": "a = 1\nb = hello # comment\n# full comment\nc=3",
    "multi": "k = 1\nk = 2\nj = x\nk = 3",
    "quoted": 'msg = "hello # world \\"quoted\\""\nempty = ""',
    "escapes": 'p = "C:\\\\dir\\\\f"\nq = "tab\there"\n  r   =  spaced  ',
    "crlf": "a = 1\r\nb = 2\r\n\r\n",
    "hash_in_quote": 'u = "a#b" # trailing\nv = a#b',
}


@pytest.mark.parametrize("multi_value", [True, False])
@pytest.mark.parametrize("name", sorted(CONFIG_TEXTS))
def test_config_equals_reference(name, multi_value):
    text = CONFIG_TEXTS[name]
    ref = RefConfig(text, multi_value=multi_value)
    got = Config(text, multi_value=multi_value)
    assert list(got) == list(ref)
    assert got.to_dict() == ref.to_dict()
    assert got.proto_string() == ref.proto_string()
    for key in {k for k, _ in ref}:
        assert got.get_param(key) == ref.get_param(key)
        assert got.get_all(key) == ref.get_all(key)
        assert key in got
    assert "absent" not in got
    with pytest.raises(DMLCError, match="not found"):
        got.get_param("absent")
    # proto round trip, through each package's parser of the other's text
    assert list(Config(ref.proto_string())) == list(ref)
    assert list(RefConfig(got.proto_string())) == list(got)


@pytest.mark.parametrize("text", ["nonsense line", " = 3", "a = 1\nb"])
def test_config_refuses_what_the_reference_refuses(text):
    with pytest.raises(RefDMLCError) as ref_err:
        RefConfig(text)
    with pytest.raises(DMLCError) as err:
        Config(text)
    assert str(err.value) == str(ref_err.value)


def test_config_from_file_and_set_param(tmp_path):
    p = tmp_path / "c.conf"
    p.write_text('lr = 0.1\nname = "my model"\nlr = 0.2\n')
    ref, got = RefConfig.from_file(str(p)), Config.from_file(str(p))
    assert list(got) == list(ref)
    for cfg in (ref, got):
        cfg.set_param("extra", 7)
    assert list(got) == list(ref) and got.get_param("extra") == "7"
    single = (RefConfig.from_file(str(p), multi_value=False),
              Config.from_file(str(p), multi_value=False))
    assert list(single[1]) == list(single[0]) == [
        ("name", "my model"), ("lr", "0.2")]

# ---------------------------------------------------------------- queues


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fifo_queue_order_equals_reference(seed):
    items = np.random.RandomState(seed).randint(0, 1000, 40).tolist()
    out = []
    for cls in (RefQueue, ConcurrentBlockingQueue):
        q = cls(max_size=64)
        for x in items:
            assert q.push(x)
        assert q.size() == len(items)
        out.append([q.pop() for _ in items])
        assert q.size() == 0
        assert q.pop(timeout=0.01) is None
    assert out[1] == out[0] == items


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_priority_queue_order_equals_reference(seed):
    rng = np.random.RandomState(seed)
    prios = rng.randint(0, 10, 30).tolist()
    out = []
    for cls in (RefPriorityQueue, PriorityBlockingQueue):
        q = cls()
        for i, p in enumerate(prios):
            if i % 2:
                q.push((p, f"item{i}"))
            else:
                q.push(f"item{i}", priority=p)
        out.append([q.pop() for _ in prios])
    assert out[1] == out[0]
    assert [p for p, _ in out[1]] == sorted(prios, reverse=True)


@pytest.mark.parametrize("cls", [ConcurrentBlockingQueue,
                                 PriorityBlockingQueue])
def test_kill_unblocks_a_consumer_and_a_producer(cls):
    q = cls()
    got = []
    t = threading.Thread(target=lambda: got.append(q.pop()))
    t.start()
    time.sleep(0.05)
    q.signal_for_kill()
    t.join(timeout=2)
    assert not t.is_alive() and got == [None]

    q = cls(max_size=1)
    q.push((1, "a"))
    done = []
    t = threading.Thread(target=lambda: done.append(q.push((2, "b"))))
    t.start()
    time.sleep(0.05)
    q.signal_for_kill()
    t.join(timeout=2)
    assert not t.is_alive() and done == [False]
    assert q.push((3, "c")) is False  # a killed queue takes nothing


def test_bounded_queue_hands_items_between_threads():
    q = ConcurrentBlockingQueue(max_size=2)
    n = 200
    t = threading.Thread(target=lambda: [q.push(i) for i in range(n)])
    t.start()
    got = [q.pop() for _ in range(n)]
    t.join(timeout=5)
    assert got == list(range(n))

# ---------------------------------------------------------------- threads


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_thread_group_lifecycle(pkg):
    Group, Event = ((RefThreadGroup, RefManualEvent) if pkg == "reference"
                    else (ThreadGroup, ManualEvent))
    Error = RefDMLCError if pkg == "reference" else DMLCError
    g = Group()
    results = []
    g.create("worker-a", lambda: results.append("a"))
    g.create("worker-b", lambda x: results.append(x), "b")
    g.join_all()
    assert sorted(results) == ["a", "b"] and g.size() == 0

    stopped = []

    def loop():
        t = g.thread("loop")
        while not t.shutdown_requested:
            time.sleep(0.005)
        stopped.append(True)

    g.create("loop", loop)
    time.sleep(0.05)
    assert g.size() == 1 and g.thread("loop").joinable()
    g.request_shutdown_all()
    g.join_all(timeout_per_thread=2)
    assert stopped == [True] and g.size() == 0

    ev = Event()
    g.create("x", ev.wait, 5)
    with pytest.raises(Error, match="already running"):
        g.create("x", lambda: None)
    ev.signal()
    g.join_all()
    g.create("x", lambda: None)  # a finished name may be reused
    g.join_all()
    assert g.thread("absent") is None


def test_manual_event_equals_reference():
    for ev in (RefManualEvent(), ManualEvent()):
        assert not ev.is_set() and not ev.wait(0.01)
        ev.signal()
        assert ev.is_set() and ev.wait(0.01)
        ev.reset()
        assert not ev.is_set()


def test_thread_local_store_is_one_value_a_thread():
    made = []

    def factory():
        made.append(threading.get_ident())
        return object()

    main = ThreadLocalStore.get("k", factory)
    assert ThreadLocalStore.get("k", factory) is main
    other = []
    t = threading.Thread(
        target=lambda: other.append(ThreadLocalStore.get("k", factory)))
    t.start()
    t.join()
    assert other[0] is not main and len(made) == 2
    # the two packages keep separate stores
    assert RefThreadLocalStore.get("k", object) is not main

# ---------------------------------------------------------------- serializer


def _tree(seed):
    """One nested tree holding every tag (0-9) and the numpy scalars the
    writer folds into tags 2 and 3."""
    rng = np.random.RandomState(seed)
    return {
        "none": None, "flags": [True, False],
        "ints": [0, -1, 2 ** 62, int(rng.randint(-1000, 1000))],
        "floats": (float(rng.randn()), -0.0, 1e300),
        "text": "héllo ✓", "raw": b"\x00\xff" + rng.bytes(7),
        "buf": bytearray(b"ab"),
        "np_scalars": [np.int32(-7), np.uint64(9), np.float32(0.25)],
        "arrays": [rng.randn(3, 4).astype(np.float32),
                   rng.randint(0, 2 ** 31, 5).astype(np.uint32),
                   rng.randint(-5, 5, (2, 0, 3)).astype(np.int64),
                   np.array(3.5), np.arange(6, dtype=">i4")[::2]],
        7: ({"nested": [[], (), {}]},),
        ("a", 1): "tuple key",
    }


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and (a == b or (a != a and b != b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tagged_bytes_equal_the_reference_and_read_across(seed):
    tree = _tree(seed)
    ref_s, s = RefMemoryStream(), MemoryStream()
    ref_ser.serialize(tree, ref_s)
    ser.serialize(tree, s)
    raw = s.getvalue()
    assert raw == ref_s.getvalue()
    tags = {raw[0]}
    assert tags == {7}
    # each package reads the other's bytes into the same tree
    ours = ser.deserialize(MemoryStream(ref_s.getvalue()))
    theirs = ref_ser.deserialize(RefMemoryStream(raw))
    assert _equal(ours, theirs)
    assert ours["text"] == tree["text"] and ours["raw"] == tree["raw"]
    assert ours["buf"] == b"ab" and ours["np_scalars"] == [-7, 9, 0.25]
    assert _equal(ours["arrays"][0], tree["arrays"][0])
    assert ours["arrays"][3].shape == () and ours[("a", 1)] == "tuple key"


def test_every_tag_is_written_as_the_reference_writes_it():
    samples = [None, True, 5, 2.5, "s", b"b", [1], {"k": 1}, (1,),
               np.zeros(2, np.float32)]
    for tag, obj in enumerate(samples):
        ref_s, s = RefMemoryStream(), MemoryStream()
        ref_ser.serialize(obj, ref_s)
        ser.serialize(obj, s)
        assert s.getvalue() == ref_s.getvalue()
        assert s.getvalue()[0] == tag


@pytest.mark.parametrize("obj", [torch.zeros(3), {1, 2}, object(), 1j],
                         ids=["tensor", "set", "object", "complex"])
def test_unsupported_types_raise_by_name_as_the_reference(obj):
    with pytest.raises(RefDMLCError) as ref_err:
        ref_ser.serialize(obj, RefMemoryStream())
    with pytest.raises(DMLCError) as err:
        ser.serialize(obj, MemoryStream())
    assert str(err.value) == str(ref_err.value)
    assert type(obj).__name__ in str(err.value)


def test_bad_tag_raises():
    with pytest.raises(DMLCError, match="bad tag 10"):
        ser.deserialize(MemoryStream(b"\x0a"))

# ---------------------------------------------------------------- exports


def _fresh(code):
    """Run ``code`` in a new interpreter: its import order is its own."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": repo,
                               "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_utils_exports_equal_the_reference():
    """The exports, and ``utils.profiler`` the process profiler where
    nothing has imported the ``utils/profiler.py`` shim (a fresh
    interpreter: that import rebinds the name, see the next test)."""
    assert utils.__all__ == ref_utils.__all__
    for name in utils.__all__:
        assert getattr(utils, name) is not None
    assert utils.Config is Config and utils.ThreadGroup is ThreadGroup
    _fresh("import dmlc_tpu_torch.utils as utils\n"
           "from dmlc_tpu_torch.obs import trace\n"
           "assert utils.profiler is trace.profiler\n"
           "assert utils.Profiler is trace.Profiler\n")


def test_importing_the_profiler_shim_rebinds_the_name_as_the_reference():
    """``import <pkg>.utils.profiler`` sets the package attribute to the
    submodule, over the exported object, in both packages alike."""
    _fresh("import types\n"
           "import dmlc_tpu.utils as ref_utils\n"
           "import dmlc_tpu.utils.profiler\n"
           "import dmlc_tpu_torch.utils as utils\n"
           "import dmlc_tpu_torch.utils.profiler\n"
           "assert isinstance(ref_utils.profiler, types.ModuleType)\n"
           "assert isinstance(utils.profiler, types.ModuleType)\n"
           "assert utils.profiler.__name__ == 'dmlc_tpu_torch.utils.profiler'\n"
           "assert ref_utils.profiler.__name__ == 'dmlc_tpu.utils.profiler'\n")
