"""The port's import surface against the reference's.

Every module of ``dmlc_tpu`` that declares ``__all__`` has a module at
the same path under ``dmlc_tpu_torch`` whose ``__all__`` lists each of
those names, or its counterpart in ``RENAMES``, and which defines it.
The reference's ``__all__`` is read from its source by AST, so no jax
is imported for it. Beside that: the members the reference's classes
and functions have (``Serializable``, ``segment_sum``, ``URISpec.scheme``
and ``str_spec``, ``ThreadedIter.recycle``, ``HostStaging.reset_epoch``,
``device_prefetch(sharding=)``, ``init_from_env(force=)``), each held to
the reference on the same inputs.
"""

import ast
import importlib
import inspect
import os
import struct

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "dmlc_tpu")

# the reference's modules and names whose port counterparts are named
# after the card; every other module and name keeps its name
MODULE_RENAMES = {"dmlc_tpu.io.tpu_fs": "dmlc_tpu_torch.io.cuda_fs"}
RENAMES = {"TPUFileSystem": "CUDAFileSystem",
           "TPUSeekStream": "CUDASeekStream",
           "TPUWriteStream": "CUDAWriteStream",
           "jax_trace": "cuda_trace"}


def _literal(node, assigned):
    """The value of an ``__all__`` expression: a list or tuple literal,
    or ``sorted(NAME)`` of a set literal assigned earlier in the
    module."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "sorted" and len(node.args) == 1
            and isinstance(node.args[0], ast.Name)):
        return sorted(assigned[node.args[0].id])
    return list(ast.literal_eval(node))


def _reference_all(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    assigned, names = {}, None
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            if t.id == "__all__":
                names = _literal(node.value, assigned)
            elif isinstance(node.value, (ast.Set, ast.List, ast.Tuple)):
                try:
                    assigned[t.id] = ast.literal_eval(node.value)
                except ValueError:  # not a literal: no __all__ reads it
                    pass
    return names


def _reference_modules():
    out = []
    for dirpath, dirnames, filenames in os.walk(REF):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            names = _reference_all(path)
            if names is None:
                continue
            rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            out.append((rel[:-len(".__init__")]
                        if rel.endswith(".__init__") else rel, names))
    return out


REFERENCE_MODULES = _reference_modules()


def test_the_reference_declares_its_surface():
    mods = dict(REFERENCE_MODULES)
    assert len(mods) >= 80
    assert "dmlc_tpu" in mods and "dmlc_tpu.parallel" in mods
    # the AST reader handles the one computed __all__
    assert mods["dmlc_tpu.utils.profiler"] == ["Profiler", "StageStats",
                                               "profiler", "trace"]


def test_the_rename_tables_name_only_real_renames():
    """Each rename maps a name the reference exports to one the port
    exports under the renamed module, and no name the port keeps."""
    ref_names = {n for _, names in REFERENCE_MODULES for n in names}
    assert set(RENAMES) <= ref_names
    for ref_mod, port_mod in MODULE_RENAMES.items():
        assert ref_mod in dict(REFERENCE_MODULES)
        assert not os.path.exists(os.path.join(
            REPO, *port_mod.split(".")[:-1], ref_mod.split(".")[-1] + ".py"))
    for old, new in RENAMES.items():
        assert old != new
        port_all = set()
        for mod, names in REFERENCE_MODULES:
            if old in names:
                port_all |= set(importlib.import_module(
                    MODULE_RENAMES.get(mod, mod.replace(
                        "dmlc_tpu", "dmlc_tpu_torch", 1))).__all__)
        assert new in port_all and old not in port_all


@pytest.mark.parametrize("module,names", REFERENCE_MODULES,
                         ids=[m for m, _ in REFERENCE_MODULES])
def test_every_reference_name_imports_from_the_port(module, names):
    port_name = MODULE_RENAMES.get(
        module, module.replace("dmlc_tpu", "dmlc_tpu_torch", 1))
    port = importlib.import_module(port_name)
    exported = set(getattr(port, "__all__", ()))
    missing = [n for n in names
               if RENAMES.get(n, n) not in exported
               or not hasattr(port, RENAMES.get(n, n))]
    assert not missing, f"{port_name} lacks {missing}"


# ------------------------------------------------------------ Serializable

def _pair_class(base):
    class Pair(base):
        """A count and a float, then a length-prefixed name."""

        def __init__(self, n=0, x=0.0, name=b""):
            self.n, self.x, self.name = n, x, name

        def save(self, stream):
            stream.write(struct.pack("<qf", self.n, self.x))
            stream.write(struct.pack("<I", len(self.name)) + self.name)

        def load(self, stream):
            self.n, self.x = struct.unpack("<qf", stream.read(12))
            (k,) = struct.unpack("<I", stream.read(4))
            self.name = stream.read(k)

    return Pair


@pytest.mark.parametrize("n,x,name", [(0, 0.0, b""), (-3, 1.5, b"abc"),
                                      (2 ** 40, -2.25, bytes(range(256)))])
def test_serializable_writes_the_reference_bytes(n, x, name):
    from dmlc_tpu.io import stream as ref_stream
    from dmlc_tpu_torch.io import MemoryStream, Serializable
    ours, theirs = MemoryStream(), ref_stream.MemoryStream()
    _pair_class(Serializable)(n, x, name).save(ours)
    _pair_class(ref_stream.Serializable)(n, x, name).save(theirs)
    assert ours.getvalue() == theirs.getvalue()
    back = _pair_class(Serializable)()
    back.load(MemoryStream(theirs.getvalue()))
    assert (back.n, back.x, back.name) == (n, x, name)


def test_serializable_base_raises_as_the_reference():
    from dmlc_tpu.io import stream as ref_stream
    from dmlc_tpu_torch.io import MemoryStream, Serializable
    for base, stream in ((Serializable, MemoryStream()),
                         (ref_stream.Serializable,
                          ref_stream.MemoryStream())):
        for fn in (base().save, base().load):
            with pytest.raises(NotImplementedError):
                fn(stream)


# ------------------------------------------------------------- segment_sum

def _segment_case(seed, dtype, width, num_segments):
    """Seeded data and ids with out-of-range and negative ids and
    segment 1 left empty."""
    rng = np.random.RandomState(seed)
    n = 200
    ids = rng.randint(-3, num_segments + 3, size=n).astype(np.int32)
    ids[ids == 1] = 0  # an empty segment
    ids[:3] = (-1, num_segments, num_segments + 7)
    shape = (n,) if width is None else (n, width)
    if np.issubdtype(dtype, np.integer):
        data = rng.randint(-1000, 1000, size=shape).astype(dtype)
    else:
        data = rng.randn(*shape).astype(dtype)
    return data, ids


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
@pytest.mark.parametrize("width", [None, 5])
@pytest.mark.parametrize("num_segments", [17, None])
def test_segment_sum_matches_jax(dtype, width, num_segments):
    from dmlc_tpu_torch.ops.csr import segment_sum
    data, ids = _segment_case(7, dtype, width, num_segments or 17)
    if num_segments is None:
        ids = np.maximum(ids, 0)  # max id + 1 rows: no negative ids
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids),
                      num_segments).numpy()
    with jax.enable_x64(dtype == np.int64):
        want = np.asarray(jax.ops.segment_sum(
            data, ids, num_segments=num_segments))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert not got[1].any()  # the empty segment
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_segment_sum_is_the_reference_export():
    from dmlc_tpu.ops import csr as ref_csr
    from dmlc_tpu_torch.ops import csr
    assert ref_csr.segment_sum is jax.ops.segment_sum
    assert "segment_sum" in csr.__all__
    with pytest.raises(Exception, match="one id a row"):
        csr.segment_sum(torch.ones(3), torch.zeros(2, dtype=torch.int64), 4)


# ----------------------------------------------------------------- URISpec

# tests/test_pagestore.py's TestURISpecScheme cases and the splitting
# edge cases of the reference's docstring
URIS = ["obj://bucket/key?format=csv&label_column=0#cachefile",
        "data/train.csv?format=csv", "tpu:///tmp/x.rec#cache",
        "obj://b/a.txt;/local/b.txt;s3://c/d.txt",
        "s3://bucket/data.libsvm?format=libsvm", "obj://bucket/data.txt#c.bin",
        "/plain/path", "cuda:///tmp/x.rec?x=1#c", "a?b=1&&c=2#",
        "we?ird://x/y#z"]


@pytest.mark.parametrize("raw", URIS)
def test_urispec_scheme_and_str_spec_match_the_reference(raw):
    from dmlc_tpu.io.uri_spec import URISpec as RefURISpec
    from dmlc_tpu_torch.io.uri_spec import URISpec
    ours, theirs = URISpec(raw), RefURISpec(raw)
    for attr in ("uri", "cache_file", "args", "scheme"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.paths() == theirs.paths()
    assert ours.str_spec() == theirs.str_spec()
    assert URISpec(ours.str_spec()).str_spec() == ours.str_spec()


# --------------------------------------------------------- the other members

def test_threaded_iter_recycle_is_a_no_op():
    from dmlc_tpu.data.threaded_iter import ThreadedIter as RefThreadedIter
    from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
    src = iter([1, 2, 3])
    it = ThreadedIter(max_capacity=2)
    it.init(lambda: next(src, None))
    try:
        first = it.next()
        assert it.recycle(first) is None
        assert [first, it.next(), it.next()] == [1, 2, 3]
    finally:
        it.destroy()
    assert (list(inspect.signature(ThreadedIter.recycle).parameters)
            == list(inspect.signature(RefThreadedIter.recycle).parameters))


def test_host_staging_reset_epoch_zeroes_its_seconds():
    from dmlc_tpu_torch.parallel.device_iter import HostStaging
    pool = HostStaging(slots=2, alias_unsafe=True)
    pool.release(pool.stage({"x": np.ones(8, np.float32)}))
    assert pool.assemble_s > 0
    pool.reset_epoch()
    assert pool.assemble_s == 0.0


@pytest.mark.parametrize("fn,param", [
    ("dmlc_tpu_torch.parallel.device_iter.device_prefetch", "sharding"),
    ("dmlc_tpu_torch.parallel.launch.init_from_env", "force")])
def test_the_reference_keywords_are_accepted(fn, param):
    mod, name = fn.rsplit(".", 1)
    ours = inspect.signature(getattr(importlib.import_module(mod), name))
    assert param in ours.parameters
    assert ours.parameters[param].default in (None, False)


def _host_batches(n=3):
    rng = np.random.RandomState(3)
    return [{"x": rng.randn(4, 6).astype(np.float32),
             "i": rng.randint(0, 9, size=(4, 2)).astype(np.uint32)}
            for _ in range(n)]


@pytest.mark.parametrize("staging", [False, True])
@pytest.mark.parametrize("spec", [("data",), ("data", "model"), ()])
def test_device_prefetch_sharding_places_as_device_put(staging, spec):
    from dmlc_tpu_torch.parallel import device_prefetch
    from dmlc_tpu_torch.parallel.placement import (
        NamedSharding, P, PlacedTensor, device_put,
    )
    from dmlc_tpu_torch.parallel.sharded import Mesh
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    sharding = NamedSharding(mesh, P(*spec))
    got = list(device_prefetch(iter(_host_batches()), size=2,
                               sharding=sharding, staging=staging))
    plain = list(device_prefetch(iter(_host_batches()), size=2,
                                 device="cpu", staging=staging))
    assert len(got) == len(plain) == 3
    for g, p in zip(got, plain):
        assert g.keys() == p.keys()
        for k in g:
            want = device_put(p[k], sharding, name=k)
            assert isinstance(g[k], PlacedTensor)
            assert g[k].shape == want.shape
            for a, b in zip(g[k].addressable_shards,
                            want.addressable_shards):
                assert a.index == b.index and a.replica_id == b.replica_id
                assert torch.equal(a.data, b.data)


def test_device_prefetch_takes_a_device_or_a_named_sharding_only():
    from dmlc_tpu_torch.parallel import device_prefetch
    from dmlc_tpu_torch.utils.logging import DMLCError
    got = list(device_prefetch(iter(_host_batches(2)),
                               sharding=torch.device("cpu")))
    want = _host_batches(2)
    for g, w in zip(got, want):
        assert all(g[k].device.type == "cpu"
                   and np.array_equal(g[k].numpy(), w[k]) for k in w)
    for kw in ({"sharding": "cpu"},
               {"sharding": torch.device("cpu"), "device": "cpu"}):
        with pytest.raises(DMLCError):
            list(device_prefetch(iter(_host_batches(1)), **kw))
