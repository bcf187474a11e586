"""Import contract of the PyTorch/CUDA port (dmlc_tpu_torch).

The port imports torch and numpy, never jax, and nothing of the JAX
package dmlc_tpu (it keeps its own copies of the host modules it needs).
Checked twice: in a fresh interpreter (tests/conftest.py imports jax into
this one), and by an AST scan of every file of the package, of the
example twins under examples/torch_port/, of chip_smoke.py and of
scripts/multicard_quick.py. Also: chip_smoke.py refuses to run without a CUDA card,
and the kernel paths raise instead of falling back.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dmlc_tpu_torch.native import build
from dmlc_tpu_torch.ops import csr
from dmlc_tpu_torch.utils.logging import DMLCError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dmlc_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "dmlc_tpu")


def _port_files():
    out = []
    for root in (PKG, os.path.join(REPO, "examples", "torch_port")):
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("build", "__pycache__"))
            out += [os.path.join(dirpath, f) for f in sorted(filenames)
                    if f.endswith(".py")]
    return out + [os.path.join(REPO, "chip_smoke.py"),
                  os.path.join(REPO, "scripts", "multicard_quick.py")]


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_leaves_jax_and_dmlc_tpu_unimported():
    code = (
        "import pkgutil, sys\n"
        "import dmlc_tpu_torch\n"
        "for m in pkgutil.walk_packages(dmlc_tpu_torch.__path__,\n"
        "                               'dmlc_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'dmlc_tpu'))\n"
        "print(len([k for k in sys.modules\n"
        "           if k.startswith('dmlc_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20  # every submodule was imported, not just the root


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_file_imports_jax_or_dmlc_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


NEW_MODULES = ("dmlc_tpu_torch.bench_transfer",
               "dmlc_tpu_torch.testing",
               "dmlc_tpu_torch.bench_mp_worker",
               "dmlc_tpu_torch.io.checkpoint",
               "dmlc_tpu_torch.utils.json_util",
               "dmlc_tpu_torch.obs",
               "dmlc_tpu_torch.obs.metrics",
               "dmlc_tpu_torch.obs.log",
               "dmlc_tpu_torch.obs.trace",
               "dmlc_tpu_torch.obs.export",
               "dmlc_tpu_torch.utils.profiler",
               "dmlc_tpu_torch.utils.timer",
               "dmlc_tpu_torch.io.tempdir",
               "dmlc_tpu_torch.io.threaded_split",
               "dmlc_tpu_torch.io.input_split_shuffle",
               "dmlc_tpu_torch.io.cached_split",
               "dmlc_tpu_torch.shuffle.permutation",
               "dmlc_tpu_torch.resilience",
               "dmlc_tpu_torch.resilience.inject",
               "dmlc_tpu_torch.resilience.policy",
               "dmlc_tpu_torch.resilience.supervise",
               "dmlc_tpu_torch.obs.watchdog",
               "dmlc_tpu_torch.obs.flight",
               "dmlc_tpu_torch.data.csv_parser",
               "dmlc_tpu_torch.data.parquet_parser",
               "dmlc_tpu_torch.io.indexed_recordio_split",
               "dmlc_tpu_torch.obs.rpc",
               "dmlc_tpu_torch.io.objstore",
               "dmlc_tpu_torch.io.objstore.emulator",
               "dmlc_tpu_torch.io.objstore.fs",
               "dmlc_tpu_torch.io.objstore.multipart",
               "dmlc_tpu_torch.io.objstore.http_client",
               "dmlc_tpu_torch.rendezvous",
               "dmlc_tpu_torch.rendezvous.elastic",
               "dmlc_tpu_torch.rendezvous.service",
               "dmlc_tpu_torch.obs.serve",
               "dmlc_tpu_torch.io.objstore.peer",
               "dmlc_tpu_torch.bench_peer_worker",
               "dmlc_tpu_torch.bench_ckpt_worker",
               "dmlc_tpu_torch.shuffle",
               "dmlc_tpu_torch.shuffle.index",
               "dmlc_tpu_torch.shuffle.exchange",
               "dmlc_tpu_torch.shuffle.split",
               "dmlc_tpu_torch.bench_shuffle_worker",
               "dmlc_tpu_torch.bench_elastic_worker",
               "dmlc_tpu_torch.utils.config",
               "dmlc_tpu_torch.utils.concurrency",
               "dmlc_tpu_torch.utils.thread_group",
               "dmlc_tpu_torch.parallel.backends",
               "dmlc_tpu_torch",
               "dmlc_tpu_torch.io",
               "dmlc_tpu_torch.ops",
               "dmlc_tpu_torch.parallel",
               "dmlc_tpu_torch.parallel.launch",
               "dmlc_tpu_torch.graft")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_transfer_and_checkpoint_modules_import_alone(module):
    """The transfer probe, the multi-process bench worker, the checkpoint
    plane and its JSON helpers, the trace and split planes' modules, the
    resilience plane, watchdog and flight recorder, the csv, Parquet
    and indexed-RecordIO modules, the object-store plane (with the
    RPC trace plane and the ownership rule), and the gang plane (the
    status server, the peer tier, rendezvous membership and the two
    gang bench workers), the global shuffle plane (its four modules
    and the config 20 and 23 workers), dmlc-core's utility bricks
    and submit generators (config, queues, thread group, backends), and
    the packages that export the reference's names, the launcher and
    the graft twin, import in a fresh
    interpreter without jax or dmlc_tpu (each is also in the AST scan
    above)."""
    path = os.path.join(REPO, *module.split("."))
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    assert path in _port_files()
    code = (f"import sys, {module}\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'dmlc_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


HTTP_CLIENT_FILES = ("dmlc_tpu_torch/io/objstore/http_client.py",)
# the status server's side of the gang plane
HTTP_SERVER_FILES = ("dmlc_tpu_torch/obs/serve.py",)


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_only_the_objstore_wire_client_imports_http_client(path):
    """The real HTTP wire client is the one module of the port that
    speaks ``http.client``, and ``import dmlc_tpu_torch`` does not load
    it (``test_import_does_not_load_the_wire_client``). The status
    server (``obs/serve.py``) is the one module that imports
    ``http.server``; no module imports ``http`` another way."""
    rel = os.path.relpath(path, REPO)
    for mod in _imported_modules(path):
        if mod.split(".")[0] != "http":
            continue
        if mod == "http.server":
            assert rel in HTTP_SERVER_FILES
        else:
            assert rel in HTTP_CLIENT_FILES


def test_import_does_not_load_the_wire_client():
    """``import dmlc_tpu_torch`` registers ``obj://`` and ``s3://`` and
    leaves the objstore wire client unimported (torch itself imports
    ``http.client``, so the probe is the port's module)."""
    code = ("import sys\n"
            "import dmlc_tpu_torch\n"
            "from dmlc_tpu_torch.io.filesys import FileSystem\n"
            "assert {'obj://', 's3://'} <= set(FileSystem._schemes)\n"
            "bad = [k for k in sys.modules\n"
            "       if k == 'dmlc_tpu_torch.io.objstore.http_client'\n"
            "       or k.split('.')[0] in ('jax', 'dmlc_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# The files that may import pyarrow: the Parquet golden (guarded) and the
# bench suite's corpus writers of configs 5 and 17.
PYARROW_FILES = ("dmlc_tpu_torch/data/parquet_parser.py",
                 "dmlc_tpu_torch/bench_suite.py")


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_only_the_parquet_golden_imports_pyarrow(path):
    """The card's machine has no pyarrow: chip_smoke.py and every module
    but the golden and the bench suite's Parquet writers never import
    it."""
    if "pyarrow" in set(_imported_roots(path)):
        assert os.path.relpath(path, REPO) in PYARROW_FILES


def test_the_port_works_without_pyarrow(tmp_path):
    """With pyarrow blocked (``sys.modules["pyarrow"] = None``), ``import
    dmlc_tpu_torch`` and every submodule import; the csv, parquet_native
    (engine="native", over chip_smoke.write_parquet's file) and indexed
    RecordIO paths parse; ``format="parquet"`` raises the reference's
    DMLCError naming pyarrow, and so does parquet_native's fallback."""
    code = f"""
import pkgutil, sys
sys.modules["pyarrow"] = None
sys.modules["pyarrow.parquet"] = None
import numpy as np
import dmlc_tpu_torch
for m in pkgutil.walk_packages(dmlc_tpu_torch.__path__, "dmlc_tpu_torch."):
    __import__(m.name)
import chip_smoke
from dmlc_tpu_torch import bench_suite
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.native.bindings import NativeIndexedRecordIOReader
from dmlc_tpu_torch.utils.logging import DMLCError
d = {str(tmp_path)!r}
csv = d + "/h.csv"
chip_smoke.write_higgs_csv(csv, 1, 3, 0.3)
rows = sum(b.size for b in Parser.create(csv, format="csv",
                                         engine="native", label_column=0))
assert rows == (1 << 20) // chip_smoke.CSV_ROW_BYTES, rows
pq = d + "/t.parquet"
cols = chip_smoke.higgs_table(1, 5)
chip_smoke.write_parquet(pq, cols, 1000)
p = Parser.create(pq, format="parquet_native", engine="native",
                  label_column="label")
got = np.concatenate([b.label.copy() for b in p])
assert np.array_equal(got, cols["label"])
p.destroy()
rec = d + "/i.rec"
bench_suite.make_indexed_recordio(rec, 1)
a = list(NativeIndexedRecordIOReader(rec, 0, 1, shuffle=True, seed=11,
                                     batch_size=4).records())
split = InputSplit.create(rec, 0, 1, "indexed_recordio", shuffle=True,
                          seed=11, batch_size=4)
b = list(iter(split.next_record, None))
assert a == b and len(a) > 4
for fmt, engine in (("parquet", "auto"), ("parquet_native", "python")):
    try:
        Parser.create(pq, format=fmt, engine=engine, label_column="label")
    except DMLCError as e:
        assert "requires pyarrow" in str(e), e
    else:
        raise SystemExit("format=%r engine=%r did not raise" % (fmt, engine))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "dmlc_tpu", "pyarrow")
             and sys.modules[k] is not None)
print(bad)
sys.exit(1 if bad else 0)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_cuda():
    assert not torch.cuda.is_available()  # the CPU test host
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def test_chip_smoke_refuses_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it fails and prints no result."""
    with open(os.path.join(REPO, "chip_smoke.py"), "rb") as f:
        (tmp_path / "chip_smoke.py").write_bytes(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kernel_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", "/nonexistent/bin/nvcc")
    with pytest.raises(DMLCError, match="nvcc"):
        build.build_kernels()


def test_kernel_wrappers_refuse_other_devices():
    """Tensors on a device that is neither the CPU nor a CUDA card never
    reach the plain versions: the wrappers raise."""
    meta = torch.device("meta")
    off = torch.zeros(3, dtype=torch.int64, device=meta)
    idx = torch.zeros(4, dtype=torch.uint32, device=meta)
    val = torch.zeros(4, device=meta)
    with pytest.raises(DMLCError):
        csr.csr_spmv(off, idx, val, torch.zeros(8, device=meta))
    with pytest.raises(DMLCError):
        csr.csr_spmv_t(off, idx, val, torch.zeros(2, device=meta), 8)


def test_wrappers_check_dtypes_and_devices():
    off = torch.tensor([0, 2], dtype=torch.int64)
    idx = torch.tensor([0, 1], dtype=torch.uint32)
    val = torch.ones(2)
    w = torch.ones(4)
    with pytest.raises(DMLCError, match="offset"):
        csr.csr_spmv(off.to(torch.int32), idx, val, w)
    with pytest.raises(DMLCError, match="index dtype"):
        csr.csr_spmv(off, idx.to(torch.float32), val, w)
    with pytest.raises(DMLCError, match="float32"):
        csr.csr_spmv(off, idx, val.double(), w)
    with pytest.raises(DMLCError, match="one entry per row"):
        csr.csr_spmv_t(off, idx, val, torch.ones(3), 4)


def test_cpu_calls_do_not_count_as_launches():
    before = (csr.csr_spmv.launches, csr.csr_spmv_t.launches)
    off = torch.tensor([0, 2], dtype=torch.int64)
    idx = torch.from_numpy(np.array([0, 3], np.uint32))
    csr.csr_spmv(off, idx, torch.ones(2), torch.ones(4))
    csr.csr_spmv_t(off, idx, torch.ones(2), torch.ones(1), 4)
    assert (csr.csr_spmv.launches, csr.csr_spmv_t.launches) == before


def test_every_kernel_source_is_built_and_every_entry_declared():
    """The kernel library is built from every source under csrc/, and each
    C entry point has a ctypes declaration with as many arguments as the
    source gives it (no card is needed to catch a drift between the two)."""
    import glob
    import re
    from dmlc_tpu_torch.ops.kernels import _SIGNATURES
    csrc = os.path.join(PKG, "csrc")
    assert sorted(build.KERNEL_SRCS) == sorted(
        glob.glob(os.path.join(csrc, "*.cu")))
    assert sorted(build.KERNEL_HEADERS) == sorted(
        glob.glob(os.path.join(csrc, "*.cuh")))
    entries = {}
    for src in build.KERNEL_SRCS:
        with open(src, encoding="utf-8") as f:
            text = f.read()
        for name, params in re.findall(r"^int (dmlc_\w+)\(([^)]*)\)", text,
                                       flags=re.M):
            entries[name] = len(params.split(","))
    assert sorted(entries) == sorted(_SIGNATURES)
    for name, count in entries.items():
        assert len(_SIGNATURES[name]) == count, name
