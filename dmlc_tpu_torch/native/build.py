"""Build the port's compiled code: ``python -m dmlc_tpu_torch.native.build``.

Two shared libraries, both built from this package's own sources into
``dmlc_tpu_torch/build/`` (gitignored), at first use:

- the native parse engine, ``native/src/engine.cc`` (a verbatim copy of
  the reference package's engine), with the same g++ command the
  reference uses;
- the CUDA kernels, ``csrc/*.cu``, with nvcc for Hopper (``sm_90a``)
  into a library with a plain C interface, loaded with ctypes: one nvcc
  for each source, all started together, then one link.

Each output name carries a hash of its source and its command, so an
edited source builds anew instead of loading a stale library. A build
holds a file lock and publishes its output by an atomic rename, so
concurrent processes (parallel test workers) build once and never load
a half-written file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Callable, List

from dmlc_tpu_torch.utils.logging import DMLCError

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
BUILD_DIR = os.path.join(PKG, "build")
ENGINE_SRC = os.path.join(HERE, "src", "engine.cc")
KERNEL_SRCS = [os.path.join(PKG, "csrc", name)
               for name in ("csr_spmv.cu", "fm.cu", "csr_ops.cu",
                            "ranking.cu", "step.cu", "pages.cu")]
KERNEL_HEADERS = [os.path.join(PKG, "csrc", name)
                  for name in ("device.cuh", "index.cuh")]
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_ZLIB_FLAGS = None


def zlib_flags() -> List[str]:
    """``["-lz"]`` when the toolchain can compile AND link against zlib
    (the engine's Parquet GZIP page decode), else ``["-DDTP_NO_ZLIB"]``
    — the engine builds either way. Decided by a trial compile+link;
    cached per process."""
    global _ZLIB_FLAGS
    if _ZLIB_FLAGS is not None:
        return list(_ZLIB_FLAGS)
    with tempfile.TemporaryDirectory(prefix="dtp_zlib_probe_") as d:
        src = os.path.join(d, "probe.cc")
        with open(src, "w") as f:
            f.write("#include <zlib.h>\n"
                    "int main() { return zlibVersion() == nullptr; }\n")
        try:
            ok = subprocess.run(
                ["g++", "-std=c++17", src, "-o",
                 os.path.join(d, "probe"), "-lz"],
                capture_output=True, timeout=60).returncode == 0
        except (OSError, subprocess.SubprocessError):
            ok = False
    _ZLIB_FLAGS = ["-lz"] if ok else ["-DDTP_NO_ZLIB"]
    return list(_ZLIB_FLAGS)


def _stamp(srcs: List[str], cmd: List[str]) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _locked_build(out: str, compile_to: Callable[[str], None]) -> str:
    """Run ``compile_to(tmp_path)`` once across processes and publish
    the result at ``out`` by an atomic rename."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.tmp{os.getpid()}"
        try:
            compile_to(tmp)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _run(cmd: List[str], what: str, log_path: str) -> None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
    except (OSError, subprocess.SubprocessError) as e:
        raise DMLCError(f"{what} build failed to run: {e}") from e
    with open(log_path, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise DMLCError(f"{what} build failed (rc {proc.returncode}): "
                        f"{(proc.stdout + proc.stderr).strip()[-4000:]}")


def engine_path() -> str:
    """Where the engine library for the current source lives."""
    cmd = _engine_cmd("OUT")
    return os.path.join(BUILD_DIR,
                        f"libdmlc_tpu.{_stamp([ENGINE_SRC], cmd)}.so")


def _engine_cmd(out: str) -> List[str]:
    return ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", "-Wall", "-Wextra", ENGINE_SRC, "-o", out
            ] + zlib_flags()


def build() -> str:
    """Build (or find) the native engine; returns the library path."""
    out = engine_path()

    def compile_to(tmp: str) -> None:
        _run(_engine_cmd(tmp), "native engine", out + ".log")
        _check_abi(tmp)

    return _locked_build(out, compile_to)


def _check_abi(path: str) -> None:
    """Fail the build when the compiled engine does not speak the ABI
    the bindings expect. The probe runs in a subprocess so that a
    library already mapped in this process cannot answer for it."""
    from dmlc_tpu_torch.native.bindings import ABI_VERSION
    out = subprocess.run(
        [sys.executable, "-c",
         "import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
         "lib.dtp_version.restype = ctypes.c_int; "
         "print(lib.dtp_version())", path],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise DMLCError(
            f"built {path} failed the ABI probe: {out.stderr.strip()}")
    got = int(out.stdout.strip())
    if got != ABI_VERSION:
        raise DMLCError(
            f"built {path} speaks ABI {got}, bindings expect "
            f"{ABI_VERSION} — src/engine.cc and bindings.py are out of "
            "sync (bump dtp_version()/ABI_VERSION together)")


def nvcc() -> str:
    """The CUDA compiler, or a DMLCError: kernels build only where the
    CUDA toolkit is installed."""
    found = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(found):
        raise DMLCError("nvcc not found: the CUDA kernels of "
                        "dmlc_tpu_torch need the CUDA toolkit")
    return found


_KERNEL_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def kernels_path() -> str:
    return os.path.join(
        BUILD_DIR, "libdmlc_kernels."
        f"{_stamp(KERNEL_SRCS + KERNEL_HEADERS, _KERNEL_FLAGS)}.so")


def _compile_kernels(out: str, log_path: str) -> None:
    """nvcc each source to an object, all at once, then link them into
    the library ``out``; every command's output goes to ``log_path``."""
    cc = nvcc()
    objs = [f"{out}.{i}.o" for i in range(len(KERNEL_SRCS))]
    cmds = [[cc] + _KERNEL_FLAGS + ["-c", src, "-o", obj]
            for src, obj in zip(KERNEL_SRCS, objs)]
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        outputs = [p.communicate(timeout=900)[0] for p in procs]
        with open(log_path, "w") as f:
            for cmd, text in zip(cmds, outputs):
                f.write(" ".join(cmd) + "\n" + text)
        for cmd, proc, text in zip(cmds, procs, outputs):
            if proc.returncode != 0:
                raise DMLCError(f"CUDA kernel build failed (rc "
                                f"{proc.returncode}): {' '.join(cmd)}\n"
                                f"{text.strip()[-4000:]}")
        _run([cc, "-shared", "-o", out] + objs, "CUDA kernel link",
             log_path + ".link")
    except (OSError, subprocess.SubprocessError) as e:
        raise DMLCError(f"CUDA kernel build failed to run: {e}") from e
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)


def build_kernels() -> str:
    """Build (or find) the CUDA kernel library; returns its path. The
    compiler's register/shared-memory report lands beside it in
    ``<lib>.log``."""
    out = kernels_path()
    return _locked_build(out, lambda tmp: _compile_kernels(tmp, out + ".log"))


if __name__ == "__main__":
    print(f"built {build()}")
    if "--kernels" in sys.argv:
        print(f"built {build_kernels()}")
    sys.exit(0)
