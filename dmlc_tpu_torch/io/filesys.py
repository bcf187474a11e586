"""Virtual filesystem registry with URI-scheme dispatch.

Reference: src/io/filesys.{h,cc} — FileSystem::GetInstance(URI),
Open/OpenForRead/GetPathInfo/ListDirectory, URI{protocol,host,name},
FileInfo{path,size,type}; src/io/local_filesys.{h,cc}.

``file://`` (and bare paths) is registered here; ``cuda://``
(io/cuda_fs.py) and ``obj://`` with its ``s3://`` alias
(io/objstore) register themselves when ``dmlc_tpu_torch`` is imported.
Cloud backends (HDFS, Azure, GCS; reference src/io/{hdfs,azure}_filesys.cc)
are a plugin seam, as in the reference: ``s3://``, ``hdfs://``,
``azure://`` and ``gs://`` are pre-registered with stub factories that
raise a DMLCError telling the user how to register a real implementation
(``FileSystem.register_scheme``); the object-store plane registers over
the ``s3://`` stub. A local stat and a directory listing are the
reference's resilience seams (``io.filesys.stat``, ``io.filesys.list``).
"""

from __future__ import annotations

import os
import stat as _stat
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from dmlc_tpu_torch.resilience.policy import guarded
from dmlc_tpu_torch.utils.logging import DMLCError, check
from dmlc_tpu_torch.io.stream import FileStream, SeekStream, Stream

__all__ = ["URI", "FileInfo", "FileSystem", "LocalFileSystem"]


class URI:
    """Parsed resource locator (reference: io::URI{protocol, host, name}).

    ``s3://bucket/key`` → protocol "s3://", host "bucket", name "/key".
    A bare path has protocol "file://".
    """

    __slots__ = ("protocol", "host", "name")

    def __init__(self, uri: str):
        if "://" not in uri:
            self.protocol = "file://"
            self.host = ""
            self.name = uri
        else:
            proto, _, rest = uri.partition("://")
            self.protocol = proto + "://"
            if self.protocol == "file://":
                self.host = ""
                self.name = rest
            else:
                host, slash, path = rest.partition("/")
                self.host = host
                self.name = slash + path
        check(self.name != "" or self.host != "", f"invalid URI {uri!r}")

    def str_uri(self) -> str:
        if self.protocol == "file://":
            return self.name
        return f"{self.protocol}{self.host}{self.name}"

    def __repr__(self) -> str:
        return f"URI({self.str_uri()!r})"


@dataclass
class FileInfo:
    """Reference: FileInfo{path, size, type}. ``mtime_ns`` extends the
    reference shape so fingerprint stamps (io/pagestore.py) can stat
    any registered scheme through one seam; backends without a
    modification clock report 0."""
    path: str
    size: int
    type: str  # "file" | "directory"
    mtime_ns: int = 0


class FileSystem:
    """Abstract VFS + scheme registry (reference: dmlc::io::FileSystem)."""

    _schemes: Dict[str, Callable[[], "FileSystem"]] = {}
    _instances: Dict[str, "FileSystem"] = {}

    # -- registry

    @classmethod
    def register_scheme(cls, protocol: str,
                        factory: Callable[[], "FileSystem"]) -> None:
        """Register a filesystem factory for a protocol like "s3://"."""
        check(protocol.endswith("://"), f"protocol must end with ://: {protocol!r}")
        cls._schemes[protocol] = factory
        cls._instances.pop(protocol, None)

    @classmethod
    def get_instance(cls, uri: URI,
                     allow_null: bool = False) -> Optional["FileSystem"]:
        """Reference: FileSystem::GetInstance — protocol → singleton."""
        inst = cls._instances.get(uri.protocol)
        if inst is not None:
            return inst
        factory = cls._schemes.get(uri.protocol)
        if factory is None:
            if allow_null:
                return None
            raise DMLCError(
                f"unknown filesystem protocol {uri.protocol!r}; registered: "
                f"{sorted(cls._schemes)}")
        inst = factory()
        cls._instances[uri.protocol] = inst
        return inst

    # -- interface

    def open(self, uri: URI, mode: str) -> Stream:
        raise NotImplementedError

    def open_for_read(self, uri: URI) -> SeekStream:
        raise NotImplementedError

    def get_path_info(self, uri: URI) -> FileInfo:
        raise NotImplementedError

    def list_directory(self, uri: URI) -> List[FileInfo]:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    """Local files (reference: src/io/local_filesys.cc)."""

    def open(self, uri: URI, mode: str) -> FileStream:
        check(mode in ("r", "w", "a"), f"invalid mode {mode!r}")
        return FileStream(open(uri.name, mode + "b"), path=uri.name)

    def open_for_read(self, uri: URI) -> FileStream:
        return FileStream(open(uri.name, "rb"), path=uri.name)

    def get_path_info(self, uri: URI) -> FileInfo:
        # resilience seam io.filesys.stat (retry policy + fault plan)
        st = guarded("io.filesys.stat", lambda: os.stat(uri.name))
        ftype = "directory" if _stat.S_ISDIR(st.st_mode) else "file"
        return FileInfo(path=uri.name, size=st.st_size, type=ftype,
                        mtime_ns=st.st_mtime_ns)

    def list_directory(self, uri: URI) -> List[FileInfo]:
        def scan() -> List[FileInfo]:
            out = []
            for name in sorted(os.listdir(uri.name)):
                full = os.path.join(uri.name, name)
                st = os.stat(full)
                ftype = ("directory" if _stat.S_ISDIR(st.st_mode)
                         else "file")
                out.append(FileInfo(path=full, size=st.st_size,
                                    type=ftype, mtime_ns=st.st_mtime_ns))
            return out
        return guarded("io.filesys.list", scan)


class _StubFileSystem(FileSystem):
    """Pre-registered cloud scheme with no backend in this build (the
    reference's s3/hdfs/azure filesystems need libcurl or libhdfs); a
    real implementation plugs in via ``FileSystem.register_scheme``."""

    def __init__(self, protocol: str, hint: str):
        self.protocol = protocol
        self.hint = hint

    def _fail(self):
        raise DMLCError(
            f"filesystem {self.protocol!r} has no backend in this build "
            f"({self.hint}). Register one with FileSystem.register_scheme"
            f"({self.protocol!r}, factory).")

    def open(self, uri, mode):
        self._fail()

    def open_for_read(self, uri):
        self._fail()

    def get_path_info(self, uri):
        self._fail()

    def list_directory(self, uri):
        self._fail()


FileSystem.register_scheme("file://", LocalFileSystem)
for _proto, _hint in (
        ("s3://", "reference: src/io/s3_filesys.cc, needs HTTP+HMAC"),
        ("hdfs://", "reference: src/io/hdfs_filesys.cc, needs libhdfs"),
        ("azure://", "reference: src/io/azure_filesys.cc"),
        ("gs://", "GCS plugin seam (no reference counterpart)")):
    FileSystem.register_scheme(
        _proto, (lambda p=_proto, h=_hint: _StubFileSystem(p, h)))
