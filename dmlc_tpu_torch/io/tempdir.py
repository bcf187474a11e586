"""RAII temporary directory (reference: include/dmlc/filesystem.h —
dmlc::TemporaryDirectory, mkdtemp + recursive delete).

Copy of ``dmlc_tpu/io/tempdir.py``; its directories are prefixed
``dmlc_tpu_torch.``."""

from __future__ import annotations

import os
import shutil
import tempfile

__all__ = ["TemporaryDirectory"]


class TemporaryDirectory:
    """Create on construction, recursively delete on close/del/context-exit.

    >>> with TemporaryDirectory() as td:
    ...     open(os.path.join(td.path, "x"), "w").close()
    """

    def __init__(self, prefix: str = "dmlc_tpu_torch.", verbose: bool = False):
        self.path = tempfile.mkdtemp(prefix=prefix)
        self._verbose = verbose

    def __enter__(self) -> "TemporaryDirectory":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self.path and os.path.isdir(self.path):
            if self._verbose:
                from dmlc_tpu_torch.utils.logging import log_info
                log_info(f"deleting temporary directory {self.path}")
            shutil.rmtree(self.path, ignore_errors=True)
        self.path = ""

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
