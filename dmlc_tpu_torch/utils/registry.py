"""Global string-keyed factory registries.

Reference: include/dmlc/registry.h — Registry<EntryType>::Get/Register/Find/
ListAllNames, FunctionRegEntryBase (set_body/describe/add_argument),
DMLC_REGISTRY_ENABLE / DMLC_REGISTRY_REGISTER.

The reference's file/link-tag machinery (DMLC_REGISTRY_FILE_TAG) exists to
defeat static-library dead-stripping — meaningless in Python, so it is not
reproduced. Registration is eager at import time, same net effect.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field as _dc_field
from typing import Any, Callable, Dict, List, Optional

from dmlc_tpu_torch.utils.logging import DMLCError

__all__ = ["Registry", "RegistryEntry"]


@dataclass
class RegistryEntry:
    """One registered factory (reference: FunctionRegEntryBase).

    ``body`` is the factory callable; ``arguments`` documents kwargs the
    factory understands (reference: add_argument).
    """
    name: str
    body: Optional[Callable[..., Any]] = None
    description: str = ""
    arguments: List[Dict[str, str]] = _dc_field(default_factory=list)
    return_type: str = ""

    def set_body(self, body: Callable[..., Any]) -> "RegistryEntry":
        self.body = body
        return self

    def describe(self, description: str) -> "RegistryEntry":
        self.description = description
        return self

    def add_argument(self, name: str, type_str: str, description: str) -> "RegistryEntry":
        self.arguments.append(
            {"name": name, "type": type_str, "description": description})
        return self


class Registry:
    """A named global registry of :class:`RegistryEntry`.

    ``Registry.get("Parser")`` returns the singleton registry named "Parser"
    (reference: Registry<ParserFactoryReg>::Get()). Entries are registered via
    :meth:`register` (decorator-friendly) and looked up via :meth:`find`.
    """

    _registries: Dict[str, "Registry"] = {}
    _lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, RegistryEntry] = {}
        self._entry_lock = threading.Lock()

    @classmethod
    def get(cls, name: str) -> "Registry":
        with cls._lock:
            reg = cls._registries.get(name)
            if reg is None:
                reg = cls._registries[name] = Registry(name)
            return reg

    @classmethod
    def list_registries(cls) -> List[str]:
        with cls._lock:
            return sorted(cls._registries)

    def register(self, name: str, body: Optional[Callable[..., Any]] = None,
                 description: str = "", allow_override: bool = False):
        """Register a factory. Usable directly or as a decorator:

        >>> reg = Registry.get("Parser")
        >>> @reg.register("libsvm")
        ... def make_libsvm(**kw): ...
        """
        with self._entry_lock:
            if name in self._entries and not allow_override:
                raise DMLCError(
                    f"{self.name}: entry {name!r} already registered")
            entry = RegistryEntry(name=name, description=description)
            self._entries[name] = entry
        if body is not None:
            entry.set_body(body)
            return entry

        def _decorator(fn: Callable[..., Any]):
            entry.set_body(fn)
            return fn
        return _decorator

    def find(self, name: str) -> Optional[RegistryEntry]:
        with self._entry_lock:
            return self._entries.get(name)

    def lookup(self, name: str) -> RegistryEntry:
        """find() that raises with the available names on miss."""
        entry = self.find(name)
        if entry is None or entry.body is None:
            raise DMLCError(
                f"{self.name}: unknown entry {name!r}; "
                f"available: {self.list_all_names()}")
        return entry

    def remove(self, name: str) -> None:
        with self._entry_lock:
            self._entries.pop(name, None)

    def list_all_names(self) -> List[str]:
        with self._entry_lock:
            return sorted(self._entries)
