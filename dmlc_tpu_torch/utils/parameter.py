"""Declarative typed parameter schema.

Reference: include/dmlc/parameter.h — Parameter<PType> (CRTP),
DMLC_DECLARE_FIELD (set_default/set_range/set_lower_bound/add_enum/describe),
Init/InitAllowUnknown/UpdateAllowUnknown/GetDict/__DOC__, dmlc::GetEnv<T>.

Ergonomics reproduced Python-idiomatically: fields are declared as class
attributes via :func:`field`; values arrive as strings (kwargs from CLI/config
files) or typed Python values; validation covers type parse, range, enum,
required-missing; ``__DOC__`` generation mirrors the reference's generated
docstrings. The reference's ``dmlc::optional<T>`` "None" spelling is kept:
a field with ``optional=True`` parses the literal string "None" to ``None``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type, Union

from dmlc_tpu_torch.utils.logging import DMLCError

__all__ = ["Parameter", "field", "get_env", "ParamError", "FieldEntry"]


class ParamError(DMLCError):
    """Raised on parameter validation failure (reference: dmlc::ParamError)."""


_BOOL_TRUE = {"1", "true", "True", "TRUE", "yes"}
_BOOL_FALSE = {"0", "false", "False", "FALSE", "no"}


def _parse_bool(s: str) -> bool:
    if s in _BOOL_TRUE:
        return True
    if s in _BOOL_FALSE:
        return False
    raise ValueError(f"cannot parse {s!r} as bool")


def _parse_value(dtype: Type, s: Any) -> Any:
    """Parse a raw (usually string) value to dtype, reference FieldEntry<T>::Set."""
    if isinstance(s, str):
        if dtype is str:
            return s  # verbatim — a "\t" delimiter must survive
        s = s.strip()
        if dtype is bool:
            return _parse_bool(s)
        if dtype is int:
            return int(s, 0)  # accepts 0x.. like C strtol(,,0)
        if dtype is float:
            return float(s)  # exact strtod semantics — the parity golden
        return dtype(s)
    # already typed
    if dtype is bool:
        if isinstance(s, bool):
            return s
        raise ValueError(f"cannot use {s!r} as bool")
    if dtype is int and isinstance(s, bool):
        raise ValueError(f"cannot use bool {s!r} as int")
    if dtype is float and isinstance(s, (int, float)) and not isinstance(s, bool):
        return float(s)
    if isinstance(s, dtype):
        return s
    raise ValueError(f"cannot use {s!r} as {dtype.__name__}")


class FieldEntry:
    """Schema for one declared field (reference: FieldEntry<T>)."""

    __slots__ = ("name", "dtype", "default", "has_default", "lower", "upper",
                 "enum", "desc", "optional")

    def __init__(self, dtype: Optional[Type] = None, default: Any = None,
                 *, has_default: bool = False,
                 lower: Optional[float] = None, upper: Optional[float] = None,
                 enum: Optional[Sequence[Any]] = None, desc: str = "",
                 optional: bool = False):
        self.name = ""  # filled by ParameterMeta
        self.dtype = dtype
        self.default = default
        self.has_default = has_default
        self.lower = lower
        self.upper = upper
        self.enum = list(enum) if enum is not None else None
        self.desc = desc
        self.optional = optional

    def check(self, value: Any) -> Any:
        """Parse + validate one value; raises ParamError with field context."""
        if value is None or (isinstance(value, str) and value == "None"):
            if self.optional:
                return None
            raise ParamError(
                f"field {self.name!r}: value None not allowed "
                f"(declare optional=True for dmlc::optional semantics)")
        try:
            v = _parse_value(self.dtype, value)
        except (ValueError, TypeError) as e:
            raise ParamError(
                f"field {self.name!r}: {e}\n{self.doc_line()}") from None
        if self.lower is not None and v < self.lower:
            raise ParamError(
                f"field {self.name!r}: value {v!r} below lower bound "
                f"{self.lower!r}\n{self.doc_line()}")
        if self.upper is not None and v > self.upper:
            raise ParamError(
                f"field {self.name!r}: value {v!r} above upper bound "
                f"{self.upper!r}\n{self.doc_line()}")
        if self.enum is not None and v not in self.enum:
            raise ParamError(
                f"field {self.name!r}: value {v!r} not in allowed set "
                f"{self.enum!r}\n{self.doc_line()}")
        return v

    def doc_line(self) -> str:
        """One generated doc line (reference: generated __DOC__ per field)."""
        constraints = []
        if self.enum is not None:
            constraints.append(f"choices={self.enum!r}")
        if self.lower is not None:
            constraints.append(f">={self.lower!r}")
        if self.upper is not None:
            constraints.append(f"<={self.upper!r}")
        if self.has_default:
            constraints.append(f"default={self.default!r}")
        else:
            constraints.append("required")
        tname = self.dtype.__name__ if self.dtype else "any"
        if self.optional:
            tname = f"optional[{tname}]"
        head = f"{self.name} : {tname}, {', '.join(constraints)}"
        return head + (f"\n    {self.desc}" if self.desc else "")


_REQUIRED = object()


def field(default: Any = _REQUIRED, *, dtype: Optional[Type] = None,
          lower: Optional[float] = None, upper: Optional[float] = None,
          enum: Optional[Sequence[Any]] = None, desc: str = "",
          optional: bool = False) -> FieldEntry:
    """Declare a parameter field (reference: DMLC_DECLARE_FIELD chain).

    dtype is inferred from the default when omitted. Omitting the default
    makes the field required (reference: missing-field check in Init).
    """
    has_default = default is not _REQUIRED
    if dtype is None:
        if not has_default or default is None:
            raise ParamError("field(): dtype required when no typed default")
        dtype = type(default)
    if has_default and default is not None:
        default = _parse_value(dtype, default)
    return FieldEntry(dtype=dtype, default=(None if not has_default else default),
                      has_default=has_default, lower=lower, upper=upper,
                      enum=enum, desc=desc, optional=optional)


class ParameterMeta(type):
    """Collects FieldEntry declarations into ``__fields__`` (reference: ParamManager)."""

    def __new__(mcls, name, bases, ns):
        fields: Dict[str, FieldEntry] = {}
        for base in bases:
            fields.update(getattr(base, "__fields__", {}))
        for key, val in list(ns.items()):
            if isinstance(val, FieldEntry):
                val.name = key
                fields[key] = val
                del ns[key]
        ns["__fields__"] = fields
        cls = super().__new__(mcls, name, bases, ns)
        if fields:
            doc_lines = [f"Parameters for {name}", "-" * max(1, len(name) + 15)]
            doc_lines += [f.doc_line() for f in fields.values()]
            cls.__DOC__ = "\n".join(doc_lines)
        else:
            cls.__DOC__ = ""
        return cls


class Parameter(metaclass=ParameterMeta):
    """Base for declarative parameter structs (reference: Parameter<PType>).

    >>> class MyParam(Parameter):
    ...     num_hidden = field(100, lower=1, desc="hidden units")
    ...     act = field("relu", enum=["relu", "tanh"])
    >>> p = MyParam(num_hidden="200")        # kwargs init, strings parsed
    >>> p.num_hidden
    200
    """

    __fields__: Dict[str, FieldEntry] = {}

    def __init__(self, **kwargs: Any):
        for name, fe in self.__fields__.items():
            object.__setattr__(self, name, fe.default if fe.has_default else None)
        if kwargs:
            self.init(kwargs)

    # -- init family (reference: Init / InitAllowUnknown / UpdateAllowUnknown)

    def init(self, kwargs: Union[Dict[str, Any], Sequence[Tuple[str, Any]]]) -> None:
        """Set fields from kwargs; unknown key raises (reference Init)."""
        unknown = self._run_init(kwargs)
        if unknown:
            raise ParamError(
                f"{type(self).__name__}: unknown parameter(s) "
                f"{sorted(unknown)}; known: {sorted(self.__fields__)}")
        self._check_missing()

    def init_allow_unknown(self, kwargs) -> Dict[str, Any]:
        """Like init() but returns unknown kwargs (reference InitAllowUnknown)."""
        unknown = self._run_init(kwargs)
        self._check_missing()
        return unknown

    def update_allow_unknown(self, kwargs) -> Dict[str, Any]:
        """Update without re-checking missing fields (reference UpdateAllowUnknown)."""
        return self._run_init(kwargs)

    def update_dict(self, kwargs: Dict[str, Any]) -> None:
        """init() then remove consumed keys from kwargs (reference UpdateDict)."""
        unknown = self._run_init(dict(kwargs))
        self._check_missing()
        for k in list(kwargs):
            if k not in unknown:
                del kwargs[k]

    def _run_init(self, kwargs) -> Dict[str, Any]:
        items = kwargs.items() if isinstance(kwargs, dict) else kwargs
        unknown: Dict[str, Any] = {}
        for k, v in items:
            fe = self.__fields__.get(k)
            if fe is None:
                unknown[k] = v
            else:
                object.__setattr__(self, k, fe.check(v))
        return unknown

    def _check_missing(self) -> None:
        missing = [n for n, fe in self.__fields__.items()
                   if not fe.has_default and getattr(self, n) is None
                   and not fe.optional]
        if missing:
            raise ParamError(
                f"{type(self).__name__}: required parameter(s) not set: "
                f"{missing}\n{type(self).__DOC__}")

    def __setattr__(self, name: str, value: Any) -> None:
        fe = self.__fields__.get(name)
        if fe is not None:
            value = fe.check(value)
        object.__setattr__(self, name, value)

    # -- introspection (reference: GetDict / __DOC__)

    def get_dict(self) -> Dict[str, str]:
        """All fields as strings (reference GetDict; optional None → "None")."""
        out = {}
        for name in self.__fields__:
            v = getattr(self, name)
            out[name] = "None" if v is None else str(v)
        return out

    def as_dict(self) -> Dict[str, Any]:
        """All fields as typed values."""
        return {name: getattr(self, name) for name in self.__fields__}

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self.as_dict().items())
        return f"{type(self).__name__}({inner})"

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and self.as_dict() == other.as_dict()


def get_env(name: str, dtype: Type, default: Any = _REQUIRED) -> Any:
    """Typed environment variable reader (reference: dmlc::GetEnv<T>)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        if default is _REQUIRED:
            raise ParamError(f"environment variable {name} not set")
        return default
    try:
        return _parse_value(dtype, raw)
    except (ValueError, TypeError) as e:
        raise ParamError(f"environment variable {name}={raw!r}: {e}") from None
