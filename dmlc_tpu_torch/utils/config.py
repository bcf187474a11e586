"""Legacy ``key = val`` config-file parser.

Copy of ``dmlc_tpu/utils/config.py`` with its imports rewritten to
``dmlc_tpu_torch``.

Reference: include/dmlc/config.h + src/config.cc — Config, ConfigIterator;
multi-value keys supported (the same key may appear multiple times and all
occurrences are preserved, in order). Values may be quoted with double quotes
(quotes stripped; ``\\"`` and ``\\\\`` unescaped); ``#`` begins a comment
outside quotes.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from dmlc_tpu_torch.utils.logging import DMLCError

__all__ = ["Config"]


def _strip_comment(line: str) -> str:
    out = []
    in_quote = False
    i = 0
    while i < len(line):
        c = line[i]
        if c == '"':
            in_quote = not in_quote
        elif c == "\\" and in_quote and i + 1 < len(line):
            out.append(c)
            i += 1
            out.append(line[i])
            i += 1
            continue
        elif c == "#" and not in_quote:
            break
        out.append(c)
        i += 1
    return "".join(out)


def _unquote(val: str) -> str:
    val = val.strip()
    if len(val) >= 2 and val[0] == '"' and val[-1] == '"':
        body = val[1:-1]
        return body.replace('\\"', '"').replace("\\\\", "\\")
    return val


class Config:
    """Ordered multi-map parsed from ``key = val`` text (reference: dmlc::Config)."""

    def __init__(self, text: str = "", multi_value: bool = True):
        self._order: List[Tuple[str, str]] = []
        self._multi_value = multi_value
        if text:
            self.load_string(text)

    @classmethod
    def from_file(cls, path: str, multi_value: bool = True) -> "Config":
        with open(path, "r", encoding="utf-8") as f:
            return cls(f.read(), multi_value=multi_value)

    def load_string(self, text: str) -> None:
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = _strip_comment(raw).strip()
            if not line:
                continue
            if "=" not in line:
                raise DMLCError(
                    f"Config: line {lineno} has no '=': {raw!r}")
            key, _, val = line.partition("=")
            key = key.strip()
            if not key:
                raise DMLCError(f"Config: line {lineno} has empty key: {raw!r}")
            self.set_param(key, _unquote(val))

    def set_param(self, key: str, value: str) -> None:
        if not self._multi_value:
            self._order = [(k, v) for k, v in self._order if k != key]
        self._order.append((key, str(value)))

    def get_param(self, key: str) -> str:
        """Last value for key (raises if absent)."""
        for k, v in reversed(self._order):
            if k == key:
                return v
        raise DMLCError(f"Config: key {key!r} not found")

    def get_all(self, key: str) -> List[str]:
        return [v for k, v in self._order if k == key]

    def __contains__(self, key: str) -> bool:
        return any(k == key for k, _ in self._order)

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        """Iterate (key, value) in file order (reference: ConfigIterator)."""
        return iter(self._order)

    def to_dict(self) -> Dict[str, str]:
        """Last-wins flat dict."""
        return dict(self._order)

    def proto_string(self) -> str:
        """Render back to config-file text."""
        def q(v: str) -> str:
            if any(c in v for c in ' \t#"') or v == "":
                return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
            return v
        return "\n".join(f"{k} = {q(v)}" for k, v in self._order)
