"""User-URI decomposition: scheme + path + cache hint + kwargs.

Reference: src/io/uri_spec.h — io::URISpec{uri, cache_file, args}.

Convention (same as the reference / XGBoost data URIs):
``scheme://host/path?k1=v1&k2=v2#cachefile`` — '#' introduces a local
cache-file hint (reference: CachedInputSplit), '?' introduces parser
kwargs such as ``format=csv``. ';' in the path separates multiple input
paths, each keeping its own scheme.

Scheme handling: the ``scheme://`` prefix is split off BEFORE the
'?'/'#' decomposition, so a remote URI like
``obj://bucket/key?format=csv#cache`` round-trips with its protocol
intact (``str_spec()`` reconstructs the raw form).
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["URISpec"]


class URISpec:
    __slots__ = ("uri", "cache_file", "args")

    def __init__(self, raw: str):
        # split the scheme off first: '?'/'#' decomposition applies to
        # the scheme-less remainder only (a pathological '?'/'#' inside
        # a scheme name must not shift the parse)
        scheme = ""
        rest = raw
        if "://" in raw:
            proto, _, tail = raw.partition("://")
            if "?" not in proto and "#" not in proto:
                scheme = proto + "://"
                rest = tail
        path, hash_, cache = rest.partition("#")
        self.cache_file: str = cache if hash_ else ""
        path, q, argstr = path.partition("?")
        self.uri: str = scheme + path
        self.args: Dict[str, str] = {}
        if q:
            for kv in argstr.split("&"):
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                self.args[k] = v

    @property
    def scheme(self) -> str:
        """Protocol of the (first) path, "file://" when bare."""
        first = self.uri.split(";", 1)[0]
        if "://" in first:
            return first.partition("://")[0] + "://"
        return "file://"

    def paths(self) -> List[str]:
        """';'-separated multi-path expansion; every path keeps the
        scheme it was written with."""
        return [p for p in self.uri.split(";") if p]

    def str_spec(self) -> str:
        """Reconstruct the raw user URI (protocol, ?args and #cache
        intact)."""
        out = self.uri
        if self.args:
            out += "?" + "&".join(f"{k}={v}" for k, v in self.args.items())
        if self.cache_file:
            out += "#" + self.cache_file
        return out

    def __repr__(self) -> str:
        return (f"URISpec(uri={self.uri!r}, cache_file={self.cache_file!r}, "
                f"args={self.args!r})")
