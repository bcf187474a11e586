"""ONE fingerprint-stamped on-disk page store for every cache tier.

Copy of ``dmlc_tpu/io/pagestore.py`` with its imports rewritten to
``dmlc_tpu_torch``. The port's on-disk cache layers — DiskRowIter's
binary row pages and RoundSpillWriter's round pages (data/row_iter.py),
hydrated ``obj://`` blocks (io/objstore/fs.py) and remote checkpoints'
content-addressed pages (io/checkpoint.py) — route their bytes through
:class:`PageStore`:

- **one commit protocol** — writes land in a tmp file and are published
  by an atomic ``os.replace`` under a resilience ``guarded()`` site
  (``pagestore.commit`` by default; the spill and page-cache writers
  name their own), so a crashed or aborted build never masquerades as a
  complete cache;
- **one staleness stamp** — every committed entry carries a sidecar
  ``<entry>.meta.json`` recording the SOURCE fingerprint
  (``[[path, size, mtime_ns], ...]``, scheme-aware: remote ``obj://``
  sources stat through the FileSystem seam), and :meth:`PageStore.sweep`
  is the one sweep that removes entries whose sources changed, dead
  writers' files, and orphaned tmps/sidecars;
- **one byte budget** — committed bytes are accounted per store root and
  LRU-evicted (by entry mtime, bumped on every read) when a budget is
  set (``DMLC_TPU_TORCH_PAGESTORE_BUDGET``, :meth:`PageStore.set_budget`,
  ``Pipeline.cache(page_budget_bytes=)``),
  skipping entries pinned by this process or owned by live writers;
- **one telemetry surface** — ``pagestore.hit`` / ``pagestore.miss`` /
  ``pagestore.evict`` counters of the obs metrics registry.

The remote I/O plane (``dmlc_tpu_torch.io.objstore``) hydrates
ranged-GET blocks into :meth:`PageStore.default`, which is what makes a
second epoch over an ``obj://`` URI wire-free: the blocks steady replay
wants are already local pages.

The default root and its two variables differ from the reference's (see
:func:`default_store_dir`): both packages name spill files by the same
rule, so one shared root would let one package's ``close()`` delete the
other's pages.
"""

from __future__ import annotations

import json
import os
import re
import stat as _stat_mod
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from dmlc_tpu_torch.io.stream import Stream, create_stream
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = [
    "PageStore", "PageWriter", "default_store_dir",
    "stat_uri", "stat_fingerprint", "fingerprint_fresh",
    "ENV_BUDGET", "ENV_STORE_DIR", "META_SUFFIX",
]

ENV_BUDGET = "DMLC_TPU_TORCH_PAGESTORE_BUDGET"
ENV_STORE_DIR = "DMLC_TPU_TORCH_PAGESTORE_DIR"
META_SUFFIX = ".meta.json"

_TMP_RE = re.compile(r"\.tmp(?:\.(\d+))?$")
# round-spill entries embed their writer pid in the NAME
# (rounds-<key>-p<pid>-<seq>.pages) — a dead owner's file can never be
# adopted and is reclaimed by sweep/eviction
_NAME_PID_RE = re.compile(r"-p(\d+)-\d+\.pages(\.tmp)?$")


def default_store_dir() -> str:
    """The port's default root: spill pages, derived caches, and
    hydrated remote blocks land here unless a caller names a directory
    — one dir, one sweep, one budget.
    ``DMLC_TPU_TORCH_PAGESTORE_DIR`` overrides it (read per
    call, so a gang worker sharing a host with its peers can give each
    rank its own store); else ``<tempdir>/dmlc_tpu_torch_spill``. Both
    differ from the reference's (``DMLC_TPU_PAGESTORE_DIR``,
    ``<tempdir>/dmlc_tpu_spill``) on purpose: the packages derive the
    same spill-file names, and one shared root would let one package's
    ``close()`` delete the other's pages."""
    env = os.environ.get(ENV_STORE_DIR)
    if env:
        return env
    return os.path.join(tempfile.gettempdir(), "dmlc_tpu_torch_spill")


def _pid_dead(pid: int) -> bool:
    """Liveness probe for a writer pid recorded on THIS host (store
    roots are host-local). Pid reuse can keep a dead file one sweep
    longer — bounded, accepted. The ONE liveness rule for every
    page/cache cleanup site."""
    if pid == os.getpid():
        return False
    try:
        os.kill(pid, 0)
        return False
    except ProcessLookupError:
        return True
    except OSError:
        return False  # alive but not ours (EPERM) — keep


def _name_pid(name: str) -> Optional[int]:
    m = _NAME_PID_RE.search(name)
    return int(m.group(1)) if m else None


def _name_owner_dead(name: str) -> Optional[bool]:
    """Liveness of a pid embedded in an entry name: True = dead,
    False = alive (or us), None = no pid in the name."""
    pid = _name_pid(name)
    return None if pid is None else _pid_dead(pid)


# ------------------------------------------------------- scheme-aware stat

def stat_uri(uri: str) -> Tuple[int, int, int, int]:
    """(size, mtime_ns, ctime_ns, inode) for a possibly scheme-bearing
    path — THE stat rule for fingerprints. Local, ``file://`` and
    ``cuda://`` paths use os.stat (full richness); other registered
    schemes stat through their FileSystem (``get_path_info``), reporting
    0 for the fields object stores do not have. Raises OSError for
    missing local files, FileNotFoundError/DMLCError from remote
    backends (DMLCError also for an unknown scheme or a stub one)."""
    from dmlc_tpu_torch.io.cuda_fs import local_path
    from dmlc_tpu_torch.io.filesys import URI, FileSystem
    u = URI(local_path(uri))
    if u.protocol == "file://":
        st = os.stat(u.name)
        return (st.st_size, st.st_mtime_ns, st.st_ctime_ns, st.st_ino)
    info = FileSystem.get_instance(u).get_path_info(u)
    return (info.size, info.mtime_ns, 0, 0)


def stat_fingerprint(paths) -> List[List[Any]]:
    """``[[path, size, mtime_ns], ...]`` — the sidecar stamp shape
    shared by every cache layer (and understood by :meth:`sweep`)."""
    out = []
    for p in paths:
        size, mtime_ns, _, _ = stat_uri(p)
        out.append([p, size, mtime_ns])
    return out


def fingerprint_fresh(fp) -> Optional[bool]:
    """Re-stat a recorded fingerprint: True = sources unchanged,
    False = changed/missing (stale), None = unknowable (e.g. the
    recording scheme has no backend configured in THIS process — never
    judge stale what we cannot stat)."""
    if not fp:
        return None
    for entry in fp:
        fpath, size, mtime_ns = entry[0], entry[1], entry[2]
        try:
            now_size, now_mtime, _, _ = stat_uri(fpath)
        except (OSError, ValueError):
            return False  # gone / unstatable locally: stale
        except DMLCError:
            return None  # scheme unconfigured here: unknowable
        if now_size != size or now_mtime != mtime_ns:
            return False
    return True


# ------------------------------------------------------------ page writer

# ---------------------------------------------------------------- metrics

def _count(which: str, n: int = 1) -> None:
    try:
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter(f"pagestore.{which}").inc(n)
    except Exception:  # noqa: BLE001 — telemetry must not break caching
        pass


class PageWriter:
    """An in-flight page-store entry: write to ``.stream``, then
    :meth:`commit` (atomic publish + sidecar stamp + budget accounting)
    or :meth:`abort` (nothing left behind)."""

    def __init__(self, store: "PageStore", name: str,
                 fingerprint=None, meta: Optional[dict] = None,
                 commit_site: str = "pagestore.commit",
                 tmp_suffix: Optional[str] = None):
        self._store = store
        self.name = name
        self._site = commit_site
        self.path = store.path(name)
        self._fingerprint = fingerprint
        self._meta = dict(meta or {})
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        if tmp_suffix is None:
            tmp_suffix = f".tmp.{os.getpid()}"
            # reap dead predecessors' orphaned tmps for this entry:
            # each racing writer writes its own pid-named tmp, the
            # replaces are atomic, last complete build wins
            import glob
            for orphan in glob.glob(glob.escape(self.path) + ".tmp.*"):
                m = _TMP_RE.search(orphan)
                if m and m.group(1) and _pid_dead(int(m.group(1))):
                    try:
                        os.remove(orphan)
                    except OSError:
                        pass
        self.tmp = self.path + tmp_suffix
        self._s: Optional[Stream] = create_stream(self.tmp, "w")

    @property
    def stream(self) -> Stream:
        check(self._s is not None, "PageWriter already closed")
        return self._s

    def write(self, data) -> int:
        return self.stream.write(data)

    def commit(self) -> str:
        """Close, publish atomically under the commit site's retry
        policy, stamp the sidecar, account the bytes (evicting LRU
        entries if the store is over budget). Returns the entry path."""
        from dmlc_tpu_torch.resilience.policy import guarded
        check(self._s is not None, "PageWriter already closed")
        self._s.close()
        self._s = None
        # the atomic publish rename is idempotent, so transient errors
        # (and injected chaos) retry under policy instead of abandoning
        # the freshly built pages
        guarded(self._site, lambda: os.replace(self.tmp, self.path))
        meta = dict(self._meta)
        meta["fingerprint"] = self._fingerprint
        try:
            meta["bytes"] = os.path.getsize(self.path)
            self._store._note_committed(meta["bytes"])
        except OSError:
            pass
        self._store._stamp_entry(self.name, meta)
        self._store.evict_to_budget()
        return self.path

    def abort(self) -> None:
        if self._s is not None:
            try:
                self._s.close()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
            self._s = None
        try:
            os.remove(self.tmp)
        except OSError:
            pass


# -------------------------------------------------------------- the store

class PageStore:
    """A directory of atomically-committed, fingerprint-stamped page
    files with byte-budget LRU accounting. One instance per root
    (:meth:`at` caches them); :meth:`default` is the shared store every
    derived cache and hydrated remote block uses."""

    _by_root: Dict[str, "PageStore"] = {}
    _cls_lock = threading.Lock()
    # process-global pins, REFCOUNTED per path: two iterators serving
    # the same derived cache each pin it, and the survivor's pin holds
    # after the first one's __del__ unpins. Eviction and sweep skip
    # pinned entries; cross-process protection comes from LRU recency
    # + the pid-liveness rule.
    _pinned: Dict[str, int] = {}

    def __init__(self, root: str, byte_budget: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.byte_budget = byte_budget
        self._lock = threading.Lock()
        # committed-bytes running total: None = unknown (rescan). Keeps
        # the per-commit budget check O(1) — a full listdir+stat scan
        # per commit is O(N^2) over many entries. Another process's writes are invisible to the
        # cache until our next full scan; host-local heuristic,
        # accepted (eviction is delayed, never unsafe).
        self._used_cache: Optional[int] = None

    # -- construction

    @classmethod
    def at(cls, root: str,
           byte_budget: Optional[int] = None) -> "PageStore":
        key = os.path.abspath(root)
        with cls._cls_lock:
            store = cls._by_root.get(key)
            if store is None:
                store = cls(key, byte_budget)
                cls._by_root[key] = store
            elif byte_budget is not None:
                store.byte_budget = byte_budget
        return store

    @classmethod
    def default(cls) -> "PageStore":
        store = cls.at(default_store_dir())
        if store.byte_budget is None:
            env = os.environ.get(ENV_BUDGET)
            if env:
                try:
                    store.byte_budget = int(env)
                except ValueError:
                    pass
        return store

    @classmethod
    def for_path(cls, path: str) -> Tuple["PageStore", str]:
        """(store rooted at the path's directory, entry name) — how
        explicit cache paths (DiskRowIter, round spills) join the
        unified store without moving their files."""
        path = os.path.abspath(path)
        return cls.at(os.path.dirname(path)), os.path.basename(path)

    @classmethod
    def known_roots(cls) -> List[str]:
        with cls._cls_lock:
            return list(cls._by_root)

    # -- paths / stamps

    def path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def stamp(self, name: str) -> Optional[dict]:
        """The committed sidecar meta, or None (no sidecar = a legacy
        or header-stamped entry; its staleness is judged elsewhere)."""
        try:
            with open(self.path(name) + META_SUFFIX) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _stamp_entry(self, name: str, meta: dict) -> None:
        tmp = self.path(name) + META_SUFFIX + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, self.path(name) + META_SUFFIX)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass

    # -- write / read

    def writer(self, name: str, fingerprint=None,
               meta: Optional[dict] = None,
               commit_site: str = "pagestore.commit",
               tmp_suffix: Optional[str] = None) -> PageWriter:
        return PageWriter(self, name, fingerprint=fingerprint, meta=meta,
                          commit_site=commit_site, tmp_suffix=tmp_suffix)

    def commit_bytes(self, name: str, data: bytes, fingerprint=None,
                     meta: Optional[dict] = None) -> str:
        """One-shot write-and-commit of a fully materialized payload
        (the content-addressed checkpoint pages' shape:
        ``fingerprint=None`` entries are immortal to the stale sweep).
        Returns the entry path; aborts cleanly on failure."""
        w = self.writer(name, fingerprint=fingerprint, meta=meta)
        try:
            w.write(data)
        except Exception:
            w.abort()
            raise
        return w.commit()

    def lookup(self, name: str, fingerprint=None) -> Optional[str]:
        """Entry path when present and fresh, else None. Counts ONE
        hit or miss. With a ``fingerprint``, a committed stamp that
        does not match it marks the entry stale: it is deleted and the
        lookup is a miss (the caller re-earns the cache)."""
        p = self.path(name)
        if not os.path.exists(p):
            _count("miss")
            return None
        if fingerprint is not None:
            meta = self.stamp(name)
            if meta is not None and meta.get("fingerprint") is not None \
                    and meta["fingerprint"] != [list(e)
                                                for e in fingerprint]:
                self.delete(name)
                _count("miss")
                return None
        _count("hit")
        self.touch(name)
        return p

    def open_read(self, name: str) -> Optional[Stream]:
        """Seekable stream over a present entry (counts a hit and
        bumps its LRU clock), or None (counts a miss)."""
        p = self.path(name)
        try:
            s = create_stream(p, "r")
        except FileNotFoundError:
            _count("miss")
            return None
        _count("hit")
        self.touch(name)
        return s

    def touch(self, name: str) -> None:
        try:
            os.utime(self.path(name))
        except OSError:
            pass

    def delete(self, name: str) -> bool:
        """Remove an entry and its sidecar; True when the entry file
        existed. Drops every pin on the entry (a deleted path has
        nothing left to protect)."""
        p = self.path(name)
        with self._cls_lock:
            PageStore._pinned.pop(p, None)
        size = None
        try:
            size = os.path.getsize(p)
            os.remove(p)
            existed = True
        except OSError:
            existed = False
        if existed and size is not None and self._used_cache is not None:
            self._used_cache = max(0, self._used_cache - size)
        try:
            os.remove(p + META_SUFFIX)
        except OSError:
            pass
        return existed

    def _note_committed(self, nbytes: int) -> None:
        if self._used_cache is not None:
            self._used_cache += nbytes

    # -- pinning

    def pin(self, name: str) -> None:
        p = self.path(name)
        with self._cls_lock:
            PageStore._pinned[p] = PageStore._pinned.get(p, 0) + 1

    def unpin(self, name: str) -> None:
        p = self.path(name)
        with self._cls_lock:
            n = PageStore._pinned.get(p, 0) - 1
            if n > 0:
                PageStore._pinned[p] = n
            else:
                PageStore._pinned.pop(p, None)

    def _is_pinned(self, path: str) -> bool:
        with self._cls_lock:
            return PageStore._pinned.get(path, 0) > 0

    # -- accounting / eviction

    def _entries(self) -> List[Tuple[str, str, int, float]]:
        """Accountable entries: committed files the store recognizes —
        ``.pages`` suffix or a sidecar stamp. Alien files are never
        touched. Returns (name, path, size, mtime)."""
        try:
            names = set(os.listdir(self.root))
        except OSError:
            self._used_cache = 0  # no root yet: nothing committed
            return []
        out = []
        for name in sorted(names):
            if name.endswith(META_SUFFIX) or _TMP_RE.search(name):
                continue
            if not (name.endswith(".pages")
                    or name + META_SUFFIX in names):
                continue
            path = os.path.join(self.root, name)
            try:
                st = os.stat(path)
            except OSError:
                st = None  # vanished during listing: skip, not retry
            if st is None or not _stat_mod.S_ISREG(st.st_mode):
                continue
            out.append((name, path, st.st_size, st.st_mtime))
        self._used_cache = sum(size for _, _, size, _ in out)
        return out

    def used_bytes(self) -> int:
        return sum(size for _, _, size, _ in self._entries())

    def set_budget(self, byte_budget: Optional[int]) -> int:
        """Set (or clear) the store's byte budget and evict down to it.
        Returns entries evicted."""
        self.byte_budget = byte_budget
        return self.evict_to_budget()

    def evict_to_budget(self) -> int:
        """LRU-evict committed entries until used bytes fit the budget.
        Pinned entries and entries whose name embeds a LIVE writer pid
        are skipped — eviction reclaims cold caches, it does not pull
        pages out from under a serving iterator. The under-budget path
        is O(1) via the running committed-bytes total; only a
        possibly-over-budget store pays the full scan."""
        if self.byte_budget is None:
            return 0
        if self._used_cache is not None \
                and self._used_cache <= self.byte_budget:
            return 0
        with self._lock:
            entries = self._entries()
            used = sum(size for _, _, size, _ in entries)
            if used <= self.byte_budget:
                return 0
            evicted = 0
            # oldest mtime first — touch() on every read keeps live
            # entries at the warm end
            for name, path, size, _ in sorted(entries,
                                              key=lambda e: e[3]):
                if used <= self.byte_budget:
                    break
                if self._is_pinned(path):
                    continue
                if _name_owner_dead(name) is False:
                    continue  # a LIVE writer's spill file
                if self.delete(name):
                    used -= size
                    evicted += 1
                    _count("evict")
            return evicted

    # -- the one sweep

    def sweep(self, max_tmp_age_s: float = 600.0,
              header_meta: Optional[Callable[[str],
                                             Optional[dict]]] = None) -> int:
        """Remove stale-fingerprint entries, dead writers' files, and
        orphaned tmps/sidecars. Returns ENTRIES removed (an entry and
        its sidecar count once). ``header_meta(path)`` lets callers
        supply meta for entries that carry their stamp in a file header
        instead of a sidecar (the round-spill format)."""
        d = self.root
        if not os.path.isdir(d):
            return 0
        removed = 0
        now = time.time()
        names = set(os.listdir(d))
        for name in sorted(names):
            path = os.path.join(d, name)
            tmp_m = _TMP_RE.search(name)
            if tmp_m:
                # a live writer's tmp is NEVER deleted, however slow
                # the epoch; dead-owner tmps go now, anonymous ones by
                # age only
                if tmp_m.group(1):
                    dead = _pid_dead(int(tmp_m.group(1)))
                else:
                    dead = _name_owner_dead(name)
                try:
                    if dead or (dead is None
                                and now - os.path.getmtime(path)
                                > max_tmp_age_s):
                        os.remove(path)
                        removed += 1
                except OSError:
                    pass
                continue
            if name.endswith(META_SUFFIX):
                # sidecar without its entry (failed/crashed build):
                # nothing will ever pair with it — sweep it directly
                if name[:-len(META_SUFFIX)] not in names:
                    try:
                        os.remove(path)
                        removed += 1
                    except OSError:
                        pass
                continue
            if not (name.endswith(".pages")
                    or name + META_SUFFIX in names):
                continue  # never delete what we do not recognize
            if self._is_pinned(path):
                # a live iterator in THIS process is serving the entry:
                # even a stale-stamped one is skipped (the iterator's
                # own mutation detectors own that case); it is swept
                # once unpinned
                continue
            if _name_owner_dead(name):
                if self.delete(name):  # entry + sidecar, counted once
                    removed += 1
                continue
            meta = self.stamp(name)
            if meta is None and header_meta is not None:
                meta = header_meta(path)
            if meta is None:
                continue  # unknowable: never delete what we can't read
            fresh = fingerprint_fresh(meta.get("fingerprint"))
            if fresh is False:
                if self.delete(name):
                    removed += 1
        return removed
