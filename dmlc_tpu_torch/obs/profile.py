"""Continuous sampling profiler: merged Python+native flamegraphs.

Copy of ``dmlc_tpu/obs/profile.py`` with its imports rewritten to
``dmlc_tpu_torch``; the native leaves come from the port's engine, a
verbatim copy of the reference's.

The rest of the plane stops at STAGE granularity: ``/analyze``
can say an epoch is parse-bound, the stage probes can say where the
waits sat — but nothing in the system can say which FUNCTION inside
parse is hot. This module is that last rung: an always-on-capable
wall-clock sampler on the same install/env/budget contracts as
:mod:`dmlc_tpu_torch.obs.timeseries`.

A stdlib-only daemon thread walks :func:`sys._current_frames` at
``DMLC_TPU_PROFILE_HZ`` (set per worker by
``launch_local(profile_hz=...)``) and folds every thread's stack into
a :class:`FrameTrie` — a weighted prefix tree under a fixed byte
budget that COARSENS when full instead of truncating (the
TimeSeriesRing discipline): the lightest leaves fold their weight into
their parent's ``[coarsened]`` aggregate, so total sample weight is
conserved while the coldest call paths lose resolution first. The
sampler itself runs under a DUTY-CYCLE guard: its thread-CPU cost is
measured over 32-tick windows, and when walking the process would
exceed ``MAX_DUTY`` (~1.7% of wall — hundreds of threads, deep
stacks) the period stretches instead of the pipeline paying —
always-on means "<2% overhead", not "hz at any price". Threads
are labeled with their live :mod:`threading` names — the same
vocabulary ``TraceRecorder.name_thread`` puts on the Perfetto
timeline — and wait-shaped leaf frames (lock/queue/sleep/select) are
classified so on-CPU and off-CPU time separate under a synthetic
``[off-cpu]`` leaf.

The native half: the engine's reader/parse/assemble workers are NOT
Python threads — ``sys._current_frames`` is blind to them, which is
exactly where a fused epoch spends its time. Each engine worker keeps
a seqlock-stamped phase beacon (``{phase, shard}``; engine.cc, read
via the ``dtp_prof_*`` ctypes surface next to the busy-ns counters),
and the SAME sampler tick folds those beacons in as native leaves
(``native:parse``, ``native:reader_wait``, ``native:gang_assemble``)
under their established track names (``native/reader``,
``native/worker-N``, ``native/consumer``) — one flamegraph spanning
the GIL boundary.

Read it everywhere the plane already lives: ``GET /profile`` on the
status server (``?seconds=N&hz=M`` for an on-demand burst),
``python -m dmlc_tpu_torch.obsctl profile``, collapsed-stack /
speedscope exports in :mod:`dmlc_tpu_torch.obs.export`, a forced burst in
watchdog stall reports and flight crash bundles (``profile.txt``), and
the top folded frames
of the bound stage as ``hot_frames`` evidence in the ``/analyze``
verdict.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["FrameTrie", "StackProfiler", "active", "install",
           "uninstall", "install_if_env", "classify_wait", "hot_frames",
           "dump_collapsed", "ENV_PROFILE_HZ", "ENV_PROFILE_BYTES",
           "PROFILE_SCHEMA", "WAIT_FRAME", "FOLDED_FRAME",
           "DEFAULT_HZ", "DEFAULT_BUDGET_BYTES"]

# bump when to_dict()'s top-level shape changes incompatibly
PROFILE_SCHEMA = 1

ENV_PROFILE_HZ = "DMLC_TPU_PROFILE_HZ"        # sample rate (enables)
ENV_PROFILE_BYTES = "DMLC_TPU_PROFILE_BYTES"  # trie byte budget

DEFAULT_HZ = 67.0             # off-round: avoids lockstep with 10/100 Hz
DEFAULT_BUDGET_BYTES = 512 << 10
MAX_STACK_DEPTH = 64

# synthetic frames (never real code): the off-CPU leaf a wait-shaped
# sample lands under, the render-time leaf a node's coarsened
# (folded-away) descendants aggregate into, and the shared root that
# cold thread roots collapse into when the budget demands it
WAIT_FRAME = "[off-cpu]"
FOLDED_FRAME = "[coarsened]"
OTHER_THREADS = "[other-threads]"

# anonymous churny thread names collapse to one label: every
# ThreadingHTTPServer request handler is a fresh "Thread-N", and a
# long-profiled worker scraping /metrics would otherwise mint a new
# trie ROOT per connection — roots named by a counter carry no
# identity worth a node each
_ANON_THREAD_RE = re.compile(
    r"^(Thread|Dummy)-\d+( \(.*\))?$|"
    r"^(ThreadPoolExecutor-\d+)_\d+$")


def _normalize_label(name: str) -> str:
    m = _ANON_THREAD_RE.match(name)
    if m is None:
        return name
    return (m.group(3) + "_*") if m.group(3) else (m.group(1) + "-*")

# wait-shaped leaf sites: a thread whose INNERMOST Python frame is one
# of these is blocked, not computing. Keyed by stdlib file basename
# (time.sleep and lock.acquire are C — the blocked thread's innermost
# PYTHON frame is the stdlib wrapper, threading.py:wait etc.), plus a
# small generic set for wrappers named after what they do. A
# heuristic, and an explicitly conservative one: misclassifying a hot
# frame as a wait hides real CPU, the reverse only inflates on-CPU.
_WAIT_FILE_FUNCS = {
    "threading.py": {"wait", "acquire", "join",
                     "_wait_for_tstate_lock"},
    "queue.py": {"get", "put", "join"},
    "selectors.py": {"select", "_select", "poll"},
    "socket.py": {"accept", "recv", "recv_into", "recvfrom",
                  "sendall", "connect", "readinto"},
    "socketserver.py": {"serve_forever", "get_request",
                        "handle_request"},
    "subprocess.py": {"wait", "_wait", "_try_wait", "communicate"},
    "connection.py": {"poll", "recv", "accept", "_recv"},
    "ssl.py": {"read", "recv", "do_handshake"},
    "popen_fork.py": {"poll", "wait"},
}
# bare-name waits are kept MINIMAL: a function literally named wait/
# sleep/acquire is wait-shaped by overwhelming convention, but names
# like poll()/select()/get() are common for CPU-hot user code — those
# classify only at their file-keyed stdlib sites above (misclassifying
# a hot frame as a wait hides real CPU, the harmful direction)
_WAIT_ANY_FUNCS = {"wait", "acquire", "sleep"}

# native beacon decode (engine.cc ProfPhase/ProfKind, read through
# bindings.prof_read): phase -> (leaf frame, is_wait)
_NATIVE_PHASES = {
    1: ("native:read", False),
    2: ("native:reader_wait", True),
    3: ("native:parse", False),
    4: ("native:worker_wait", True),
    5: ("native:assemble", False),
    6: ("native:gang_assemble", False),
}


def classify_wait(file_base: str, func: str) -> bool:
    """True when a (file basename, function) leaf is wait-shaped."""
    return (func in _WAIT_FILE_FUNCS.get(file_base, ())
            or func in _WAIT_ANY_FUNCS)


class _Node:
    __slots__ = ("name", "children", "self_n", "folded_n")

    def __init__(self, name: str):
        self.name = name
        self.children: Dict[str, "_Node"] = {}
        self.self_n = 0
        self.folded_n = 0


def _node_bytes(name: str) -> int:
    # stable estimate (dict slot + node + key text): the budget check
    # and the tests use the same arithmetic, like timeseries
    return 48 + len(name)


class FrameTrie:
    """Weighted prefix tree of sampled stacks under a byte budget.

    ``add(label, frames, wait)`` folds one root-first stack in under
    the thread-label root. When the estimated node bytes exceed the
    budget the trie COARSENS: leaves whose subtree weight is below the
    current fold threshold merge their weight into their parent's
    ``folded_n`` aggregate (rendered as a ``[coarsened]`` leaf) and
    the threshold doubles when a pass frees nothing — total weight is
    conserved, the coldest/deepest paths lose resolution first, and a
    10-second burst and a 2-hour soak both fit the same budget."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES):
        self.budget_bytes = max(16 << 10, int(budget_bytes))
        self.roots: Dict[str, _Node] = {}
        self.samples = 0
        self.wait_samples = 0
        self.coarsenings = 0
        self._bytes = 0
        self._min_fold = 2  # leaves below this weight fold first
        self._lock = threading.Lock()

    def add(self, label: str, frames: Iterable[str],
            wait: bool = False) -> None:
        with self._lock:
            self.samples += 1
            if wait:
                self.wait_samples += 1
            node = self.roots.get(label)
            if node is None:
                node = _Node(label)
                self.roots[label] = node
                self._bytes += _node_bytes(label)
            for name in frames:
                child = node.children.get(name)
                if child is None:
                    child = _Node(name)
                    node.children[name] = child
                    self._bytes += _node_bytes(name)
                node = child
            node.self_n += 1
            if self._bytes > self.budget_bytes:
                self._coarsen_locked()

    def _fold_pass(self, node: _Node, thresh: int) -> int:
        removed = 0
        for name, child in list(node.children.items()):
            removed += self._fold_pass(child, thresh)
            if not child.children and \
                    child.self_n + child.folded_n < thresh:
                node.folded_n += child.self_n + child.folded_n
                del node.children[name]
                self._bytes -= _node_bytes(name)
                removed += 1
        return removed

    def _coarsen_locked(self) -> None:
        # caller holds the lock. Passes continue until under budget;
        # a pass that frees nothing doubles the threshold (the stride
        # analogue), so termination is guaranteed: at worst only the
        # root labels remain, carrying everything as folded weight.
        while self._bytes > self.budget_bytes:
            removed = 0
            for root in self.roots.values():
                removed += self._fold_pass(root, self._min_fold)
            # roots are nodes too: a fully-folded, cold thread root
            # (label churn the normalizer didn't anticipate) collapses
            # into the shared [other-threads] sink — without this,
            # distinct labels alone could pin the trie over budget
            # forever, and then EVERY add would re-coarsen
            sink = self.roots.get(OTHER_THREADS)
            for label, root in list(self.roots.items()):
                if root is sink or root.children:
                    continue
                if root.self_n + root.folded_n < self._min_fold:
                    if sink is None:
                        sink = _Node(OTHER_THREADS)
                        self.roots[OTHER_THREADS] = sink
                        self._bytes += _node_bytes(OTHER_THREADS)
                    sink.folded_n += root.self_n + root.folded_n
                    del self.roots[label]
                    self._bytes -= _node_bytes(label)
                    removed += 1
            self.coarsenings += 1
            if removed == 0:
                self._min_fold *= 2
                if self._min_fold > max(2, self.samples) * 2:
                    break  # nothing foldable is left below the roots

    def approx_bytes(self) -> int:
        with self._lock:
            return self._bytes

    @staticmethod
    def _node_dict(node: _Node) -> Dict[str, Any]:
        return {
            "name": node.name,
            "self": node.self_n,
            "folded": node.folded_n,
            "children": sorted(
                (FrameTrie._node_dict(c)
                 for c in node.children.values()),
                key=lambda d: -(d["self"] + d["folded"])),
        }

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "samples": self.samples,
                "wait_samples": self.wait_samples,
                "budget_bytes": self.budget_bytes,
                "approx_bytes": self._bytes,
                "coarsenings": self.coarsenings,
                "min_fold": self._min_fold,
                "threads": {label: self._node_dict(root)
                            for label, root in self.roots.items()},
            }


# (name, is_wait) per code object, built once: the sampler walks the
# same code objects every tick, and the f-string + basename + wait
# classification per frame dominated tick cost. Keyed by the code
# object itself (not id() — ids recycle after GC; holding the code
# reference is bounded by the program's distinct-function count).
_code_cache: Dict[Any, Tuple[str, bool]] = {}


def _code_info(code) -> Tuple[str, bool]:
    info = _code_cache.get(code)
    if info is None:
        # bounded: a process minting code objects forever (exec/eval,
        # JIT re-tracing) must not grow the cache — and the keys keep
        # their code objects alive — so a full cache resets and
        # rebuilds from the currently-live frames
        if len(_code_cache) >= 16384:
            _code_cache.clear()
        base = os.path.basename(code.co_filename)
        info = (f"{base}:{code.co_name}",
                classify_wait(base, code.co_name))
        _code_cache[code] = info
    return info


def _walk_stack(frame, max_depth: int) -> Tuple[List[str], bool]:
    """Root-first frame names + wait classification of the leaf."""
    wait = _code_info(frame.f_code)[1]
    names: List[str] = []
    f = frame
    depth = 0
    while f is not None and depth < max_depth:
        names.append(_code_info(f.f_code)[0])
        f = f.f_back
        depth += 1
    if f is not None:
        names.append("[truncated]")  # deeper ancestry coarsened away
    names.reverse()
    return names, wait


def _native_beacons() -> List[Tuple[int, int, int, int]]:
    """[(kind, index, phase, shard)] from the engine's phase beacons —
    only when the engine library is ALREADY loaded (profiling must
    never trigger a native build/load, the obs.trace rule)."""
    try:
        from dmlc_tpu_torch.native import bindings
        if bindings._lib is None:
            return []
        return bindings.prof_read()
    except Exception:  # noqa: BLE001 — telemetry must never raise
        return []


def _native_label(kind: int, index: int, shard: int) -> str:
    if kind == 1:
        base = "native/reader"
    elif kind == 3:
        base = "native/consumer"
    else:
        base = f"native/worker-{index}"
    return f"{base}@shard{shard}" if shard >= 0 else base


# threads currently doing PROFILER work (a /profile burst running on
# a handler thread): excluded from every tick — a 5-second burst must
# not rank profile.py:burst as the process's hottest frame
_internal_idents: Set[int] = set()

# last measured per-tick cost, carried ACROSS profiler instances: a
# fresh sampler in this same process (install/uninstall cycles, the
# flight recorder, tests) faces the same thread population, and
# starting cold would run its whole first duty window unguarded —
# measured at ~20% of a pipeline epoch on a loaded box
_tick_cost_prior_s = 0.0


class StackProfiler:
    """The continuous sampler: one daemon thread, one FrameTrie.

    ``start()``/``stop()`` run the sampler at ``hz``;
    ``sample_now()`` takes one immediate tick (rate-limited to the
    sampler period unless ``force=True`` — crash/stall dump paths
    force so the black box carries the dying state);
    ``burst(seconds, hz)`` captures synchronously into a FRESH trie
    (the ``/profile?seconds=N`` path) while the continuous trie keeps
    accumulating; ``to_dict()`` is the ``/profile`` payload."""

    # a tick must never cost more than this fraction of wall time:
    # the sampler SLOWS DOWN instead of taxing the pipeline when a
    # tick is expensive (hundreds of threads, deep stacks) — the
    # always-on contract is "<2% overhead", not "hz at any price",
    # the same discipline as the trie byte budget
    MAX_DUTY = 0.017

    def __init__(self, hz: float = DEFAULT_HZ,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 max_depth: int = MAX_STACK_DEPTH):
        self.hz = min(1000.0, max(0.1, float(hz)))
        self.period_s = 1.0 / self.hz
        self.max_depth = int(max_depth)
        self.trie = FrameTrie(budget_bytes)
        self.started_s = time.time()
        self._last_tick = 0.0
        # windowed avg CPU cost of one tick, seeded from the process
        # prior so the guard engages from tick 1 of a fresh instance
        self._tick_cost_s = _tick_cost_prior_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one tick

    def _exclude(self) -> Set[int]:
        out = set(_internal_idents)
        if self._thread is not None and self._thread.ident:
            out.add(self._thread.ident)
        return out

    def _tick_into(self, trie: FrameTrie,
                   exclude: Set[int]) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        try:
            for ident, frame in frames.items():
                if ident in exclude:
                    continue
                stack, wait = _walk_stack(frame, self.max_depth)
                if wait:
                    stack.append(WAIT_FRAME)
                label = _normalize_label(
                    names.get(ident, "thread-?"))
                trie.add(label, stack, wait=wait)
        finally:
            del frames  # the map pins every thread's locals alive
        for kind, index, phase, shard in _native_beacons():
            leaf = _NATIVE_PHASES.get(phase)
            if leaf is None:
                continue  # idle slot (phase 0) or unknown: no time bin
            trie.add(_native_label(kind, index, shard), [leaf[0]],
                     wait=leaf[1])

    def sample_now(self, force: bool = False) -> bool:
        """One immediate sampling tick into the continuous trie.
        Non-forced calls are rate-limited to half the sampler period
        (a chatty caller must not silently multiply the sample rate);
        ``force=True`` bypasses the period — dump paths use it."""
        now = time.perf_counter()
        if not force and now - self._last_tick < 0.5 * self.period_s:
            return False
        self._last_tick = now
        try:
            self._tick_into(self.trie, self._exclude())
        except Exception:  # noqa: BLE001 — telemetry must never raise
            return False
        return True

    # -- the sampler thread

    def start(self) -> "StackProfiler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="dmlc_tpu_torch.obs.StackProfiler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def effective_period_s(self) -> float:
        """The sampler's actual period: the configured one, stretched
        when the measured per-tick cost would push the duty cycle past
        MAX_DUTY (the wait itself releases the GIL — only tick time
        taxes the pipeline)."""
        return max(self.period_s, self._tick_cost_s / self.MAX_DUTY)

    # ticks per duty-measurement window (see _run)
    _DUTY_WINDOW = 32

    def _run(self) -> None:
        # Duty accounting: the sampler thread's OWN CPU time, averaged
        # over a window of ticks. Per-tick wall time reads scheduling
        # delay as sampler cost and throttles to near-zero exactly on
        # the loaded boxes profiles matter most; per-tick CPU time is
        # blind on hosts that account CLOCK_THREAD_CPUTIME_ID in 10 ms
        # quanta (this gVisor-class box) — a quantum landing inside a
        # 150 us tick poisons the estimate and a 2 ms tick usually
        # reads 0. Aggregated over 32 ticks the quanta average out:
        # preemption excluded, quantization bounded to ~0.3 ms/tick.
        global _tick_cost_prior_s
        ticks = 0
        # first window is SHORT (8 ticks): a cold sampler on an
        # expensive process must engage the guard within ~100 ms, not
        # after half a second of unguarded walking
        window = max(1, self._DUTY_WINDOW // 4)
        cpu0 = time.thread_time()
        while not self._stop.wait(self.effective_period_s()):
            self.sample_now(force=True)
            ticks += 1
            if ticks >= window:
                cpu1 = time.thread_time()
                self._tick_cost_s = max(0.0, (cpu1 - cpu0) / ticks)
                _tick_cost_prior_s = self._tick_cost_s
                cpu0 = cpu1
                ticks = 0
                window = self._DUTY_WINDOW

    # -- reads

    def _doc(self, trie: FrameTrie, hz: float,
             duration_s: float, burst: bool) -> Dict[str, Any]:
        doc = {"schema": PROFILE_SCHEMA, "hz": hz,
               "duration_s": round(duration_s, 3), "burst": burst,
               # what the duty-cycle guard is actually running at
               "effective_hz": round(
                   1.0 / self.effective_period_s(), 2),
               "tick_cost_s": round(self._tick_cost_s, 6)}
        doc.update(trie.to_dict())
        return doc

    def to_dict(self) -> Dict[str, Any]:
        return self._doc(self.trie, self.hz,
                         time.time() - self.started_s, burst=False)

    def collapsed_lines(self) -> List[str]:
        from dmlc_tpu_torch.obs.export import collapsed_lines
        return collapsed_lines(self.to_dict())

    def burst(self, seconds: float,
              hz: Optional[float] = None) -> Dict[str, Any]:
        """Synchronous on-demand capture into a fresh trie (at least
        one tick even at seconds=0). Runs on the CALLING thread —
        the /profile handler thread — which is excluded from its own
        samples along with the continuous sampler thread."""
        hz = self.hz if hz is None else min(1000.0, max(0.5, float(hz)))
        seconds = max(0.0, float(seconds))
        trie = FrameTrie(self.trie.budget_bytes)
        me = threading.get_ident()
        exclude = self._exclude() | {me}
        period = 1.0 / hz
        t0 = time.perf_counter()
        deadline = t0 + seconds
        _internal_idents.add(me)  # hide this burst from the
        try:                      # continuous sampler's ticks too
            while True:
                try:
                    self._tick_into(trie, exclude)
                except Exception:  # noqa: BLE001 — keep the burst alive
                    pass
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                time.sleep(min(period, left))
        finally:
            _internal_idents.discard(me)
        return self._doc(trie, hz, time.perf_counter() - t0,
                         burst=True)


def hot_frames(doc: Dict[str, Any],
               hints: Optional[Iterable[str]] = None,
               limit: int = 8) -> List[Dict[str, Any]]:
    """Top on-CPU frames of a profile ``to_dict()`` payload:
    ``[{"frame", "samples", "frac"}]`` ranked by self weight.

    Synthetic leaves (``[off-cpu]``, ``[coarsened]``) and explicit
    native wait phases never rank — hot means CPU-hot. With ``hints``
    (lowercase substrings), only frames whose own name or any ancestor
    on the path matches are counted: "the hot frames OF the parse
    stage" is a path filter, not a leaf-name filter."""
    hints = [h.lower() for h in hints] if hints else None
    agg: Dict[str, int] = {}

    def _matches(name: str) -> bool:
        low = name.lower()
        return any(h in low for h in hints)  # type: ignore[union-attr]

    def _visit(node: Dict[str, Any], path_matched: bool) -> None:
        name = node.get("name") or "?"
        matched = path_matched or (hints is None or _matches(name))
        n = int(node.get("self") or 0)
        if (n > 0 and matched and name != WAIT_FRAME
                and name != FOLDED_FRAME
                and not name.endswith("_wait")):
            agg[name] = agg.get(name, 0) + n
        for child in node.get("children") or []:
            _visit(child, matched)

    for root in (doc.get("threads") or {}).values():
        # the thread-label root is context, not a frame: it never
        # satisfies a hint on its own
        for child in root.get("children") or []:
            _visit(child, False)
        n = int(root.get("self") or 0)
        if n and hints is None:
            agg[root.get("name") or "?"] = \
                agg.get(root.get("name") or "?", 0) + n
    total = int(doc.get("samples") or 0)
    ranked = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))
    return [{"frame": name, "samples": n,
             "frac": round(n / total, 4) if total else 0.0}
            for name, n in ranked[:max(1, int(limit))]]


# ------------------------------------------------- process-global wiring

_profiler: Optional[StackProfiler] = None


def active() -> Optional[StackProfiler]:
    return _profiler


def install(hz: float = DEFAULT_HZ,
            budget_bytes: int = DEFAULT_BUDGET_BYTES) -> StackProfiler:
    """Install + start the process profiler (idempotent: a second call
    returns the running one — the timeseries contract)."""
    global _profiler
    if _profiler is not None:
        return _profiler
    _profiler = StackProfiler(hz=hz, budget_bytes=budget_bytes).start()
    return _profiler


def uninstall() -> None:
    global _profiler
    prof, _profiler = _profiler, None
    if prof is not None:
        prof.stop()


def install_if_env() -> Optional[StackProfiler]:
    """Gang-worker hook (one line, like timeseries.install_if_env):
    start the sampler when ``DMLC_TPU_PROFILE_HZ`` is set to a
    positive rate — ``launch_local(profile_hz=...)`` sets it per
    worker — else no-op (0 explicitly disables)."""
    raw = os.environ.get(ENV_PROFILE_HZ)
    if not raw:
        return None
    try:
        hz = float(raw)
    except ValueError as e:
        from dmlc_tpu_torch.obs.log import warn_once
        warn_once("profile-env-failed",
                  f"obs.profile: bad {ENV_PROFILE_HZ}={raw!r}: {e}",
                  all_ranks=True)
        return None
    if hz <= 0:
        return None
    # a malformed BUDGET must not drop a valid rate request on the
    # floor: warn and fall back to the default budget
    raw_b = os.environ.get(ENV_PROFILE_BYTES)
    budget = DEFAULT_BUDGET_BYTES
    if raw_b:
        try:
            budget = int(raw_b)
        except ValueError as e:
            from dmlc_tpu_torch.obs.log import warn_once
            warn_once("profile-bytes-env-failed",
                      f"obs.profile: bad {ENV_PROFILE_BYTES}="
                      f"{raw_b!r} ({e}); using default "
                      f"{DEFAULT_BUDGET_BYTES}", all_ranks=True)
    return install(hz=hz, budget_bytes=budget)


def dump_collapsed() -> Optional[List[str]]:
    """The crash/stall attachment: force one immediate sample (the
    sampler-period bypass, like ``TimeSeriesRing.sample_now(force=
    True)``) and return the installed profiler's collapsed-stack
    lines — or None when no profiler is installed (clean processes
    and unprofiled runs attach nothing)."""
    prof = _profiler
    if prof is None:
        return None
    try:
        prof.sample_now(force=True)
        return prof.collapsed_lines()
    except Exception:  # noqa: BLE001 — diagnostics must never raise
        return None
