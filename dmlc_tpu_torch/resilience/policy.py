"""Declarative retry/backoff policy — the port's ONE retry mechanism.

Copy of ``dmlc_tpu/resilience/policy.py`` with its imports rewritten to
``dmlc_tpu_torch``. ``delay_for`` keeps the reference's
``zlib.crc32(site)`` jitter, so both packages give the same backoff
schedule for a site. When an injected fault kills an attempt,
:func:`guarded` tells the RPC tracing plane (``obs.rpc``), so the retry
still shows as one span an attempt. The built-in site table keeps the
reference's entries for sites whose planes the port does not have yet
(``obs.scrape``, ``io.objstore.peer``, ``rendezvous.*``). Seams wrap
host I/O only: a CUDA error surfaces as a ``RuntimeError``, which the
default classifier never retries.

Reference: the production dmlc-core survives worker faults through its
``recover`` handshake + ``DMLC_NUM_ATTEMPT`` rejoin (SURVEY §5.3); the
I/O layer's transient-error story there is ad-hoc per call site. Here
every retry in the repo flows through a :class:`RetryPolicy` applied at
a named **site** (``io.stream.open``, ``io.stream.read``,
``io.filesys.stat``, ``spill.commit``, ``checkpoint.save``,
``checkpoint.restore``, ``data.pages.build``, ``obs.scrape``), so

- attempts, exponential backoff + deterministic jitter, the
  retryable-exception classifier, an optional per-attempt timeout, and
  an optional :class:`RetryBudget` shared across a whole pipeline are
  POLICY, configured in one place (or via ``DMLC_TPU_RETRY``), not
  hand-rolled loops;
- every retry is observable: ``resilience.retry`` counter of the obs
  metrics registry, per-site counts in the
  registered ``resilience`` collector, a ``retry/<site>`` trace
  instant, and a rate-limited obs.log warning.

The seam entry point is :func:`guarded`: near-zero cost on the quiet
path (one module-global read + try/except around the call), it engages
the site's policy only after a failure — and arms the
:mod:`~dmlc_tpu_torch.resilience.inject` fault plane when a
:class:`FaultPlan` is installed, so chaos tests provoke the SAME retry
machinery real faults exercise. (Truncation faults act at the
byte-owning seam itself — ``io.stream.FileStream`` — which alone can
keep the stream position consistent with the shortened data.)

Env contract (``DMLC_TPU_RETRY``): ``;``-separated clauses of ``k=v``
pairs. A clause without ``site=`` overrides the global default; with
``site=<glob>`` it overrides matching sites. Keys: ``attempts``,
``base`` (seconds), ``max``, ``multiplier``, ``jitter`` (fraction),
``timeout`` (per-attempt seconds). Example::

    DMLC_TPU_RETRY="attempts=5,base=0.01;site=obs.scrape,attempts=1"
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from dmlc_tpu_torch.resilience import inject as _inject
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = [
    "RetryPolicy", "RetryBudget", "AttemptTimeout",
    "guarded", "policy_for", "default_policy",
    "set_default_policy", "set_policy", "reset_policies",
    "retry_counts", "ENV_RETRY",
]

ENV_RETRY = "DMLC_TPU_RETRY"


class AttemptTimeout(TimeoutError):
    """A policed attempt exceeded ``attempt_timeout_s``. The worker
    thread running it is ABANDONED as a daemon (a last-resort guard
    for hung I/O, off by default) — and because TimeoutError is
    retryable by default, the next attempt may run WHILE the abandoned
    one is still blocked. Only set ``attempt_timeout_s`` on idempotent,
    state-free callables (none of the built-in seams set it: a shared
    fd touched by two unsynchronized attempts is corruption, not
    resilience)."""


class RetryBudget:
    """A shared, thread-safe pool of retries. Attach one budget to the
    policies of several sites (or one pipeline's whole seam set) and
    the TOTAL number of retries across them is bounded — a failing disk
    cannot turn a 10-stage pipeline into 10× max_attempts of backoff."""

    def __init__(self, max_retries: int):
        check(max_retries >= 0, "RetryBudget needs max_retries >= 0")
        self.max_retries = int(max_retries)
        self._lock = threading.Lock()
        self._spent = 0

    def take(self, site: str = "") -> bool:
        """Consume one retry; False when the budget is exhausted."""
        with self._lock:
            if self._spent >= self.max_retries:
                return False
            self._spent += 1
            return True

    @property
    def spent(self) -> int:
        return self._spent

    @property
    def remaining(self) -> int:
        return max(0, self.max_retries - self._spent)


def _default_retryable(exc: BaseException) -> bool:
    """Transient-I/O classifier: OSError-family errors retry, EXCEPT
    the ones that re-running cannot fix (missing file, permissions,
    wrong path shape). ValueError/DMLCError/etc. never retry — a parse
    error replayed is the same parse error."""
    if not isinstance(exc, (OSError, ConnectionError, TimeoutError)):
        return False
    return not isinstance(exc, (FileNotFoundError, PermissionError,
                                IsADirectoryError, NotADirectoryError,
                                FileExistsError))


@dataclass
class RetryPolicy:
    """Max attempts + exponential backoff with deterministic jitter.

    ``jitter`` is a ± fraction of the computed delay, derived from
    ``(jitter_seed, site, attempt)`` — deterministic, so a replayed
    fault plan produces the identical retry schedule (the same
    determinism contract the data plane keeps). ``sleep`` is
    injectable for tests. ``retryable`` may be a callable classifier
    or a tuple of exception types."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    jitter_seed: int = 0x5EED
    attempt_timeout_s: Optional[float] = None
    retryable: Any = None           # callable | tuple[type] | None=default
    budget: Optional[RetryBudget] = None
    sleep: Callable[[float], None] = time.sleep

    def with_(self, **changes: Any) -> "RetryPolicy":
        return dataclasses.replace(self, **changes)

    # -- classification

    def is_retryable(self, exc: BaseException) -> bool:
        r = self.retryable
        if r is None:
            return _default_retryable(exc)
        if isinstance(r, (tuple, type)):
            return isinstance(exc, r)
        return bool(r(exc))

    # -- backoff

    def delay_for(self, site: str, attempt: int) -> float:
        d = min(self.max_delay_s,
                self.base_delay_s * self.multiplier ** (attempt - 1))
        if self.jitter:
            rng = random.Random(self.jitter_seed
                                ^ zlib.crc32(site.encode())
                                ^ (attempt * 0x9E3779B1))
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)

    # -- execution

    def _attempt(self, fn: Callable[[], Any]) -> Any:
        t = self.attempt_timeout_s
        if not t:
            return fn()
        box: List[Tuple[str, Any]] = []

        def run() -> None:
            try:
                box.append(("ok", fn()))
            except BaseException as e:  # noqa: BLE001 — relayed below
                box.append(("err", e))

        th = threading.Thread(target=run, daemon=True,
                              name="dmlc_tpu_torch.resilience.attempt")
        th.start()
        th.join(t)
        if th.is_alive():
            raise AttemptTimeout(
                f"attempt exceeded {t}s (worker thread abandoned)")
        kind, val = box[0]
        if kind == "err":
            raise val
        return val

    def call(self, site: str, fn: Callable[[], Any],
             first_exc: Optional[BaseException] = None) -> Any:
        """Run ``fn`` under this policy. ``first_exc`` lets a fast-path
        caller (:func:`guarded`) hand over a failure it already took as
        attempt 1, so the quiet path pays no policy machinery."""
        attempt = 1
        exc = first_exc
        while True:
            if exc is not None:
                if not self.is_retryable(exc) \
                        or attempt >= self.max_attempts \
                        or (self.budget is not None
                            and not self.budget.take(site)):
                    raise exc
                delay = self.delay_for(site, attempt)
                _note_retry(site, attempt, exc, delay)
                self.sleep(delay)
                attempt += 1
                exc = None
            try:
                return self._attempt(fn)
            except Exception as e:  # noqa: BLE001 — classified above
                exc = e


# ------------------------------------------------------------ site registry

# built-in per-site CHANGES (applied over whatever the CURRENT default
# policy is at lookup time — a replaced default's sleep/backoff flows
# through); a gang scrape should fail fast: the unreachable rank is
# reported, not waited on through a full backoff ladder. The objstore
# peer tier retries a little HARDER than the default: a peer answering
# 404 is usually the block's owner still mid-hydration, and a few
# short waits are what let a non-owner pace itself behind the owner
# instead of double-fetching from the wire (it still degrades to the
# wire when the ladder runs out — never a hang).
_BUILTIN_SITE_DEFAULTS: List[Tuple[str, Dict[str, Any]]] = [
    ("obs.scrape", {"max_attempts": 2, "base_delay_s": 0.05}),
    ("io.objstore.peer", {"max_attempts": 4, "base_delay_s": 0.05,
                          "max_delay_s": 0.5}),
    # the write plane: one torn part of a multipart upload re-sends
    # just that part — retrying is much cheaper than aborting the
    # whole upload, so the ladder is a step deeper than the default
    ("io.objstore.put", {"max_attempts": 4, "base_delay_s": 0.05,
                         "max_delay_s": 0.5}),
    # membership ops (join/heartbeat/leave): a flaky connection must
    # be a counted retry, not a membership flap — the ladder stays
    # well inside the service's heartbeat grace window so retries
    # never masquerade as a missed beat
    ("rendezvous.*", {"max_attempts": 3, "base_delay_s": 0.05,
                      "max_delay_s": 0.3}),
]

_lock = threading.Lock()
_default: Optional[RetryPolicy] = None   # programmatic override
_prog_overrides: List[Tuple[str, RetryPolicy]] = []
_env_default_kv: Dict[str, str] = {}
_env_site_kv: List[Tuple[str, Dict[str, str]]] = []
_env_loaded = False
# True once ANY configured policy carries attempt_timeout_s: guarded()
# must then resolve the policy BEFORE attempt 1 so the hung-I/O guard
# can police the attempt most likely to hang (no built-in sets it, so
# the quiet fast path stays the default)
_timeout_configured = False


_ENV_KEYS = {"attempts": ("max_attempts", int),
             "base": ("base_delay_s", float),
             "max": ("max_delay_s", float),
             "multiplier": ("multiplier", float),
             "jitter": ("jitter", float),
             "timeout": ("attempt_timeout_s", float)}


def _policy_from_kv(kv: Dict[str, str],
                    base: RetryPolicy) -> RetryPolicy:
    changes: Dict[str, Any] = {}
    for key, val in kv.items():
        if key == "site":
            continue
        spec = _ENV_KEYS.get(key)
        if spec is None:
            raise DMLCError(
                f"{ENV_RETRY}: unknown key {key!r} "
                f"(known: {sorted(_ENV_KEYS)} + site)")
        field, conv = spec
        changes[field] = conv(val)
    return base.with_(**changes)


def _load_env_locked() -> None:
    global _env_loaded, _timeout_configured
    if _env_loaded:
        return
    _env_loaded = True
    for clause in os.environ.get(ENV_RETRY, "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        kv = _inject.parse_kv(clause, ENV_RETRY)
        if "timeout" in kv:
            _timeout_configured = True
        if "site" in kv:
            _env_site_kv.append((kv["site"], kv))
        else:
            _env_default_kv.update(kv)


def _default_locked() -> RetryPolicy:
    """The current default: programmatic override verbatim, else the
    built-in RetryPolicy with the env's global clause applied."""
    if _default is not None:
        return _default
    return _policy_from_kv(_env_default_kv, RetryPolicy())


def default_policy() -> RetryPolicy:
    with _lock:
        _load_env_locked()
        return _default_locked()


def set_default_policy(policy: RetryPolicy) -> None:
    """Replace the default policy. Env/built-in site overrides are
    stored as CHANGES and re-derived from the new default at lookup
    time, so an injected sleep or zeroed backoff reaches every site
    that only tweaks attempts."""
    global _default, _timeout_configured
    with _lock:
        _default = policy
        if policy.attempt_timeout_s:
            _timeout_configured = True


def set_policy(site_pattern: str, policy: RetryPolicy) -> None:
    """Override the policy for sites matching ``site_pattern`` (glob).
    Later calls outrank earlier ones and everything from the env."""
    global _timeout_configured
    with _lock:
        _prog_overrides.insert(0, (site_pattern, policy))
        if policy.attempt_timeout_s:
            _timeout_configured = True


def policy_for(site: str) -> RetryPolicy:
    with _lock:
        _load_env_locked()
        for pattern, policy in _prog_overrides:
            if fnmatch.fnmatchcase(site, pattern):
                return policy
        base = _default_locked()
        for pattern, kv in _env_site_kv:
            if fnmatch.fnmatchcase(site, pattern):
                return _policy_from_kv(kv, base)
        for pattern, changes in _BUILTIN_SITE_DEFAULTS:
            if fnmatch.fnmatchcase(site, pattern):
                return base.with_(**changes)
        return base


def reset_policies() -> None:
    """Forget programmatic + env-derived configuration (tests); the
    env is re-read on next use."""
    global _default, _env_loaded, _timeout_configured
    with _lock:
        _default = None
        _env_loaded = False
        _timeout_configured = False
        _prog_overrides.clear()
        _env_default_kv.clear()
        _env_site_kv.clear()
    with _counts_lock:
        _retry_counts.clear()


# ------------------------------------------------------------ observability

_counts_lock = threading.Lock()
_retry_counts: Dict[str, int] = {}


class _ResilienceStats:
    """Weakly-registerable owner of the per-site retry counts (plain
    dicts cannot carry a weakref)."""

    def snapshot(self) -> Dict[str, Any]:
        with _counts_lock:
            retry = dict(_retry_counts)
        return {"retry": retry,
                "faults_injected": _inject.injected_count()}


_stats = _ResilienceStats()
_stats_registered = False


def retry_counts() -> Dict[str, int]:
    """Per-site retry totals for this process (tests/diagnostics)."""
    with _counts_lock:
        return dict(_retry_counts)


def _note_retry(site: str, attempt: int, exc: BaseException,
                delay: float) -> None:
    global _stats_registered
    with _counts_lock:
        _retry_counts[site] = _retry_counts.get(site, 0) + 1
    try:
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        if not _stats_registered:
            _stats_registered = True
            REGISTRY.register("resilience", _stats,
                              _ResilienceStats.snapshot)
        REGISTRY.counter("resilience.retry").inc()
        from dmlc_tpu_torch.obs import trace
        trace.instant(f"retry/{site}", "resilience",
                      {"attempt": attempt, "delay_s": round(delay, 4),
                       "error": repr(exc)[:200]})
        from dmlc_tpu_torch.obs.log import warn_limited
        warn_limited(
            f"retry-{site}",
            f"resilience: {site} failed ({exc!r}); retrying "
            f"(attempt {attempt} -> {attempt + 1}, {delay:.3f}s backoff)",
            min_interval_s=60.0, all_ranks=True)
    except Exception:  # noqa: BLE001 — telemetry must never block a retry
        pass


# ------------------------------------------------------------ seam helpers

def guarded(site: str, fn: Callable[[], Any],
            policy: Optional[RetryPolicy] = None) -> Any:
    """THE seam entry point: run ``fn`` under ``site``'s retry policy,
    firing any armed fault plan inside each attempt.

    Quiet-path cost (no plan armed, no explicit/configured policy that
    needs to police attempt 1, first attempt succeeds): one
    module-global read + try/except + the call — cheap enough for
    per-chunk reads. The policy machinery engages up-front whenever
    any configured policy carries ``attempt_timeout_s`` (the hung-I/O
    guard must police the FIRST attempt — the one most likely to
    hang), otherwise only on failure."""
    if not _env_loaded:
        # a timeout configured ONLY via DMLC_TPU_RETRY must be seen
        # BEFORE the first fast-path call, not at first failure — a
        # hung first read would otherwise never meet its guard
        with _lock:
            _load_env_locked()
    plan = _inject._plan
    if plan is None and policy is None and not _timeout_configured:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified by policy
            pol = policy_for(site)
            if not pol.is_retryable(e):
                raise
            return pol.call(site, fn, first_exc=e)
    pol = policy if policy is not None else policy_for(site)
    if plan is None:
        return pol.call(site, fn)

    def attempt() -> Any:
        live = _inject._plan
        if live is not None:
            try:
                live.fire(site)
            except BaseException:
                # the fault killed the attempt before its transport
                # opened a client span — tell the tracing plane so the
                # retry still shows as one countable span per attempt
                from dmlc_tpu_torch.obs import rpc as _rpc
                _rpc.note_injected_failure(site)
                raise
        return fn()

    return pol.call(site, attempt)
