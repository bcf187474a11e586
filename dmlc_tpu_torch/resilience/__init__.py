"""dmlc_tpu_torch.resilience — fault injection, retry policy, gang supervision.

Counterpart of ``dmlc_tpu/resilience``, with the reference's exports:

- :mod:`~dmlc_tpu_torch.resilience.policy` — declarative
  :class:`RetryPolicy` (attempts, exponential backoff + deterministic
  jitter, per-attempt timeout, retryable classifier, shared
  :class:`RetryBudget`), applied at named seams via :func:`guarded`;
  configured in code or via ``DMLC_TPU_RETRY``;
- :mod:`~dmlc_tpu_torch.resilience.inject` — seeded, deterministic
  :class:`FaultPlan` (site glob × {ioerror, truncate, delay, crash} ×
  trigger) armed process-wide via ``DMLC_TPU_FAULTS``, firing inside
  the SAME seams the retries guard;
- :mod:`~dmlc_tpu_torch.resilience.supervise` — :class:`GangSupervisor`
  + :class:`RestartPolicy`: ``launch_local(restart_policy=...)``
  restarts a dead worker with its same (part, num_parts, seed, epoch)
  coordinates and a bumped ``DMLC_TPU_ATTEMPT``, up to a budget,
  instead of killing the gang.

The seams wrap host I/O only (stream opens and reads, directory stats
and listings, page and spill commits, the page-cache build, checkpoint
files); no seam wraps a kernel launch, a device copy or a ``torch.cuda``
call. Every retry, injected fault, and restart is observable through
``dmlc_tpu_torch.obs``: the ``resilience.retry`` /
``resilience.fault.injected`` / ``resilience.restart`` counters,
``retry/<site>`` / ``fault/<site>`` / ``gang/restart/<member>`` trace
instants, and a ``faults.json`` section in crash flight bundles.
"""

from dmlc_tpu_torch.resilience import inject
from dmlc_tpu_torch.resilience.inject import (
    CRASH_EXIT, ENV_FAULT_SEED, ENV_FAULTS, FaultClause, FaultPlan,
)
from dmlc_tpu_torch.resilience.policy import (
    ENV_RETRY, AttemptTimeout, RetryBudget, RetryPolicy, default_policy,
    guarded, policy_for, reset_policies, retry_counts,
    set_default_policy, set_policy,
)
from dmlc_tpu_torch.resilience.supervise import (
    ENV_ATTEMPT, GangMember, GangSupervisor, RestartPolicy,
)

__all__ = [
    "RetryPolicy", "RetryBudget", "AttemptTimeout", "guarded",
    "policy_for", "default_policy", "set_default_policy",
    "set_policy", "reset_policies", "retry_counts", "ENV_RETRY",
    "FaultPlan", "FaultClause", "inject", "ENV_FAULTS", "ENV_FAULT_SEED",
    "CRASH_EXIT",
    "RestartPolicy", "GangSupervisor", "GangMember", "ENV_ATTEMPT",
]
