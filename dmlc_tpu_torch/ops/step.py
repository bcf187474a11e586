"""The SGD step's objective (kernel K8) and update (kernel K9), and their
plain versions.

Counterpart of what the reference's one jitted ``train_step``
(``dmlc_tpu/models/common.py:88``) and sharded ``step`` (``:130``)
compile around the margins: the weighted logistic objective
``stable_bce_on_logits`` (``:28``) summed by the linear and factor
models' ``_block_objective`` and normalised by ``_weighted_mean``
(``:18``), its gradient in the margins (``jax.value_and_grad``), and the
update ``jax.tree.map(lambda p, g: p - lr·g)`` with the l2 term of
``_l2_term`` (``:62``). Here each is a CUDA kernel written by hand
(``csrc/step.cu``) with a plain PyTorch version of the same function
beside it:

- K8 ``logistic_step``: the margin m = t₀ (+ t₁) + b of each row (the
  model's margin terms and its bias), y = label > 0, the row's loss
  ``max(m,0) − m·y + log1p(exp(−|m|))``, lsum = Σ weight·loss, wsum =
  Σ weight, W = wsum if wsum > 0 else 1; returns (lsum / W, g, Σ g) with
  g = weight·d / W, d = σ(m) − y where m ≠ 0 and −y where m = 0 (the
  reference's subgradients: ``jnp.maximum`` splits a tie in half,
  ``jnp.abs`` has slope +1 at 0; ROADMAP C4). Its route is picked by
  the rows (``objective_route``): up to ``OBJECTIVE_STEP_MAX_ROWS``,
  "grid", one launch of a grid of blocks of ``OBJECTIVE_STEP_ROWS`` rows,
  every block summing all the weights for W; past it, "split", the two
  launches below with the first's total read straight by the second.
- K8 ``logistic_sums`` and ``logistic_grad``: the same split in two for
  the sharded step, whose W is the group's: the first gives (lsum, wsum)
  of this process's rows, which the caller all-reduces; the second reads
  that total on the device and gives (lsum / W, g, Σ g). Each is a grid
  of blocks of ``OBJECTIVE_GRID_ROWS`` rows.
- K9 ``sgd_update``: p ← p − lr·(g + 2·l2·p) for every parameter, the
  l2 term only where ``decay`` says so (every parameter but the bias), in
  one launch; where ``loss`` is given and l2 > 0, adds l2·Σ p² over the
  decayed parameters, read before the update, to it. Its route is picked
  by the parameters' units (``sgd_route``): "narrow", one block with a
  unit a thread, where they fit one block; else "wide", a grid.

As in ``ops/csr.py``, a wrapper runs the plain version only when its
tensors lie on the CPU, and for CUDA tensors launches its kernel or
raises; each wrapper counts its launches in ``.launches``. A NaN margin
gives a NaN loss and its row a NaN gradient, as in the reference. The
kernels sum in a fixed order, so their results do not vary from run to
run; the plain versions sum in torch's order. A sum over a grid of
blocks ends in the grid's last block, which a device counter finds; the
launches on one stream run one after another, so each stream has its own
counter (``_counter``), and launches on any number of streams may
overlap.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from dmlc_tpu_torch.ops.kernels import launch
from dmlc_tpu_torch.utils.logging import check

__all__ = ["stable_bce_on_logits", "logistic_step", "logistic_sums",
           "logistic_grad", "sgd_update",
           "logistic_step_plain", "logistic_sums_plain",
           "logistic_grad_plain", "sgd_update_plain", "sgd_grid",
           "sgd_route", "objective_grid", "objective_route",
           "SGD_MAX_PARAMS", "OBJECTIVE_GRID_ROWS", "OBJECTIVE_STEP_ROWS",
           "OBJECTIVE_STEP_MAX_ROWS"]

# kSgdMaxParams of csrc/step.cu: the parameters one K9 launch takes.
SGD_MAX_PARAMS = 16
# kGridRows of csrc/step.cu: the rows a block of K8's sharded launches
# takes; kStepRows: of its one-part "grid" route.
OBJECTIVE_GRID_ROWS = 512
OBJECTIVE_STEP_ROWS = 256
# kStepMaxRows of csrc/step.cu: the most rows the "grid" route takes; every
# block of it reads all the rows' weights, and past this the two launches
# of the "split" route took less time (an H100, PERF.md).
OBJECTIVE_STEP_MAX_ROWS = 1 << 15
# kSgdThreads of csrc/step.cu: K9's threads a block, and so the most units
# of its narrow route; and its wide grid's blocks an SM at most.
_SGD_THREADS = 256
_SGD_BLOCKS_PER_SM = 8


# ------------------------------------------------------------ plain versions

def _margins(terms, bias):
    m = terms[0]
    for t in terms[1:]:
        m = m + t
    return m if bias is None else m + bias


def stable_bce_on_logits(margins: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Per-row binary cross-entropy on logits, numerically stable.

    Labels may follow the ±1 (libsvm) or {0,1} convention: y = label > 0.

    At a zero margin (every row of the zero-initialised model) the
    gradient follows the reference's subgradients, not σ(0) − y:
    ``jnp.maximum`` splits a tie in half (as ``torch.maximum`` does) and
    ``jnp.abs`` has slope +1 at 0 (``torch.abs`` has 0), so |m| is
    written as a select that takes the +m branch at 0.
    """
    y = (labels > 0).to(torch.float32)
    abs_m = torch.where(margins >= 0, margins, -margins)
    return (torch.maximum(margins, torch.zeros_like(margins))
            - margins * y + torch.log1p(torch.exp(-abs_m)))


def _row_loss_and_d(m, label):
    """The row's loss and d, the derivative of the loss in m (C4's
    subgradient at m = 0)."""
    y = (label > 0).to(torch.float32)
    d = torch.where(m == 0, -y, torch.sigmoid(m) - y)
    return stable_bce_on_logits(m, label), d


def _grad(m, label, weight, lsum, wsum):
    denom = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    _, d = _row_loss_and_d(m, label)
    g = (weight * (1.0 / denom)) * d
    return lsum / denom, g, g.sum()


def logistic_sums_plain(terms, bias, label, weight) -> torch.Tensor:
    """Plain version of K8's first sharded launch: [lsum, wsum]."""
    loss, _ = _row_loss_and_d(_margins(terms, bias), label)
    return torch.stack([(loss * weight).sum(), weight.sum()])


def logistic_grad_plain(terms, bias, label, weight, total):
    """Plain version of K8's second sharded launch: (loss, g, Σ g) from
    the group's ``total`` = [lsum, wsum]."""
    return _grad(_margins(terms, bias), label, weight, total[0], total[1])


def logistic_step_plain(terms, bias, label, weight):
    """Plain version of K8 on one part: (loss, g, Σ g)."""
    m = _margins(terms, bias)
    loss, _ = _row_loss_and_d(m, label)
    return _grad(m, label, weight, (loss * weight).sum(), weight.sum())


def sgd_update_plain(params, grads, decay, lr: float, l2: float,
                     loss: Optional[torch.Tensor] = None) -> None:
    """Plain version of K9, in place."""
    with torch.no_grad():
        if loss is not None and l2:
            loss.add_(l2 * sum((p * p).sum()
                               for p, dk in zip(params, decay) if dk))
        for p, g, dk in zip(params, grads, decay):
            p.sub_(lr * (g + 2 * l2 * p) if dk and l2 else lr * g)


# ------------------------------------------------------------ wrappers

def _check_objective(terms, bias, label, weight) -> bool:
    """Checks a K8 call's tensors; returns whether to launch the
    kernel."""
    check(1 <= len(terms) <= 2, f"K8 takes 1 or 2 margin terms, got "
          f"{len(terms)}")
    shape = tuple(label.shape)
    tensors = list(terms) + [label, weight]
    for name, t in zip(["term"] * len(terms) + ["label", "weight"], tensors):
        check(t.dtype == torch.float32 and tuple(t.shape) == shape,
              f"K8's {name} must be float32 {shape}, got {t.dtype} "
              f"{tuple(t.shape)}")
    if bias is not None:
        check(bias.dtype == torch.float32 and bias.numel() == 1,
              f"K8's bias must be a float32 scalar, got {bias.dtype} "
              f"{tuple(bias.shape)}")
        tensors.append(bias)
    devices = {t.device for t in tensors}
    check(len(devices) == 1, f"K8's tensors must share one device, got "
          f"{sorted(str(d) for d in devices)}")
    if label.device.type == "cpu":
        return False
    check(label.is_cuda, f"K8 runs on cuda or cpu, got {label.device}")
    for t in tensors:
        check(t.is_contiguous(), "K8 needs contiguous tensors")
    return True


def _pointers(terms, bias, label, weight):
    return (terms[0].data_ptr(),
            terms[1].data_ptr() if len(terms) > 1 else None,
            None if bias is None else bias.data_ptr(),
            label.data_ptr(), weight.data_ptr(), label.numel())


def _scalar(like):
    return torch.empty((), dtype=torch.float32, device=like.device)


def objective_route(n: int) -> str:
    """K8's route on one part of ``n`` rows: "grid" (one launch of
    ``logistic_step_kernel``) up to OBJECTIVE_STEP_MAX_ROWS rows, else
    "split" (``logistic_sums_kernel`` then ``logistic_grad_kernel``)."""
    return "grid" if n <= OBJECTIVE_STEP_MAX_ROWS else "split"


def logistic_step(terms: Sequence[torch.Tensor],
                  bias: Optional[torch.Tensor], label: torch.Tensor,
                  weight: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 on one part: (loss, g, Σ g) of the rows (see module
    docstring). ``terms``: 1 or 2 float32 tensors of ``label``'s shape,
    summed in order into the margins, then ``bias`` added."""
    if not _check_objective(terms, bias, label, weight):
        return logistic_step_plain(terms, bias, label, weight)
    n = label.numel()
    if objective_route(n) == "split":
        return logistic_grad(terms, bias, label, weight,
                             logistic_sums(terms, bias, label, weight))
    blocks = objective_grid(n, OBJECTIVE_STEP_ROWS)
    partial = torch.empty(2 * blocks, dtype=torch.float32,
                          device=label.device)
    loss, gb, g = _scalar(label), _scalar(label), torch.empty_like(label)
    launch("dmlc_logistic_step", label.device,
           *_pointers(terms, bias, label, weight), partial.data_ptr(),
           _counter(label.device).data_ptr(), loss.data_ptr(),
           g.data_ptr(), gb.data_ptr(), blocks)
    logistic_step.launches += 1
    return loss, g, gb


def objective_grid(n: int, rows: int = OBJECTIVE_GRID_ROWS) -> int:
    """The blocks of one of K8's launches over ``n`` rows, ``rows`` a
    block (the sharded launches' OBJECTIVE_GRID_ROWS, or the one-part
    grid's OBJECTIVE_STEP_ROWS): ceil(n / rows), at least one."""
    return max(1, -(-n // rows))


def logistic_sums(terms: Sequence[torch.Tensor],
                  bias: Optional[torch.Tensor], label: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """K8's first sharded launch: [lsum, wsum] (float32 [2]) over every
    row of this process's parts."""
    if not _check_objective(terms, bias, label, weight):
        return logistic_sums_plain(terms, bias, label, weight)
    blocks = objective_grid(label.numel())
    partial = torch.empty(2 * blocks, dtype=torch.float32,
                          device=label.device)
    total = torch.empty(2, dtype=torch.float32, device=label.device)
    launch("dmlc_logistic_sums", label.device,
           *_pointers(terms, bias, label, weight), partial.data_ptr(),
           _counter(label.device).data_ptr(), total.data_ptr(), blocks)
    logistic_sums.launches += 1
    return total


def logistic_grad(terms: Sequence[torch.Tensor],
                  bias: Optional[torch.Tensor], label: torch.Tensor,
                  weight: torch.Tensor, total: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's second sharded launch: (loss, g, Σ g) of this process's rows
    with the group's ``total`` = [lsum, wsum] (float32 [2] on the same
    device, read there, never on the host)."""
    launch_it = _check_objective(terms, bias, label, weight)
    check(total.dtype == torch.float32 and tuple(total.shape) == (2,)
          and total.device == label.device,
          f"K8's total must be float32 [2] on {label.device}, got "
          f"{total.dtype} {tuple(total.shape)} on {total.device}")
    if not launch_it:
        return logistic_grad_plain(terms, bias, label, weight, total)
    blocks = objective_grid(label.numel())
    partial = torch.empty(blocks, dtype=torch.float32, device=label.device)
    loss, gb, g = _scalar(label), _scalar(label), torch.empty_like(label)
    launch("dmlc_logistic_grad", label.device,
           *_pointers(terms, bias, label, weight),
           total.contiguous().data_ptr(), loss.data_ptr(), g.data_ptr(),
           partial.data_ptr(), _counter(label.device).data_ptr(),
           gb.data_ptr(), blocks)
    logistic_grad.launches += 1
    return loss, g, gb


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_counters = {}


def _counter(device: torch.device) -> torch.Tensor:
    """The count of finished blocks that a grid sum of K8 or K9 keeps, one
    for each stream of ``device`` (the current one is the launch's):
    zeroed once, and left at 0 by every launch (its last block wraps it).
    Launches on one stream never overlap, so they may share it; two
    launches on two streams would mix their counts, so they do not."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _counters:
        _counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _counters[key]


def sgd_grid(numels: Sequence[int], sms: int) -> int:
    """K9's blocks for parameters of ``numels`` floats on a card of
    ``sms`` SMs: one float4 a thread over the largest, at most
    _SGD_BLOCKS_PER_SM blocks an SM (a grid-stride loop takes the rest),
    at least one."""
    units = (max(numels, default=0) + 3) // 4
    return max(1, min((units + _SGD_THREADS - 1) // _SGD_THREADS,
                      _SGD_BLOCKS_PER_SM * sms))


def _sgd_units(numel: int, p_ptr: int, g_ptr: int) -> int:
    """K9's units of a parameter of ``numel`` floats at address ``p_ptr``
    with its gradient at ``g_ptr`` (``sgd_cut`` of csrc/step.cu): the
    scalars before p's first 16-byte boundary, the float4s after them and
    the scalars left; every float a unit where p and g align apart."""
    if p_ptr % 16 != g_ptr % 16 or p_ptr % 4:
        return numel
    head = min(numel, (16 - p_ptr % 16) % 16 // 4)
    return numel - 3 * ((numel - head) // 4)


def sgd_route(numels: Sequence[int],
              addresses: Optional[Sequence[Tuple[int, int]]] = None) -> str:
    """K9's route for parameters of ``numels`` floats at ``addresses``
    ((p, g) a parameter; 16-byte aligned where None): "narrow" (one block,
    a unit a thread) where their units together fit _SGD_THREADS, else
    "wide" (a grid, ``sgd_grid``)."""
    if addresses is None:
        addresses = [(0, 0)] * len(numels)
    units = sum(_sgd_units(n, p, g) for n, (p, g) in zip(numels, addresses))
    return "narrow" if units <= _SGD_THREADS else "wide"


def sgd_update(params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], decay: Sequence[bool],
               lr: float, l2: float,
               loss: Optional[torch.Tensor] = None) -> None:
    """K9: every parameter updated in place (see module docstring), in
    one launch by ``sgd_route``'s route. ``decay[i]``: whether parameter i
    takes the l2 term. ``loss``: a float32 scalar to which l2·Σ p² (old p)
    is added where l2 > 0, or None."""
    check(len(params) == len(grads) == len(decay),
          f"K9 takes one gradient and one decay flag a parameter, got "
          f"{len(params)}, {len(grads)}, {len(decay)}")
    tensors = list(params) + list(grads)
    for p, g in zip(params, grads):
        check(p.dtype == g.dtype == torch.float32 and p.shape == g.shape,
              f"K9 takes float32 parameters and gradients of one shape, "
              f"got {p.dtype} {tuple(p.shape)} and {g.dtype} "
              f"{tuple(g.shape)}")
    if loss is not None:
        check(loss.dtype == torch.float32 and loss.numel() == 1,
              f"K9's loss must be a float32 scalar, got {loss.dtype} "
              f"{tuple(loss.shape)}")
        tensors.append(loss)
    devices = {t.device for t in tensors}
    check(len(devices) <= 1, f"K9's tensors must share one device, got "
          f"{sorted(str(d) for d in devices)}")
    if not params or params[0].device.type == "cpu":
        sgd_update_plain(params, grads, decay, lr, l2, loss)
        return
    device = params[0].device
    check(device.type == "cuda", f"K9 runs on cuda or cpu, got {device}")
    check(len(params) <= SGD_MAX_PARAMS,
          f"K9 takes at most {SGD_MAX_PARAMS} parameters a launch, got "
          f"{len(params)}")
    for t in tensors:
        check(t.is_contiguous(), "K9 needs contiguous tensors")
    n = len(params)
    numels = [p.numel() for p in params]
    narrow = sgd_route(numels, [(p.data_ptr(), g.data_ptr())
                                for p, g in zip(params, grads)]) == "narrow"
    blocks = 0 if narrow else sgd_grid(numels, _sms(device))
    accumulate = loss is not None and l2 != 0
    # the wide grid's l2 sum needs a workspace; the narrow block does not
    grid_sum = accumulate and not narrow
    partial = (torch.empty(blocks, dtype=torch.float32, device=device)
               if grid_sum else None)
    # the host table the C entry copies into the kernel's argument; the
    # arrays stay referenced until the launch returns
    table = ((ctypes.c_void_p * n)(*[p.data_ptr() for p in params]),
             (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads]),
             (ctypes.c_int64 * n)(*numels),
             (ctypes.c_int * n)(*[int(bool(d)) for d in decay]))
    launch("dmlc_sgd_update", device,
           *[ctypes.addressof(a) for a in table], n, float(lr), float(l2),
           partial.data_ptr() if grid_sum else None,
           _counter(device).data_ptr() if grid_sum else None,
           loss.data_ptr() if accumulate else None, blocks)
    sgd_update.launches += 1


logistic_step.launches = 0
logistic_sums.launches = 0
logistic_grad.launches = 0
sgd_update.launches = 0
