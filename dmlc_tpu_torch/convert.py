"""Parameter exchange with the JAX package, as numpy arrays.

The two packages never import each other; a test (or a user moving a
model) passes parameters through numpy: ``params_from_jax`` turns the
JAX model's parameter dict into tensors a port model loads with
``load_state_dict``, and ``params_to_numpy`` turns a port model's
parameters back into the JAX layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(params: Mapping[str, np.ndarray],
                    device=None) -> Dict[str, torch.Tensor]:
    """JAX parameters (``{"w": ..., "b": ...}`` as numpy) → float32
    tensors on ``device`` (``cuda`` by default)."""
    device = torch.device("cuda" if device is None else device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """Port parameters (a ``state_dict`` or any name → tensor mapping)
    → numpy arrays in the JAX package's layout."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
