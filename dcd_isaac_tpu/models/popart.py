"""PopArt value normalization as pure functions over a stats struct.

Reference models/popart.py:20-103 (torch Parameter mutation) re-done
functionally: the stats live in the agent train-state and the critic-head
kernel/bias are rescaled by param-tree surgery inside the PPO update, so the
whole thing stays inside one jitted step.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp

from ..utils import struct


@struct.dataclass
class PopArtState:
    mean: jnp.ndarray       # ()
    mean_sq: jnp.ndarray    # ()
    debias: jnp.ndarray     # ()

    @classmethod
    def create(cls) -> 'PopArtState':
        z = jnp.float32(0.0)
        return cls(mean=z, mean_sq=z, debias=z)


BETA = 0.99999
EPSILON = 1e-5


def _stddev(s: PopArtState) -> jnp.ndarray:
    return jnp.sqrt(jnp.clip(s.mean_sq - s.mean ** 2, 1e-4 ** 2, None))


def debiased_mean_var(s: PopArtState) -> Tuple[jnp.ndarray, jnp.ndarray]:
    db = jnp.clip(s.debias, EPSILON, None)
    mean = s.mean / db
    mean_sq = s.mean_sq / db
    var = jnp.clip(mean_sq - mean ** 2, 1e-2, None)
    return mean, var


def normalize(s: PopArtState, x: jnp.ndarray) -> jnp.ndarray:
    mean, var = debiased_mean_var(s)
    return (x - mean) / jnp.sqrt(var)


def denormalize(s: PopArtState, x: jnp.ndarray) -> jnp.ndarray:
    mean, var = debiased_mean_var(s)
    return x * jnp.sqrt(var) + mean


def update(
    s: PopArtState, targets: jnp.ndarray, kernel: jnp.ndarray,
    bias: jnp.ndarray,
) -> Tuple[PopArtState, jnp.ndarray, jnp.ndarray]:
    """Fold a batch of return targets into the stats and rescale the head.

    Returns (new_stats, new_kernel, new_bias) preserving head outputs
    (reference popart.py:61-78).
    """
    old_mean, old_std = s.mean, _stddev(s)
    batch_mean = targets.mean()
    batch_sq_mean = (targets ** 2).mean()
    new = PopArtState(
        mean=s.mean * BETA + batch_mean * (1 - BETA),
        mean_sq=s.mean_sq * BETA + batch_sq_mean * (1 - BETA),
        debias=s.debias * BETA + (1 - BETA),
    )
    new_std = _stddev(new)
    new_kernel = kernel * old_std / new_std
    new_bias = (old_std * bias + old_mean - new.mean) / new_std
    return new, new_kernel, new_bias
