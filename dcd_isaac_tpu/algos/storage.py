"""Rollout storage as a pytree + GAE/returns.

Accelerator-native replacement for reference algos/storage.py: instead of a
mutable (T+1, N, ...) buffer object filled step-by-step over pickle pipes, a
rollout is the stacked ``ys`` of a ``lax.scan`` — an immutable (T, N, ...)
pytree that never leaves device memory.

Semantics kept from the reference:
  * masks[t+1] = 0 when step t ended an episode (storage.py:177)
  * bad_masks flag time-limit ends; cliffhanger_masks flag rollout-final
    unfinished episodes (adversarial_runner.py:509-520)
  * GAE recursion masked across episode boundaries (storage.py:251-256)
  * teacher final-reward replacement (storage.py:205-206)

Divergence (documented): proper-time-limit bootstrapping here injects the
truncated-obs value directly into the GAE delta at the truncation step
(``r + γ·V(s_trunc)``) rather than the reference's post-hoc substitution into
``value_preds[t+1]`` (storage.py:208-231), which is nullified by masks==0 in
its own GAE — this is the textbook-correct form of the behavior the reference
intends, with V(s_trunc) computed in-scan at rollout time.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..utils import struct


@struct.dataclass
class Rollout:
    """(T, N, ...) arrays from one rollout phase.

    ``obs`` is a dict pytree of (T, N, ...) arrays; ``log_dists`` is the full
    per-action log-softmax for discrete policies (used by entropy-based PLR
    scores) or the summed log-prob (continuous, shape (T, N)).
    """
    obs: Any
    actions: jnp.ndarray       # (T, N) int32 or (T, N, A) float
    log_probs: jnp.ndarray     # (T, N)
    log_dists: jnp.ndarray     # (T, N, num_actions) or (T, N)
    values: jnp.ndarray        # (T, N)
    rewards: jnp.ndarray       # (T, N)
    masks_pre: jnp.ndarray     # (T, N) mask BEFORE step t (1 = same episode)
    dones: jnp.ndarray         # (T, N) episode ended AT step t
    bad_masks: jnp.ndarray     # (T, N) 0 = time-limit (truncated) end at t
    cliffhangers: jnp.ndarray  # (T, N) 1 = cliffhanger forced-done at t
    trunc_values: jnp.ndarray  # (T, N) V(truncated obs) at truncation steps
    level_seeds: jnp.ndarray   # (T, N) int32

    @property
    def num_steps(self) -> int:
        return self.rewards.shape[0]

    @property
    def num_actors(self) -> int:
        return self.rewards.shape[1]

    def replace_final_reward(self, returns: jnp.ndarray) -> 'Rollout':
        """Teacher regret becomes the final-step reward (storage.py:205)."""
        return self.replace(rewards=self.rewards.at[-1].set(returns))


def compute_gae(
    rollout: Rollout,
    next_value: jnp.ndarray,
    gamma: float,
    gae_lambda: float,
    use_proper_time_limits: bool = False,
) -> jnp.ndarray:
    """Generalized advantage estimation → returns (T, N).

    ``next_value`` is V(obs_T) (used only through the truncation path when the
    rollout end forces done, mirroring reference masks[-1]=0 semantics).
    """
    values_next = jnp.concatenate(
        [rollout.values[1:], next_value[None]], axis=0)
    mask_next = 1.0 - rollout.dones.astype(jnp.float32)

    if use_proper_time_limits:
        trunc_boot = (
            (1.0 - mask_next)
            * (1.0 - rollout.bad_masks.astype(jnp.float32))
            * rollout.trunc_values
        )
    else:
        trunc_boot = jnp.zeros_like(rollout.values)

    boot = mask_next * values_next + trunc_boot
    deltas = rollout.rewards + gamma * boot - rollout.values

    def scan_back(gae, inp):
        delta, m = inp
        gae = delta + gamma * gae_lambda * m * gae
        return gae, gae

    _, advs = jax.lax.scan(
        scan_back,
        jnp.zeros_like(next_value),
        (deltas, mask_next),
        reverse=True,
    )
    return advs + rollout.values


def compute_discounted_returns(
    rollout: Rollout,
    next_value: jnp.ndarray,
    gamma: float,
) -> jnp.ndarray:
    """Plain discounted returns (reference compute_discounted_returns)."""
    mask_next = 1.0 - rollout.dones.astype(jnp.float32)

    def scan_back(ret, inp):
        r, m = inp
        ret = ret * gamma * m + r
        return ret, ret

    _, rets = jax.lax.scan(
        scan_back, next_value, (rollout.rewards, mask_next), reverse=True)
    return rets


def batched_value_loss(
    returns: jnp.ndarray,
    value_preds: jnp.ndarray,
    signed: bool = False,
    positive_only: bool = False,
    power: int = 1,
    clipped: bool = True,
) -> jnp.ndarray:
    """Per-env mean TD magnitude (reference storage.get_batched_value_loss).

    Used by ACCEL 'easy' base-level selection; (T, N) → (N,).
    """
    td = returns - value_preds
    if signed:
        pass
    elif positive_only:
        td = jnp.clip(td, 0, None)
    else:
        td = jnp.abs(td)
    if power > 1:
        td = td ** power
    batch_td = td.mean(0)
    if clipped:
        batch_td = jnp.clip(batch_td, -1, 1)
    return batch_td
