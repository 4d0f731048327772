"""PPO in optax, compiled end-to-end.

Reference algos/ppo.py:61-146 re-designed for XLA: the epoch × minibatch loop
is a ``lax.scan`` over precomputed permutation indices, with sequential
optimizer steps exactly like the reference (each minibatch sees params
updated by the previous one).  ``discard_grad`` (Robust PLR's full
forward/backward with no optimizer step, ppo.py:129-130) is a traced flag —
updates are computed then masked, so the same compiled cycle handles both
replay and exploratory branches.

Recurrent minibatching groups whole envs (reference storage.recurrent
generator, storage.py:444-517) and replays the BPTT chunk with per-step
mask resets via the model's ``sequence`` method.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..models import popart as popart_lib
from ..models.distributions import (
    categorical_entropy, categorical_log_prob,
)
from ..utils import struct


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    clip_param: float = 0.2
    ppo_epoch: int = 5
    num_mini_batch: int = 1
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.0
    lr: float = 1e-4
    eps: float = 1e-5
    max_grad_norm: float = 0.5
    clip_value_loss: bool = True
    use_popart: bool = False
    remat: bool = False  # extra whole-forward remat (models already
    # remat their per-step embeds in `sequence`)
    # (trades FLOPs for HBM so num_mini_batch=1 configs fit at large N)


@struct.dataclass
class AgentTrainState:
    params: Any
    opt_state: Any
    popart: Optional[popart_lib.PopArtState] = None


def make_optimizer(cfg: PPOConfig) -> optax.GradientTransformation:
    steps = []
    if cfg.max_grad_norm is not None and cfg.max_grad_norm > 0:
        steps.append(optax.clip_by_global_norm(cfg.max_grad_norm))
    steps.append(optax.adam(cfg.lr, eps=cfg.eps))
    return optax.chain(*steps)


def smooth_l1(pred, target):
    d = jnp.abs(pred - target)
    return jnp.where(d < 1.0, 0.5 * d ** 2, d - 0.5)


def make_ppo_update(
    model,
    cfg: PPOConfig,
    num_actors: int,
    critic_head_path: Tuple[str, ...] = ('critic_head',),
) -> Callable:
    """Build the jittable update(train_state, rollout, returns, init_carry,
    rng, discard_grad) → (train_state, stats) function."""

    tx = make_optimizer(cfg)
    recurrent = model.is_recurrent
    is_discrete = model.dist_type == 'categorical'

    def loss_fn(params, ts_popart, obs, init_carry, masks_pre, actions,
                old_log_probs, old_values, returns, advs):
        if recurrent:
            fwd = lambda p, o, c, m: model.apply(p, o, c, m,
                                                 method='sequence')
        else:
            fwd = lambda p, o, c, m: model.apply(p, o, c, m)
        if cfg.remat:
            fwd = jax.checkpoint(fwd)
        out, values, _ = fwd(params, obs, init_carry, masks_pre)

        new_log_probs, entropy = model.log_prob_entropy(out, actions)

        ratio = jnp.exp(new_log_probs - old_log_probs)
        surr1 = ratio * advs
        surr2 = jnp.clip(
            ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * advs
        action_loss = -jnp.minimum(surr1, surr2).mean()

        if cfg.use_popart:
            returns = popart_lib.normalize(ts_popart, returns)

        if cfg.clip_value_loss:
            clipped = old_values + jnp.clip(
                values - old_values, -cfg.clip_param, cfg.clip_param)
            vloss = 0.5 * jnp.maximum(
                (values - returns) ** 2, (clipped - returns) ** 2).mean()
        else:
            vloss = smooth_l1(values, returns).mean()

        loss = (vloss * cfg.value_loss_coef + action_loss
                - entropy * cfg.entropy_coef)
        return loss, (vloss, action_loss, entropy)

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    def get_head(params):
        node = params
        for k in critic_head_path:
            node = node[k]
        return node

    def set_head(params, kernel, bias):
        # params are nested dicts; rebuild the path immutably.
        def rec(node, path):
            if not path:
                return {**node, 'kernel': kernel, 'bias': bias}
            k = path[0]
            return {**node, k: rec(node[k], path[1:])}
        return rec(params, list(critic_head_path))

    def update(train_state: AgentTrainState, rollout, returns, init_carry,
               rng, discard_grad):
        """rollout fields are (T, N, ...); returns (T, N)."""
        T, N = rollout.rewards.shape
        old_values = rollout.values
        if cfg.use_popart:
            adv_values = popart_lib.denormalize(train_state.popart, old_values)
        else:
            adv_values = old_values
        advantages = returns - adv_values
        advantages = (advantages - advantages.mean()) / (
            advantages.std() + 1e-5)

        discard = jnp.asarray(discard_grad)

        if recurrent:
            assert N % cfg.num_mini_batch == 0, (N, cfg.num_mini_batch)
            envs_per_mb = N // cfg.num_mini_batch
            perms = jax.vmap(
                lambda r: jax.random.permutation(r, N)
            )(jax.random.split(rng, cfg.ppo_epoch))
            mb_idx = perms.reshape(
                cfg.ppo_epoch * cfg.num_mini_batch, envs_per_mb)

            def mb_step(carry, idx):
                params, opt_state, ts_popart = carry
                mb_obs = jax.tree.map(lambda x: x[:, idx], rollout.obs)
                mb_carry = jax.tree.map(lambda x: x[idx], init_carry)
                mb_masks = rollout.masks_pre[:, idx]
                mb_ret = returns[:, idx]

                if cfg.use_popart:
                    head = get_head(params['params'])
                    ts_popart, k, b = popart_lib.update(
                        ts_popart, mb_ret, head['kernel'], head['bias'])
                    params = {**params,
                              'params': set_head(params['params'], k, b)}

                (loss, aux), grads = grad_fn(
                    params, ts_popart, mb_obs, mb_carry, mb_masks,
                    rollout.actions[:, idx], rollout.log_probs[:, idx],
                    old_values[:, idx], mb_ret, advantages[:, idx])
                updates, new_opt = tx.update(grads, opt_state, params)
                new_params = optax.apply_updates(params, updates)
                gnorm = optax.global_norm(grads)
                params = jax.tree.map(
                    lambda n, o: jnp.where(discard, o, n), new_params, params)
                opt_state = jax.tree.map(
                    lambda n, o: jnp.where(discard, o, n), new_opt, opt_state)
                return (params, opt_state, ts_popart), (aux, gnorm)

            (params, opt_state, new_popart), (auxes, gnorms) = jax.lax.scan(
                mb_step,
                (train_state.params, train_state.opt_state,
                 train_state.popart),
                mb_idx)
        else:
            batch = T * N
            assert batch % cfg.num_mini_batch == 0
            mb_size = batch // cfg.num_mini_batch
            flat = lambda x: x.reshape(batch, *x.shape[2:])
            f_obs = jax.tree.map(flat, rollout.obs)
            f_act = flat(rollout.actions)
            f_lp = flat(rollout.log_probs)
            f_val = flat(old_values)
            f_ret = flat(returns)
            f_adv = flat(advantages)
            f_masks = flat(rollout.masks_pre)
            perms = jax.vmap(
                lambda r: jax.random.permutation(r, batch)
            )(jax.random.split(rng, cfg.ppo_epoch))
            mb_idx = perms.reshape(
                cfg.ppo_epoch * cfg.num_mini_batch, mb_size)

            def mb_step(carry, idx):
                params, opt_state, ts_popart = carry
                mb_obs = jax.tree.map(lambda x: x[idx], f_obs)
                mb_ret = f_ret[idx]
                mb_carry = jax.tree.map(
                    lambda x: jnp.zeros((mb_size, *x.shape[1:]), x.dtype),
                    init_carry)
                if cfg.use_popart:
                    head = get_head(params['params'])
                    ts_popart, k, b = popart_lib.update(
                        ts_popart, mb_ret, head['kernel'], head['bias'])
                    params = {**params,
                              'params': set_head(params['params'], k, b)}
                (loss, aux), grads = grad_fn(
                    params, ts_popart, mb_obs, mb_carry, f_masks[idx],
                    f_act[idx], f_lp[idx], f_val[idx], mb_ret, f_adv[idx])
                updates, new_opt = tx.update(grads, opt_state, params)
                new_params = optax.apply_updates(params, updates)
                gnorm = optax.global_norm(grads)
                params = jax.tree.map(
                    lambda n, o: jnp.where(discard, o, n), new_params, params)
                opt_state = jax.tree.map(
                    lambda n, o: jnp.where(discard, o, n), new_opt, opt_state)
                return (params, opt_state, ts_popart), (aux, gnorm)

            (params, opt_state, new_popart), (auxes, gnorms) = jax.lax.scan(
                mb_step,
                (train_state.params, train_state.opt_state,
                 train_state.popart),
                mb_idx)

        vlosses, alosses, entropies = auxes
        stats = {
            'value_loss': vlosses.mean(),
            'action_loss': alosses.mean(),
            'dist_entropy': entropies.mean(),
            'grad_norm': gnorms.mean(),
        }
        new_state = AgentTrainState(
            params=params, opt_state=opt_state, popart=new_popart)
        return new_state, stats

    return update


def init_agent_state(
    model, cfg: PPOConfig, rng, example_obs, batch_size: int
) -> AgentTrainState:
    """Initialize params/optimizer for a model given one example obs batch."""
    carry = model.initial_carry((batch_size,))
    mask = jnp.ones((batch_size,), jnp.float32)
    params = model.init(rng, example_obs, carry, mask)
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)
    pa = popart_lib.PopArtState.create() if cfg.use_popart else None
    return AgentTrainState(params=params, opt_state=opt_state, popart=pa)
