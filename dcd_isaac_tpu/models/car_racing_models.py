"""CarRacing actor-critic networks.

Parity with reference models/car_racing_models.py: student = 6-layer conv
stack on stacked 96×96 (or cropped 84×84) frames → 100-d fc → Beta(α, β)
policy per action dim with α,β = 1 + softplus(fc) (:18-165);
teacher = conv embed of the 10×10 sketch + time-step embedding + random_z →
Beta(x, y, skip) heads (+ optional PopArt critic) (:168-530).

``process_action`` maps Beta samples in [0,1] to the env action bounds
(steer ∈ [-1,1], gas/brake ∈ [0,1]) — folded into sample_action here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from . import nn
from .nn import Scope, constant, ortho, xavier_uniform
from .distributions import (
    beta_entropy, beta_log_prob, beta_mode, beta_sample,
)

relu_gain = float(np.sqrt(2))


@dataclasses.dataclass(frozen=True)
class CarRacingNetwork(nn.Module):
    """Student CNN + Beta policy (car_racing_models.py:18-165)."""
    action_dim: int = 3
    hidden_size: int = 100
    crop: bool = False
    # action bounds: steer [-1, 1], gas [0, 1], brake [0, 1]
    action_low: Tuple[float, ...] = (-1.0, 0.0, 0.0)
    action_high: Tuple[float, ...] = (1.0, 1.0, 1.0)
    dtype: Any = jnp.float32    # compute dtype (--bf16); params stay f32

    dist_type = 'beta'
    recurrent_arch = None

    @property
    def is_recurrent(self):
        return False

    def initial_carry(self, batch_dims):
        return ()

    def _dense(self, s: Scope, name, x, features, gain=relu_gain):
        return nn.dense(s.child(name), x, features, kernel_init=ortho(gain),
                        dtype=self.dtype)

    def _embed(self, s: Scope, obs):
        if self.crop:
            specs = [(8, 2, 2), (16, 2, 2), (32, 2, 2), (64, 2, 2),
                     (128, 3, 1), (256, 3, 1)]
        else:
            specs = [(8, 4, 2), (16, 3, 2), (32, 3, 2), (64, 3, 2),
                     (128, 3, 1), (256, 3, 1)]
        x = obs.astype(self.dtype)  # in [-1, 1] (wrapper preprocessing)
        for i, (f, k, st) in enumerate(specs):
            x = jax.nn.relu(nn.conv(
                s.child(f'conv{i}'), x, f, (k, k), (st, st),
                kernel_init=xavier_uniform(), bias_init=constant(0.1),
                dtype=self.dtype))
        return x.reshape(*x.shape[:-3], -1)

    def __call__(self, s: Scope, obs, carry, mask):
        x = self._embed(s, obs)
        ha = jax.nn.relu(self._dense(s, 'actor_fc', x, self.hidden_size))
        # Beta params and value in float32 (sampling/losses full-precision)
        alpha = 1.0 + jax.nn.softplus(self._dense(
            s, 'fc_alpha', ha, self.action_dim).astype(jnp.float32))
        beta = 1.0 + jax.nn.softplus(self._dense(
            s, 'fc_beta', ha, self.action_dim).astype(jnp.float32))
        hc = jax.nn.relu(self._dense(s, 'critic_fc', x, self.hidden_size))
        value = self._dense(s, 'critic_head', hc, 1, gain=1.0)
        value = value.squeeze(-1).astype(jnp.float32)
        return {'alpha': alpha, 'beta': beta}, value, carry

    def sequence(self, s: Scope, obs, carry, masks):
        return self(s, obs, carry, masks)

    # --- distribution protocol ------------------------------------------
    def sample_action(self, rng, out):
        u = beta_sample(rng, out['alpha'], out['beta'])
        lp = beta_log_prob(out['alpha'], out['beta'], u)
        low = jnp.asarray(self.action_low)
        high = jnp.asarray(self.action_high)
        # store the scaled action; log-prob refers to the raw Beta sample
        return u * (high - low) + low, lp

    def _unscale(self, actions):
        low = jnp.asarray(self.action_low)
        high = jnp.asarray(self.action_high)
        return (actions - low) / (high - low)

    def log_prob_entropy(self, out, actions):
        u = self._unscale(actions)
        lp = beta_log_prob(out['alpha'], out['beta'], u)
        ent = beta_entropy(out['alpha'], out['beta']).mean()
        return lp, ent

    def deterministic_action(self, out):
        u = beta_mode(out['alpha'], out['beta'])
        low = jnp.asarray(self.action_low)
        high = jnp.asarray(self.action_high)
        return u * (high - low) + low


@dataclasses.dataclass(frozen=True)
class CarRacingAdversaryNetwork(nn.Module):
    """Sketch teacher (car_racing_models.py:168-530).

    Variants: Beta(x, y, skip) heads (default) or a masked Categorical over
    the 10×10 sketch grid + skip (use_categorical, :288-296, :406-424);
    sparse-reward mode adds a goal-bin obs embedding and a Categorical
    goal-bin head used on the final design step (:263-276, :397-404).

    Action layout (stored): (x, y, skip) ∈ [0,1]^3, plus a trailing
    goal-bin slot in sparse mode.  The categorical variant stores the
    processed grid coordinates; the flat action index is reconstructed
    exactly in log_prob_entropy (grid snapping is lossless).
    """
    action_dim: int = 3           # x, y, skip
    time_step_dim: int = 13       # adversary_max_steps + 1
    random_z_dim: int = 4
    scalar_fc: int = 8
    sketch_dim: int = 10
    use_categorical: bool = False
    use_skip: bool = False
    use_goal: bool = False        # sparse_rewards
    num_goal_bins: int = 24
    set_start_pos: bool = False
    n_control_points: int = 12

    dist_type = 'beta'
    recurrent_arch = None

    @property
    def is_recurrent(self):
        return False

    @property
    def num_cells(self):
        return self.sketch_dim * self.sketch_dim

    def initial_carry(self, batch_dims):
        return ()

    def _embed(self, s: Scope, obs):
        x = obs['image']
        for name, f in (('conv1', 8), ('conv2', 16)):
            x = nn.conv(s.child(name), x, f, (2, 2),
                        kernel_init=xavier_uniform())
        x = jax.nn.relu(x.reshape(*x.shape[:-3], -1))
        ts = jax.nn.one_hot(
            obs['time_step'].astype(jnp.int32), self.time_step_dim)
        parts = [x, nn.dense(s.child('ts_embedding'), ts, self.scalar_fc),
                 obs['random_z']]
        if self.use_goal:
            gb = jax.nn.one_hot(
                obs['goal_bin'].astype(jnp.int32), self.num_goal_bins + 1)
            parts.append(
                nn.dense(s.child('goal_embedding'), gb, self.scalar_fc))
        return jnp.concatenate(parts, axis=-1)

    def _sketch_logits_mask(self, obs):
        """Invalid-action mask: occupied cells + conditional skip
        (reference _sketch_to_mask + act(), :326-332, :406-424).
        True = masked out."""
        sketch = obs['image'][..., 0]
        occupied = sketch.reshape(*sketch.shape[:-2], -1) > 0.5
        n_placed = occupied.sum(-1)
        t = obs['time_step'].astype(jnp.int32)
        if not self.use_skip:
            no_skip = jnp.ones_like(n_placed, bool)
        else:
            no_skip = n_placed < 3
            if self.set_start_pos:
                no_skip = no_skip | (t == self.n_control_points)
        return jnp.concatenate(
            [no_skip[..., None], occupied], axis=-1)

    def _is_goal_step(self, obs):
        t = obs['time_step'].astype(jnp.int32)
        return t == self.time_step_dim - 2  # last design step

    def __call__(self, s: Scope, obs, carry, mask):
        x = self._embed(s, obs)
        d = lambda name, v, f, gain=relu_gain: nn.dense(
            s.child(name), v, f, kernel_init=ortho(gain))
        out = {}
        if self.use_categorical:
            h = jax.nn.relu(d('actor_fc', x, 256))
            logits = d('actor_head', h, self.num_cells + 1, 1.0)
            amask = self._sketch_logits_mask(obs)
            out['logits'] = jnp.where(
                amask, jnp.finfo(logits.dtype).min, logits)
        else:
            out['alpha'] = 1.0 + jax.nn.softplus(
                d('fc_alpha', x, self.action_dim))
            out['beta'] = 1.0 + jax.nn.softplus(
                d('fc_beta', x, self.action_dim))
        if self.use_goal:
            h = jax.nn.relu(d('goal_fc', x, 256))
            out['goal_logits'] = d('goal_head', h, self.num_goal_bins, 1.0)
            out['is_goal_step'] = self._is_goal_step(obs)
        value = d('critic_head', x, 1, 1.0).squeeze(-1)
        return out, value, carry

    def sequence(self, s: Scope, obs, carry, masks):
        return self(s, obs, carry, masks)

    def _cells_to_xys(self, a):
        """Flat index (0 = skip, 1.. = cell) → processed (x, y, skip)
        (reference process_action, :305-316)."""
        d = self.sketch_dim
        x = ((a - 1) % d).astype(jnp.float32) / d
        y = ((a - 1) // d).astype(jnp.float32) / d
        skip = (a == 0).astype(jnp.float32)
        return jnp.stack([x, y, skip], axis=-1)

    def _xys_to_cells(self, actions):
        d = self.sketch_dim
        cell_x = jnp.round(actions[..., 0] * d).astype(jnp.int32)
        cell_y = jnp.round(actions[..., 1] * d).astype(jnp.int32)
        skip = actions[..., 2] > 0.5
        return jnp.where(skip, 0, 1 + cell_y * d + cell_x)

    def sample_action(self, rng, out):
        r_base, r_goal = jax.random.split(rng)
        if self.use_categorical:
            logd = jax.nn.log_softmax(out['logits'], axis=-1)
            a = jax.random.categorical(r_base, out['logits'], axis=-1)
            lp = jnp.take_along_axis(logd, a[..., None], -1).squeeze(-1)
            base = self._cells_to_xys(a)
        else:
            u = beta_sample(r_base, out['alpha'], out['beta'])
            lp = beta_log_prob(out['alpha'], out['beta'], u)
            base = u
        if not self.use_goal:
            return base, lp
        g_logd = jax.nn.log_softmax(out['goal_logits'], axis=-1)
        g = jax.random.categorical(r_goal, out['goal_logits'], axis=-1)
        g_lp = jnp.take_along_axis(g_logd, g[..., None], -1).squeeze(-1)
        action = jnp.concatenate(
            [base, g.astype(jnp.float32)[..., None]], axis=-1)
        return action, jnp.where(out['is_goal_step'], g_lp, lp)

    def random_action(self, rng, out):
        """Uniform design policy (act_random, :346-384): uniform [0,1]
        Beta samples / uniform non-skip cells, random goal bins."""
        r_base, r_goal = jax.random.split(rng)
        if self.use_categorical:
            shape = out['logits'].shape[:-1]
            a = jax.random.randint(
                r_base, shape, 1, self.num_cells + 1)
            base = self._cells_to_xys(a)
        else:
            base = jax.random.uniform(
                r_base, out['alpha'].shape)
        if not self.use_goal:
            return base
        g = jax.random.randint(
            r_goal, base.shape[:-1], 0, self.num_goal_bins)
        return jnp.concatenate(
            [base, g.astype(jnp.float32)[..., None]], axis=-1)

    def log_prob_entropy(self, out, actions):
        if self.use_categorical:
            logd = jax.nn.log_softmax(out['logits'], axis=-1)
            a = self._xys_to_cells(actions)
            lp = jnp.take_along_axis(logd, a[..., None], -1).squeeze(-1)
            p = jnp.exp(logd)
            ent = -(p * jnp.where(jnp.isfinite(logd), logd, 0.0)).sum(-1)
        else:
            lp = beta_log_prob(out['alpha'], out['beta'], actions[..., :3])
            ent = beta_entropy(out['alpha'], out['beta'])
        if not self.use_goal:
            return lp, ent.mean()
        g_logd = jax.nn.log_softmax(out['goal_logits'], axis=-1)
        g = jnp.round(actions[..., -1]).astype(jnp.int32)
        g_lp = jnp.take_along_axis(g_logd, g[..., None], -1).squeeze(-1)
        g_p = jnp.exp(g_logd)
        g_ent = -(g_p * g_logd).sum(-1)
        is_goal = out['is_goal_step']
        lp = jnp.where(is_goal, g_lp, lp)
        ent = jnp.where(is_goal, g_ent, ent)
        return lp, ent.mean()


def make_carracing_model(args, env, agent_type: str):
    if agent_type == 'adversary_env':
        sparse = getattr(args, 'sparse_rewards', False)
        return CarRacingAdversaryNetwork(
            action_dim=3,
            time_step_dim=env.adversary_rollout_steps + 1,
            random_z_dim=env.adversary_obs_shapes['random_z'][0],
            use_categorical=args.use_categorical_adv,
            use_skip=args.use_skip,
            use_goal=sparse,
            num_goal_bins=getattr(args, 'num_goal_bins', 24),
            set_start_pos=args.choose_start_pos,
            n_control_points=args.num_control_points)
    from ..utils.make_agent import resolve_bf16
    dtype = jnp.bfloat16 if resolve_bf16(args) else jnp.float32
    return CarRacingNetwork(crop=args.crop_frame, dtype=dtype)
