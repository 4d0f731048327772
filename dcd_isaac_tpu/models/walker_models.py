"""BipedalWalker actor-critic networks.

Parity with reference models/walker_models.py: student = MLPBase twin 64-64
tanh trunks → DiagGaussian over 4 motor torques (state-independent log-std,
zero-init); teacher = MLP on concat(level-params, random_z, time_step) →
DiagGaussian(1) whose sampled action is tanh-squashed with the log-prob
evaluated at the squashed value (walker_models.py:236-239 — reproduced
exactly, including that quirk).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from . import nn
from .common import RNNCore, rnn_initial_carry
from .distributions import normal_entropy, normal_log_prob, normal_sample
from .nn import Scope, ortho, zeros


def diag_gaussian_head(s: Scope, x, num_outputs: int):
    """Mean layer ``mean`` + state-independent ``log_std`` (zero-init)."""
    mean = nn.dense(s.child('mean'), x, num_outputs, kernel_init=ortho(1.0))
    log_std = s.param('log_std', zeros, (num_outputs,))
    return {'mean': mean, 'log_std': jnp.broadcast_to(log_std, mean.shape)}


def twin_trunks(s: Scope, x, hidden: int):
    """Two-layer tanh actor and critic trunks (actor1/2, critic1/2)."""
    d = lambda name, v: jnp.tanh(nn.dense(
        s.child(name), v, hidden, kernel_init=ortho(jnp.sqrt(2))))
    return d('actor2', d('actor1', x)), d('critic2', d('critic1', x))


def walker_heads(s: Scope, ha, hc, action_dim: int):
    value = nn.dense(s.child('critic_head'), hc, 1,
                     kernel_init=ortho(1.0)).squeeze(-1)
    return diag_gaussian_head(s.child('dist'), ha, action_dim), value


@dataclasses.dataclass(frozen=True)
class WalkerStudentPolicy(nn.Module):
    """MLPBase + DiagGaussian (walker_models.py:113-167)."""
    action_dim: int = 4
    hidden_size: int = 64
    recurrent_arch: Optional[str] = None   # optional 'gru'

    dist_type = 'normal'
    squash_tanh = False

    @property
    def core(self) -> RNNCore:
        return RNNCore(self.hidden_size, self.recurrent_arch or 'none')

    @property
    def is_recurrent(self):
        return self.recurrent_arch in ('lstm', 'gru')

    def initial_carry(self, batch_dims):
        return rnn_initial_carry(
            self.recurrent_arch or 'none', self.hidden_size, batch_dims)

    def __call__(self, s: Scope, obs, carry, mask):
        x = obs if not isinstance(obs, dict) else obs['obs']
        if self.is_recurrent:
            carry, x = self.core(s.child('core'), carry, x, mask)
        ha, hc = twin_trunks(s, x, self.hidden_size)
        dist, value = walker_heads(s, ha, hc, self.action_dim)
        return dist, value, carry

    def sequence(self, s: Scope, obs, carry, masks):
        x = obs if not isinstance(obs, dict) else obs['obs']
        if self.is_recurrent:
            carry, x = self.core.sequence(s.child('core'), carry, x, masks)
        ha, hc = twin_trunks(s, x, self.hidden_size)
        dist, value = walker_heads(s, ha, hc, self.action_dim)
        return dist, value, carry

    # --- distribution protocol (pure; safe unbound) --------------------
    def sample_action(self, rng, out):
        a = normal_sample(rng, out['mean'], out['log_std'])
        if self.squash_tanh:
            a = jnp.tanh(a)
        lp = normal_log_prob(out['mean'], out['log_std'], a)
        return a, lp

    def log_prob_entropy(self, out, actions):
        lp = normal_log_prob(out['mean'], out['log_std'], actions)
        ent = normal_entropy(out['log_std']).mean()
        return lp, ent

    def deterministic_action(self, out):
        return out['mean']


@dataclasses.dataclass(frozen=True)
class WalkerAdversaryPolicy(nn.Module):
    """Teacher MLP (walker_models.py:170-256); tanh-squashed design actions."""
    design_dim: int = 8
    random_z_dim: int = 10
    action_dim: int = 1
    hidden_size: int = 64

    dist_type = 'normal'
    squash_tanh = True
    recurrent_arch = None

    @property
    def is_recurrent(self):
        return False

    def initial_carry(self, batch_dims):
        return ()

    def _embed(self, obs):
        return jnp.concatenate([
            obs['image'].astype(jnp.float32),
            obs['random_z'],
            obs['time_step'].astype(jnp.float32)[..., None],
        ], axis=-1)

    def __call__(self, s: Scope, obs, carry, mask):
        ha, hc = twin_trunks(s, self._embed(obs), self.hidden_size)
        dist, value = walker_heads(s, ha, hc, self.action_dim)
        return dist, value, carry

    def sequence(self, s: Scope, obs, carry, masks):
        return self(s, obs, carry, masks)

    def sample_action(self, rng, out):
        a = jnp.tanh(normal_sample(rng, out['mean'], out['log_std']))
        # log-prob evaluated at the squashed action (reference quirk,
        # walker_models.py:236-239)
        lp = normal_log_prob(out['mean'], out['log_std'], a)
        return a, lp

    def log_prob_entropy(self, out, actions):
        lp = normal_log_prob(out['mean'], out['log_std'], actions)
        ent = normal_entropy(out['log_std']).mean()
        return lp, ent

    def deterministic_action(self, out):
        return jnp.tanh(out['mean'])


def make_walker_model(args, env, agent_type: str):
    if agent_type == 'adversary_env':
        return WalkerAdversaryPolicy(
            design_dim=env.adversary_obs_shapes['image'][0],
            random_z_dim=env.adversary_obs_shapes['random_z'][0])
    recurrent = args.recurrent_arch if args.recurrent_agent and \
        args.recurrent_arch == 'gru' else None
    return WalkerStudentPolicy(
        action_dim=4, recurrent_arch=recurrent)
