"""MultiGrid actor-critic networks.

Architecture parity with reference models/multigrid_models.py:15-186:
Conv(k3, VALID) on the (scaled) grid image → flatten → ReLU, concat one-hot
scalar embedding (direction / time_step) and random_z, LSTM(256) core, twin
32-32 tanh MLP heads → Categorical(num_actions) logits / scalar value.

The student and the environment adversary ("teacher") share this class with
different hyperparameters (reference util/make_agent.py:15-58): student
conv_filters=16, scalar_dim=4, scalar_fc=5; teacher conv_filters=128,
scalar_dim=adversary_max_steps+1, scalar_fc=10, random_z_dim=50.

Image scaling (/10) replicates VecPreprocessImageWrapper
(envs/wrappers/obs_wrappers.py) — done in-model so raw uint8 obs flow
straight from the env engine without a host-side wrapper stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp

from . import nn
from .common import RNNCore, rnn_initial_carry
from .nn import Scope, ortho, xavier_uniform, zeros


@dataclasses.dataclass(frozen=True)
class MultigridNetwork(nn.Module):
    num_actions: int
    scalar_dim: int = 4
    scalar_fc: int = 5
    conv_filters: int = 16
    conv_kernel: int = 3
    random_z_dim: int = 0
    recurrent_arch: str = 'lstm'
    recurrent_hidden_size: int = 256
    actor_fc_layers: Sequence[int] = (32, 32)
    value_fc_layers: Sequence[int] = (32, 32)
    dtype: Any = jnp.float32    # compute dtype (--bf16); params stay f32

    dist_type = 'categorical'

    @property
    def core(self) -> RNNCore:
        return RNNCore(self.recurrent_hidden_size, self.recurrent_arch,
                       dtype=self.dtype)

    @property
    def is_recurrent(self) -> bool:
        return self.recurrent_arch in ('lstm', 'gru')

    def initial_carry(self, batch_dims: Tuple[int, ...]):
        return rnn_initial_carry(
            self.recurrent_arch, self.recurrent_hidden_size, batch_dims)

    def _scalar_embed(self, s: Scope, onehot):
        return nn.dense(s.child('scalar_embed'), onehot, self.scalar_fc,
                        dtype=self.dtype)

    def _embed(self, s: Scope, obs: dict) -> jnp.ndarray:
        img = obs['image'].astype(self.dtype) / 10.0
        k = self.conv_kernel
        x = nn.conv(s.child('image_conv'), img, self.conv_filters, (k, k),
                    kernel_init=xavier_uniform(), dtype=self.dtype)
        x = x.reshape(*x.shape[:-3], -1)
        x = jax.nn.relu(x)
        scalar = obs.get('direction', obs.get('time_step'))
        parts = [x]
        if scalar is not None and self.scalar_dim:
            onehot = jax.nn.one_hot(
                scalar.astype(jnp.int32), self.scalar_dim, dtype=self.dtype)
            parts.append(self._scalar_embed(s, onehot))
        if self.random_z_dim:
            parts.append(obs['random_z'].astype(self.dtype))
        return jnp.concatenate(parts, axis=-1)

    def _actor(self, s: Scope, core: jnp.ndarray):
        h = nn.mlp(s, core, self.actor_fc_layers, 'actor_fc', self.dtype)
        return nn.dense(s.child('actor_head'), h, self.num_actions,
                        kernel_init=ortho(0.01), dtype=self.dtype)

    def _critic(self, s: Scope, x: jnp.ndarray):
        h = nn.mlp(s, x, self.value_fc_layers, 'critic_fc', self.dtype)
        return nn.dense(s.child('critic_head'), h, 1,
                        kernel_init=ortho(1.0), dtype=self.dtype)

    def _heads(self, s: Scope, core: jnp.ndarray, obs: dict):
        # heads return float32 regardless of compute dtype (losses, action
        # sampling and GAE stay full-precision)
        logits = self._actor(s, core).astype(jnp.float32)
        value = self._critic(s, core).squeeze(-1).astype(jnp.float32)
        return logits, value

    def __call__(self, s: Scope, obs: dict, carry, mask: jnp.ndarray):
        """Single batched step: obs (B, ...), mask (B,) → (logits, value, carry)."""
        x = self._embed(s, obs)
        carry, core = self.core(s.child('core'), carry, x, mask)
        logits, value = self._heads(s, core, obs)
        return logits, value, carry

    def _core_sequence(self, s: Scope, obs: dict, carry, masks: jnp.ndarray):
        """(T, B, …) obs → (final_carry, (T, B, H) core outputs).

        LSTM: the input projection is hoisted out of the time scan — the
        embed + x@W_in runs as a few giant checkpointed chunk matmuls over
        (chunk·B) (never materializing the full (T·B, embed) activation;
        e.g. 13·13·128 = 21k dims for the teacher), and the scan body
        reduces to the (H, 4H) recurrence.  GRU keeps the per-step remat
        scan.
        """
        T = masks.shape[0]
        img_shape = obs['image'].shape
        embed_dim = ((img_shape[-3] - self.conv_kernel + 1)
                     * (img_shape[-2] - self.conv_kernel + 1)
                     * self.conv_filters)
        core_s = s.child('core')
        # Hoist the input projection only when the embedding is wide enough
        # that per-step x@W_in matmuls dominate (the 21k-dim teacher); for
        # narrow embeds (student, 149-dim) the per-step remat scan is
        # cheaper than materializing the (T, B, 4H) zx residual.
        if self.recurrent_arch == 'lstm' and embed_dim >= 4096:
            Wi = self.core.lstm_input_kernel(core_s)

            # chunk size: largest divisor of T bounding the transient
            # (chunk·B·embed_dim) activation to ~0.5 GB (a budget not yet
            # re-measured against device memory on the GPU)
            B = img_shape[1]
            budget = int(5e8 // max(B * embed_dim * 4, 1)) or 1
            chunk = 1
            for c in range(1, T + 1):
                if T % c == 0 and c <= budget:
                    chunk = c

            def zx_chunk(o):
                # The (21k, 4H) projection is the teacher update's largest
                # matmul.  Under --bf16 it runs in bf16 on both passes:
                # casting the OUTPUT back to f32 makes the backward matmuls
                # consume bf16 cotangents too, so forward and backward all
                # take the bf16 matrix path with f32 accumulation.  The
                # precision follows the model compute dtype — with --bf16
                # false the whole projection stays f32.
                emb = self._embed(s, o).astype(self.dtype)
                return (emb @ Wi.astype(self.dtype)).astype(jnp.float32)

            obs_c = jax.tree.map(
                lambda a: a.reshape(T // chunk, chunk, *a.shape[1:]), obs)
            zx = jax.lax.map(jax.checkpoint(zx_chunk), obs_c)
            zx = zx.reshape(T, B, -1)
            return self.core.sequence_zx(core_s, carry, zx, masks)

        def body(carry, inp):
            o, m = inp
            x = self._embed(s, o)
            return self.core(core_s, carry, x, m)

        return jax.lax.scan(
            jax.checkpoint(body, prevent_cse=False), carry, (obs, masks))

    def sequence(self, s: Scope, obs: dict, carry, masks: jnp.ndarray):
        """(T, B, ...) BPTT forward → (logits_T, values_T, final_carry)."""
        if not self.is_recurrent:
            x = self._embed(s, obs)
            carry, core = self.core.sequence(s.child('core'), carry, x, masks)
        else:
            carry, core = self._core_sequence(s, obs, carry, masks)
        logits, value = self._heads(s, core, obs)
        return logits, value, carry

    # --- distribution protocol (pure; safe unbound) ----------------------
    def sample_action(self, rng, logits):
        from .distributions import categorical_log_prob, categorical_sample
        a = categorical_sample(rng, logits)
        return a, categorical_log_prob(logits, a)

    def log_prob_entropy(self, logits, actions):
        from .distributions import categorical_entropy, categorical_log_prob
        return (categorical_log_prob(logits, actions),
                categorical_entropy(logits).mean())

    def deterministic_action(self, logits):
        from .distributions import categorical_mode
        return categorical_mode(logits)


@dataclasses.dataclass(frozen=True)
class MultigridGlobalCriticNetwork(MultigridNetwork):
    """Student with a full-grid critic trunk (reference
    multigrid_global_critic_models.py:15-223).

    ``use_global_policy=False``: policy sees the partial view (as
    MultigridNetwork), while the critic additionally receives a conv embed of
    the full-grid encoding ('full_obs', MultiGridFullyObsWrapper).
    ``use_global_policy=True``: both heads run on the global embed.
    """
    use_global_policy: bool = False

    def _global_embed(self, s: Scope, obs):
        g = obs['full_obs'].astype(self.dtype) / 10.0
        x = nn.conv(s.child('global_conv1'), g, 8, (2, 2), (2, 2),
                    kernel_init=xavier_uniform(), dtype=self.dtype)
        x = nn.conv(s.child('global_conv2'), x, 16, (3, 3),
                    kernel_init=xavier_uniform(), dtype=self.dtype)
        return x.reshape(*x.shape[:-3], -1)

    def _embed(self, s: Scope, obs):
        if self.use_global_policy:
            scalar = obs.get('direction')
            parts = [jax.nn.relu(self._global_embed(s, obs))]
            if scalar is not None and self.scalar_dim:
                onehot = jax.nn.one_hot(
                    scalar.astype(jnp.int32), self.scalar_dim)
                parts.append(self._scalar_embed(s, onehot))
            return jnp.concatenate(parts, axis=-1)
        return super()._embed(s, obs)

    def _heads(self, s: Scope, core, obs):
        logits = self._actor(s, core).astype(jnp.float32)
        if self.use_global_policy:
            critic_in = core
        else:
            critic_in = jnp.concatenate(
                [self._global_embed(s, obs), core], axis=-1)
        value = self._critic(s, critic_in).squeeze(-1).astype(jnp.float32)
        return logits, value
