"""Shared model components (plain JAX layers from ``models/nn.py``).

Re-designs reference models/common.py for JAX: the masked chunked-RNN forward
(reference RNN.forward's host-side zero-mask segmentation, common.py:142-209)
becomes a ``jax.lax.scan`` with per-step hidden-state mask resets — identical
math, no host control flow, works under jit/vmap/pjit.

Initialization parity with the reference:
  * conv layers: xavier-uniform (apply_init_, common.py:33-46)
  * hidden fc layers: orthogonal gain sqrt(2) + zero bias (init_tanh_)
  * value head: orthogonal gain 1 (init_)
  * policy head: orthogonal gain 0.01 (distributions.py:45-52)
  * RNN weights orthogonal, biases zero (common.py:128-133)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from . import nn
from .nn import Scope, ortho, zeros

Carry = Any


def rnn_initial_carry(arch: str, hidden_size: int,
                      batch_dims: Tuple[int, ...],
                      dtype=jnp.float32) -> Carry:
    """Zero carry for an RNN arch."""
    shape = (*batch_dims, hidden_size)
    if arch == 'lstm':
        return (jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))
    if arch == 'gru':
        return jnp.zeros(shape, dtype)
    return ()


@dataclasses.dataclass(frozen=True)
class RNNCore:
    """LSTM/GRU core with mask-reset semantics, or identity when arch=None.

    The carry is a pytree: LSTM → (c, h), GRU → h, none → ().  Hidden state is
    multiplied by ``mask`` (0 at episode starts) before every cell step, which
    reproduces the reference's zero-reset chunking exactly.  Methods take the
    core's own scope; the cell's parameters live under ``cell``.
    """
    hidden_size: int = 256
    arch: str = 'lstm'  # 'lstm' | 'gru' | 'none'
    dtype: Any = jnp.float32   # compute dtype (params stay float32)

    def __post_init__(self):
        if self.arch not in ('lstm', 'gru', None, 'none', ''):
            raise ValueError(f'Unsupported RNN arch {self.arch}')

    @property
    def is_recurrent(self) -> bool:
        return self.arch in ('lstm', 'gru')

    def initial_carry(self, batch_dims: Tuple[int, ...]) -> Carry:
        return rnn_initial_carry(
            self.arch, self.hidden_size, batch_dims, self.dtype)

    def _masked(self, carry: Carry, mask: jnp.ndarray) -> Carry:
        m = mask[..., None]
        return jax.tree.map(lambda c: (c * m.astype(c.dtype)), carry)

    def __call__(self, s: Scope, carry: Carry, x: jnp.ndarray,
                 mask: jnp.ndarray):
        """One step: (carry, (B, F) input, (B,) mask) → (carry, (B, H))."""
        if not self.is_recurrent:
            return carry, x
        carry = self._masked(carry, mask)
        cell = nn.lstm_cell if self.arch == 'lstm' else nn.gru_cell
        return cell(s.child('cell'), carry, x.astype(self.dtype),
                    kernel_init=ortho(1.0), recurrent_kernel_init=ortho(1.0),
                    bias_init=zeros, dtype=self.dtype)

    def sequence(self, s: Scope, carry: Carry, xs: jnp.ndarray,
                 masks: jnp.ndarray):
        """Scan over time: ((T, B, F), (T, B)) → (carry, (T, B, H))."""
        if not self.is_recurrent:
            return carry, xs
        return jax.lax.scan(
            lambda c, i: self(s, c, i[0], i[1]), carry, (xs, masks))

    # --- precomputed-input LSTM path (training-time BPTT) -----------------
    # The input projection x@W_in has no time dependence: hoisting it out of
    # the scan turns T sequential big matmuls (dominant for the teacher's
    # 21632-dim conv embedding) into one large batched matmul, leaving only
    # the small h@W_h recurrence inside the scan.
    def lstm_input_kernel(self, s: Scope) -> jnp.ndarray:
        """(F, 4H) input kernel assembled from the cell params (gate order
        i, f, g, o)."""
        assert self.arch == 'lstm'
        p = s.params['cell']
        return jnp.concatenate(
            [p[k]['kernel'] for k in ('ii', 'if', 'ig', 'io')],
            axis=1).astype(self.dtype)

    def sequence_zx(self, s: Scope, carry: Carry, zx: jnp.ndarray,
                    masks: jnp.ndarray):
        """LSTM scan over precomputed input projections.

        ``zx`` = xs @ lstm_input_kernel(), shape (T, B, 4H).  Exactly
        equivalent to ``sequence`` (same params, same math).
        """
        assert self.arch == 'lstm'
        p = s.params['cell']
        Wh = jnp.concatenate(
            [p[k]['kernel'] for k in ('hi', 'hf', 'hg', 'ho')],
            axis=1).astype(self.dtype)
        b = jnp.concatenate(
            [p[k]['bias'] for k in ('hi', 'hf', 'hg', 'ho')],
            axis=0).astype(self.dtype)
        H = self.hidden_size

        def step(carry, inp):
            zx_t, m = inp
            c, h = self._masked(carry, m)
            z = zx_t + h @ Wh + b
            i = jax.nn.sigmoid(z[..., :H])
            f = jax.nn.sigmoid(z[..., H:2 * H])
            g = jnp.tanh(z[..., 2 * H:3 * H])
            o = jax.nn.sigmoid(z[..., 3 * H:])
            c2 = f * c + i * g
            h2 = o * jnp.tanh(c2)
            return (c2, h2), h2

        return jax.lax.scan(step, carry, (zx.astype(self.dtype), masks))
