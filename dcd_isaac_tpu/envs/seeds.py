"""Terrain/level seed handling for float32 level encodings.

Walker and CarRacing levels are dense float32 vectors whose last element
carries the uint32 terrain seed. Round 4 initially BITCAST the raw seed
bits into the float — but ~0.4% of uint32 draws are float32 NaN/Inf bit
patterns, which poisons the PLR level buffer (`--debug_nans` trips on
buffer contents, and XLA passes are free to canonicalize NaNs in
transit, silently corrupting the seed; a NaN-seed level in the walker
buffer coincided with a reproducible device fault at replay time,
RESULTS.md r4).

Instead, seeds are drawn from [0, 2^24) and stored with a plain value
cast — every value is exactly representable in float32, the round trip
is lossless, and the buffer contains only finite floats. 16.7M distinct
terrain seeds per parameter setting is far beyond what any training run
visits (the reference uses whatever python ints its RNG produces, but
level diversity comes overwhelmingly from the design parameters).
"""

import jax
import jax.numpy as jnp

SEED_MAX = 1 << 24   # exactly representable in float32


def draw_seed(rng: jax.Array) -> jnp.ndarray:
    """Fresh terrain seed: uint32 in [0, SEED_MAX)."""
    return jax.random.randint(rng, (), 0, SEED_MAX).astype(jnp.uint32)


def seed_to_f32(seed: jnp.ndarray) -> jnp.ndarray:
    """Lossless uint32→float32 for storage in a level vector."""
    return seed.astype(jnp.float32)


def f32_to_seed(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse of seed_to_f32."""
    return x.astype(jnp.uint32)
