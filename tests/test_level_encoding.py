"""Regression tests for the r4 walker device-fault root cause.

The fault: walker/carracing levels carry a terrain seed in a float32 lane.
Early round 4 BITCAST raw uint32 bits into that lane, so ~0.4% of seed
draws produced NaN/Inf bit patterns (and most of the rest decoded to
garbage magnitudes ~1e35). A NaN-seeded level entering the PLR buffer
poisons the replay path: NaN level params -> NaN terrain -> NaN physics ->
NaN loss, which surfaces as FloatingPointError on CPU and as a device
fault mid-program on the earlier accelerator build (reproduced at cycle
~255 of the r4 walker ACCEL campaign; RESULTS.md).

The fix (envs/seeds.py): draw seeds from [0, 2^24) and VALUE-cast them, so
every stored float is finite and round-trips losslessly. These tests pin
that contract on every producer of float-encoded levels.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcd_isaac_tpu.envs.seeds import (
    SEED_MAX, draw_seed, f32_to_seed, seed_to_f32)


class TestSeedCodec:
    def test_draw_seed_in_range(self):
        rngs = jax.random.split(jax.random.PRNGKey(0), 4096)
        seeds = jax.vmap(draw_seed)(rngs)
        s = np.asarray(seeds)
        assert s.dtype == np.uint32
        assert (s < SEED_MAX).all()

    def test_roundtrip_lossless_over_full_range(self):
        # every value in [0, 2^24) is exactly representable in float32
        vals = np.concatenate([
            np.arange(0, 1000, dtype=np.uint32),
            np.asarray([SEED_MAX - 1, SEED_MAX // 2, 1 << 23], np.uint32),
            np.random.RandomState(0).randint(
                0, SEED_MAX, size=10000).astype(np.uint32)])
        f = np.asarray(seed_to_f32(jnp.asarray(vals)))
        assert np.isfinite(f).all()
        back = np.asarray(f32_to_seed(jnp.asarray(f)))
        np.testing.assert_array_equal(back, vals)

    def test_bitcast_would_have_poisoned(self):
        # documents why the value cast matters: raw uint32 bit patterns
        # include NaN/Inf floats (the r4 bug class)
        bits = np.random.RandomState(1).randint(
            0, 2 ** 31 - 1, size=200000).astype(np.uint32)
        as_f = bits.view(np.float32)
        assert not np.isfinite(as_f).all()


class TestWalkerLevelsFinite:
    def _env(self):
        from dcd_isaac_tpu.envs.walker import AdversarialWalker, WalkerParams
        return AdversarialWalker(WalkerParams())

    def test_reset_random_levels_finite(self):
        env = self._env()
        rngs = jax.random.split(jax.random.PRNGKey(3), 512)
        states, _ = jax.vmap(env.reset_random)(rngs)
        levels = np.asarray(jax.vmap(env.get_level)(states))
        assert np.isfinite(levels).all()
        # seed lane value-cast contract
        assert (levels[:, 8] >= 0).all() and (levels[:, 8] < SEED_MAX).all()
        assert (levels[:, 8] == np.round(levels[:, 8])).all()

    def test_mutate_levels_finite(self):
        env = self._env()
        rngs = jax.random.split(jax.random.PRNGKey(4), 128)
        states, _ = jax.vmap(env.reset_random)(rngs)
        states, _ = jax.vmap(
            lambda s, r: env.mutate_level(s, r, 3))(
            states, jax.random.split(jax.random.PRNGKey(5), 128))
        levels = np.asarray(jax.vmap(env.get_level)(states))
        assert np.isfinite(levels).all()
        assert (levels[:, 8] < SEED_MAX).all()

    def test_reset_to_level_roundtrip_keeps_seed(self):
        env = self._env()
        state, _ = env.reset_random(jax.random.PRNGKey(6))
        level = env.get_level(state)
        state2, _ = env.reset_to_level(level)
        assert int(state2.level_seed) == int(state.level_seed)
        assert int(state.level_seed) < SEED_MAX

    def test_eval_level_builder_value_cast(self):
        # ADVICE r4 (high): build_walker_levels bitcast seeds while the env
        # decodes with a value cast -> eval terrain diversity collapsed
        from dcd_isaac_tpu.envs.walker.test_envs import build_walker_levels
        lv = build_walker_levels(
            'BipedalWalker-Med-Stairs-v0', np.random.RandomState(7), 256)
        assert np.isfinite(lv).all()
        seeds = lv[:, 8]
        assert (seeds < SEED_MAX).all()
        # diversity: value-cast seeds decode to themselves, all distinct-ish
        assert len(np.unique(seeds)) > 200
        # decoding matches numpy value cast exactly (lossless round trip)
        np.testing.assert_array_equal(
            np.asarray(f32_to_seed(jnp.asarray(seeds))),
            seeds.astype(np.uint32))


class TestCarRacingLevelsFinite:
    def test_reset_random_levels_finite(self):
        from dcd_isaac_tpu.envs.registry import make_env
        env = make_env('CarRacing-Bezier-Adversarial-v0')
        rngs = jax.random.split(jax.random.PRNGKey(8), 8)
        states, _ = jax.vmap(env.reset_random)(rngs)
        levels = np.asarray(jax.vmap(env.get_level)(states))
        assert np.isfinite(levels).all()
        assert (levels[:, -1] < SEED_MAX).all()


class TestCheckpointEncodingVersion:
    def test_stale_walker_checkpoint_fails_loudly(self, tmp_path):
        # pre-r4 checkpoints have no 'level_encoding' field; resuming a
        # walker run from one must raise instead of silently misdecoding
        from dcd_isaac_tpu.utils.checkpoint import load_checkpoint
        path = str(tmp_path / 'model.tar')
        with open(path, 'wb') as f:
            pickle.dump({'pytree': b'', 'host': {}}, f)
        os.environ.pop('DCD_ALLOW_STALE_LEVEL_ENCODING', None)
        with pytest.raises(ValueError, match='level-encoding'):
            load_checkpoint(
                path, None, env_name='BipedalWalker-Adversarial-Easy-v0')

    def test_versioned_checkpoint_loads(self, tmp_path):
        from dcd_isaac_tpu.utils.checkpoint import (
            load_checkpoint, save_checkpoint)
        tmpl = {'x': jnp.arange(3.0)}
        path = str(tmp_path / 'model.tar')
        save_checkpoint(path, tmpl, {'u': 1})
        state, host = load_checkpoint(
            path, {'x': jnp.zeros(3)},
            env_name='CarRacing-Bezier-Adversarial-v0')
        assert host == {'u': 1}
        np.testing.assert_array_equal(state['x'], [0.0, 1.0, 2.0])

    def test_multigrid_unaffected(self, tmp_path):
        # multigrid levels carry no float seed lane; checkpoints without
        # the level-encoding field load
        from dcd_isaac_tpu.utils.checkpoint import (
            CHECKPOINT_FORMAT, load_checkpoint)
        tmpl = {'x': jnp.zeros(3)}
        path = str(tmp_path / 'model.tar')
        with open(path, 'wb') as f:
            pickle.dump({'format': CHECKPOINT_FORMAT,
                         'state': {"['x']": np.ones(3, np.float32)},
                         'host': {}}, f)
        state, _ = load_checkpoint(
            path, tmpl, env_name='MultiGrid-GoalLastAdversarial-v0')
        np.testing.assert_array_equal(state['x'], np.ones(3))


if __name__ == '__main__':
    pytest.main([__file__, '-x', '-q'])
