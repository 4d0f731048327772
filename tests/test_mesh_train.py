"""Product multi-chip path: train.py --mesh_shape over the 8-device CPU mesh.

The mesh is wired into the product (train.py), not only a dry run.
conftest.py gives the CPU 8 devices, so these tests exercise real sharding
and XLA collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcd_isaac_tpu.parallel.mesh import (
    make_mesh_from_spec, parse_mesh_shape, place_runner_state,
)


class TestMeshSpec:
    def test_parse(self):
        assert parse_mesh_shape('dp:8') == (('dp',), (8,))
        assert parse_mesh_shape('dp:4,tp:2') == (('dp', 'tp'), (4, 2))

    def test_wildcard(self):
        names, sizes = parse_mesh_shape('dp:-1')
        assert names == ('dp',)
        assert sizes == (len(jax.devices()),)

    def test_make(self):
        mesh = make_mesh_from_spec('dp:8')
        assert mesh.shape == {'dp': 8}


class TestPlacement:
    def test_batch_leaves_sharded_params_replicated(self):
        mesh = make_mesh_from_spec('dp:8')
        N = 16
        tree = {
            'env_batch': jnp.zeros((N, 5, 5, 3)),
            'rollout': jnp.zeros((7, N, 4)),       # (T, N, ...)
            'params': jnp.zeros((256, 256)),
            'rng': jax.random.PRNGKey(0),
        }
        placed = place_runner_state(tree, mesh, N)
        spec = {k: v.sharding.spec for k, v in placed.items()}
        assert spec['env_batch'] == jax.sharding.PartitionSpec('dp')
        assert spec['rollout'] == jax.sharding.PartitionSpec(None, 'dp')
        assert spec['params'] == jax.sharding.PartitionSpec()
        assert spec['rng'] == jax.sharding.PartitionSpec()


class TestMeshTrain:
    def test_train_paired_plr_on_mesh(self, tmp_path):
        """Full PAIRED+PLR training over dp:8 must run and learn-ish."""
        from dcd_isaac_tpu.train import main
        r = main([
            '--env_name', 'MultiGrid-MiniAdversarial-v0',
            '--ued_algo', 'paired', '--use_plr', 'true',
            '--mesh_shape', 'dp:8',
            '--num_processes', '16', '--num_steps', '16',
            '--num_env_steps', str(16 * 16 * 3),
            '--ppo_epoch', '1', '--num_mini_batch', '1',
            '--level_replay_seed_buffer_size', '16',
            '--test_interval', '0', '--test_env_names', '',
            '--log_dir', str(tmp_path), '--xpid', 't_mesh'])
        assert r.mesh is not None
        assert r.num_updates == 3
        # params replicated on all 8 devices
        leaf = jax.tree.leaves(r.state.agent.params)[0]
        assert len(leaf.sharding.device_set) == 8
        assert leaf.sharding.is_fully_replicated
        # the state keeps its placement, so each program compiled once
        assert {k: f._cache_size() for k, f in r._jit_cache.items()} == {
            k: 1 for k in r._jit_cache}

    def test_mesh_matches_single_device_numerics(self, tmp_path):
        """The sharded program computes the same update as unsharded
        (same seed, same cycle count) within float tolerance."""
        from dcd_isaac_tpu.train import main
        argv = [
            '--env_name', 'MultiGrid-MiniAdversarial-v0',
            '--ued_algo', 'domain_randomization',
            '--num_processes', '8', '--num_steps', '8',
            '--num_env_steps', str(8 * 8 * 2),
            '--ppo_epoch', '1', '--num_mini_batch', '1',
            '--test_interval', '0', '--test_env_names', '',
            '--log_dir', str(tmp_path), '--seed', '3']
        r1 = main(argv + ['--xpid', 't_nomesh'])
        r2 = main(argv + ['--xpid', 't_withmesh', '--mesh_shape', 'dp:8'])
        p1 = jax.tree.leaves(r1.state.agent.params)
        p2 = jax.tree.leaves(r2.state.agent.params)
        for a, b in zip(p1, p2):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-4)

    def test_indivisible_num_processes_rejected(self, tmp_path):
        from dcd_isaac_tpu.train import main
        with pytest.raises(AssertionError):
            main([
                '--env_name', 'MultiGrid-MiniAdversarial-v0',
                '--ued_algo', 'domain_randomization',
                '--mesh_shape', 'dp:8',
                '--num_processes', '12', '--num_steps', '8',
                '--num_env_steps', '96',
                '--log_dir', str(tmp_path), '--xpid', 't_bad'])


if __name__ == '__main__':
    pytest.main([__file__, '-x', '-q'])
