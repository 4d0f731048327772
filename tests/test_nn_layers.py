"""The plain-JAX layer library (models/nn.py) and the networks built on it.

Layers and whole networks are checked against float64 numpy references
(tests/reference_nets.py); parameter trees are checked path by path against
the names and shapes the networks have always had (the PopArt head surgery,
the hoisted LSTM input projection and old param dumps read them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import reference_nets as ref
from dcd_isaac_tpu.arguments import parser
from dcd_isaac_tpu.envs.registry import make_env
from dcd_isaac_tpu.models import nn
from dcd_isaac_tpu.models.car_racing_models import (
    CarRacingAdversaryNetwork, CarRacingNetwork,
)
from dcd_isaac_tpu.models.common import RNNCore
from dcd_isaac_tpu.models.multigrid_models import MultigridNetwork
from dcd_isaac_tpu.models.walker_models import (
    WalkerAdversaryPolicy, WalkerStudentPolicy,
)
from dcd_isaac_tpu.utils.make_agent import make_all_models

F32_TOL = 1e-4     # f32 against float64 (CPU, or GPU at 'highest')
BF16_TOL = 5e-2    # bf16 compute: 8-bit mantissa, a few layers deep


def close(got, want, tol):
    got = np.asarray(jnp.asarray(got, jnp.float32), np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def init_params(fn, *args, seed=0):
    """Run a layer function in init mode → (params, output)."""
    params = {}
    out = fn(nn.Scope(params, jax.random.PRNGKey(seed)), *args)
    return params, out


def rnd(key, shape, scale=1.0):
    return scale * jax.random.normal(jax.random.PRNGKey(key), shape)


# --- layers ----------------------------------------------------------------
class TestLayers:
    def test_dense_matches_numpy(self):
        x = rnd(1, (3, 5, 7))
        p, y = init_params(lambda s, v: nn.dense(s, v, 4), x)
        assert p['kernel'].shape == (7, 4) and p['bias'].shape == (4,)
        close(y, ref.dense(ref.f64(p), np.asarray(x, np.float64)), F32_TOL)

    @pytest.mark.parametrize('dtype,x_dtype,want', [
        (None, jnp.float32, jnp.float32),
        (None, jnp.bfloat16, jnp.float32),     # promoted with f32 params
        (jnp.bfloat16, jnp.float32, jnp.bfloat16),
        (jnp.float32, jnp.bfloat16, jnp.float32),
    ])
    def test_dense_dtype_promotion(self, dtype, x_dtype, want):
        x = rnd(2, (4, 6)).astype(x_dtype)
        p, y = init_params(lambda s, v: nn.dense(s, v, 3, dtype=dtype), x)
        assert y.dtype == want
        assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(p))
        tol = BF16_TOL if jnp.bfloat16 in (dtype, x_dtype) else F32_TOL
        close(y, ref.dense(ref.f64(p), np.asarray(x, np.float64)), tol)

    @pytest.mark.parametrize('batch,stride,k', [
        ((2,), 1, 3), ((2, 3), 2, 3), ((), 2, 4)])
    def test_conv_valid_matches_numpy(self, batch, stride, k):
        x = rnd(3, (*batch, 11, 9, 5))
        p, y = init_params(lambda s, v: nn.conv(
            s, v, 6, (k, k), (stride, stride),
            kernel_init=nn.xavier_uniform(), bias_init=nn.constant(0.1)), x)
        assert p['kernel'].shape == (k, k, 5, 6)
        want = ref.conv(ref.f64(p), np.asarray(x, np.float64), stride)
        assert y.shape == want.shape
        close(y, want, F32_TOL)

    def test_conv_bf16_compute(self):
        x = rnd(4, (2, 7, 7, 3))
        p, y = init_params(lambda s, v: nn.conv(
            s, v, 8, (3, 3), dtype=jnp.bfloat16), x)
        assert y.dtype == jnp.bfloat16
        close(y, ref.conv(ref.f64(p), np.asarray(x, np.float64)), BF16_TOL)

    @pytest.mark.parametrize('arch', ['lstm', 'gru'])
    def test_cell_matches_numpy(self, arch):
        core = RNNCore(16, arch)
        x = rnd(5, (3, 10))
        carry = jax.tree.map(lambda c: rnd(6, c.shape, 0.5),
                             core.initial_carry((3,)))
        mask = jnp.array([1.0, 0.0, 1.0])
        p, (new_carry, out) = init_params(
            lambda s, *a: core(s, *a), carry, x, mask)
        names = ({'ii', 'if', 'ig', 'io', 'hi', 'hf', 'hg', 'ho'}
                 if arch == 'lstm' else {'ir', 'iz', 'in', 'hr', 'hz', 'hn'})
        assert set(p['cell']) == names
        want_carry, want_out = ref.rnn_step(
            arch, ref.f64(p['cell']), jax.tree.map(np.asarray, carry),
            np.asarray(x, np.float64), np.asarray(mask))
        close(out, want_out, F32_TOL)
        for a, b in zip(jax.tree.leaves(new_carry),
                        jax.tree.leaves(want_carry)):
            close(a, b, F32_TOL)

    def test_masked_step_equals_zero_carry(self):
        core = RNNCore(8, 'lstm')
        x = rnd(7, (2, 4))
        carry = jax.tree.map(lambda c: rnd(8, c.shape),
                             core.initial_carry((2,)))
        p, _ = init_params(lambda s, *a: core(s, *a), carry, x, jnp.ones(2))
        s = nn.Scope(p)
        _, masked = core(s, carry, x, jnp.zeros(2))
        _, fresh = core(s, core.initial_carry((2,)), x, jnp.ones(2))
        np.testing.assert_array_equal(masked, fresh)

    def test_lstm_bf16_keeps_f32_carry(self):
        core = RNNCore(8, 'lstm', dtype=jnp.bfloat16)
        carry = jax.tree.map(lambda c: c.astype(jnp.float32),
                             core.initial_carry((2,)))
        p, (c2, out) = init_params(
            lambda s, *a: core(s, *a), carry, rnd(9, (2, 4)), jnp.ones(2))
        assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(c2))
        assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(p))

    def test_sequence_zx_equals_step_scan(self):
        core = RNNCore(8, 'lstm')
        xs = rnd(10, (5, 3, 6))
        masks = jnp.array([[1, 1, 1], [1, 0, 1], [0, 1, 1],
                           [1, 1, 0], [1, 1, 1]], jnp.float32)
        carry = core.initial_carry((3,))
        p, _ = init_params(lambda s, *a: core(s, *a), carry, xs[0], masks[0])
        s = nn.Scope(p)
        c1, h1 = core.sequence(s, carry, xs, masks)
        zx = xs @ core.lstm_input_kernel(s)
        c2, h2 = core.sequence_zx(s, carry, zx, masks)
        close(h2, np.asarray(h1, np.float64), 1e-5)

    def test_apply_reads_without_creating(self):
        with pytest.raises(KeyError, match='kernel'):
            nn.dense(nn.Scope({}), jnp.ones((1, 2)), 3)

    def test_init_drops_unused_scopes(self):
        m = MultigridNetwork(num_actions=3, recurrent_arch=None)
        obs = {'image': jnp.zeros((2, 5, 5, 3)),
               'direction': jnp.zeros((2,), jnp.int32)}
        params = m.init(jax.random.PRNGKey(0), obs, (), jnp.ones(2))
        assert 'core' not in params['params']

    def test_init_is_seeded(self):
        m = WalkerStudentPolicy()
        obs = jnp.ones((2, 24))
        a = m.init(jax.random.PRNGKey(3), obs, (), jnp.ones(2))
        b = m.init(jax.random.PRNGKey(3), obs, (), jnp.ones(2))
        c = m.init(jax.random.PRNGKey(4), obs, (), jnp.ones(2))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)
        assert not np.array_equal(a['params']['actor1']['kernel'],
                                  c['params']['actor1']['kernel'])


# --- whole networks against the numpy reference -----------------------------
B = 3


def network_case(name, dtype=jnp.float32):
    """→ (model, params, call args, numpy reference outputs, method).
    Inits are jitted: eager, on a GPU, every primitive compiles on its own."""
    k = iter(range(100, 200))
    if name in ('mg_student', 'mg_student_gru'):
        arch = 'gru' if name.endswith('gru') else 'lstm'
        model = MultigridNetwork(num_actions=7, recurrent_arch=arch,
                                 dtype=dtype)
        obs = {'image': jax.random.randint(
                   jax.random.PRNGKey(next(k)), (B, 5, 5, 3), 0, 11),
               'direction': jnp.array([0, 3, 1])}
        carry = jax.tree.map(lambda c: rnd(next(k), c.shape, 0.5),
                             model.initial_carry((B,)))
        mask = jnp.array([1.0, 0.0, 1.0])
        params = jax.jit(model.init)(jax.random.PRNGKey(next(k)), obs, carry, mask)
        p = ref.f64(params['params'])
        want = ref.multigrid(
            p, {kk: np.asarray(v, np.float64) for kk, v in obs.items()},
            jax.tree.map(np.asarray, carry), np.asarray(mask),
            scalar_dim=4, arch=arch)
        return model, params, (obs, carry, mask), want, '__call__'
    if name == 'mg_teacher_sequence':
        model = MultigridNetwork(num_actions=169, conv_filters=128,
                                 scalar_fc=10, scalar_dim=53,
                                 random_z_dim=50, dtype=dtype)
        T = 3
        obs = {'image': jax.random.randint(
                   jax.random.PRNGKey(next(k)), (T, B, 15, 15, 3), 0, 11),
               'time_step': jnp.arange(T * B).reshape(T, B) % 53,
               'random_z': jax.random.uniform(
                   jax.random.PRNGKey(next(k)), (T, B, 50))}
        carry = jax.tree.map(lambda c: rnd(next(k), c.shape, 0.5),
                             model.initial_carry((B,)))
        masks = jnp.array([[1, 1, 1], [1, 0, 1], [0, 1, 1]], jnp.float32)
        obs0 = jax.tree.map(lambda v: v[0], obs)
        params = jax.jit(model.init)(jax.random.PRNGKey(next(k)), obs0, carry,
                            masks[0])
        want = ref.multigrid_sequence(
            ref.f64(params['params']),
            {kk: np.asarray(v, np.float64) for kk, v in obs.items()},
            jax.tree.map(np.asarray, carry), np.asarray(masks),
            scalar_dim=53)
        return model, params, (obs, carry, masks), want, 'sequence'
    if name in ('walker_student', 'walker_teacher'):
        if name == 'walker_student':
            model = WalkerStudentPolicy()
            obs = rnd(next(k), (B, 24))
            x = np.asarray(obs, np.float64)
        else:
            model = WalkerAdversaryPolicy(design_dim=8, random_z_dim=10)
            obs = {'image': rnd(next(k), (B, 8)),
                   'random_z': jax.random.uniform(
                       jax.random.PRNGKey(next(k)), (B, 10)),
                   'time_step': jnp.array([0, 2, 5])}
            x = np.concatenate([np.asarray(obs['image'], np.float64),
                                np.asarray(obs['random_z'], np.float64),
                                np.asarray(obs['time_step'],
                                           np.float64)[:, None]], -1)
        params = jax.jit(model.init)(jax.random.PRNGKey(next(k)), obs, (),
                            jnp.ones(B))
        # log_std is zero at init: give it values so the head is exercised
        params['params']['dist']['log_std'] = rnd(
            next(k), params['params']['dist']['log_std'].shape, 0.3)
        want = ref.walker(ref.f64(params['params']), x)
        return model, params, (obs, (), jnp.ones(B)), want, '__call__'
    if name == 'cr_student':
        model = CarRacingNetwork(dtype=dtype)
        obs = jax.random.uniform(jax.random.PRNGKey(next(k)),
                                 (B, 96, 96, 12), minval=-1, maxval=1)
        params = jax.jit(model.init)(jax.random.PRNGKey(next(k)), obs, (),
                            jnp.ones(B))
        want = ref.carracing(ref.f64(params['params']),
                             np.asarray(obs, np.float64))
        return model, params, (obs, (), jnp.ones(B)), want, '__call__'
    if name == 'cr_teacher':
        model = CarRacingAdversaryNetwork()
        obs = {'image': (jax.random.uniform(
                   jax.random.PRNGKey(next(k)), (B, 10, 10, 1)) > 0.7
               ).astype(jnp.float32),
               'time_step': jnp.array([0, 4, 12]),
               'random_z': jax.random.uniform(
                   jax.random.PRNGKey(next(k)), (B, 4))}
        params = jax.jit(model.init)(jax.random.PRNGKey(next(k)), obs, (),
                            jnp.ones(B))
        want = ref.carracing_teacher(
            ref.f64(params['params']),
            {kk: np.asarray(v, np.float64) for kk, v in obs.items()}, 13)
        return model, params, (obs, (), jnp.ones(B)), want, '__call__'
    raise ValueError(name)


NETWORKS = ['mg_student', 'mg_student_gru', 'mg_teacher_sequence',
            'walker_student', 'walker_teacher', 'cr_student', 'cr_teacher']
BF16_NETWORKS = ['mg_student', 'mg_teacher_sequence', 'cr_student']


def network_outputs(out):
    """Flatten a (dist, value, carry) triple into comparable arrays."""
    dist, value, carry = out
    if isinstance(dist, dict):
        dist = [dist[k] for k in sorted(dist) if k != 'is_goal_step']
    else:
        dist = [dist]
    return [*dist, value, *jax.tree.leaves(carry)]


def reference_outputs(name, want):
    if name.startswith('mg'):
        logits, value, carry = want
        return [logits, value, *jax.tree.leaves(carry)]
    if name.startswith('walker'):
        mean, log_std, value = want
        return [log_std, mean, value]        # sorted dict keys, then value
    alpha, beta, value = want
    return [alpha, beta, value]


def check_network(name, dtype, tol):
    model, params, args, want, method = network_case(name, dtype)
    got = network_outputs(jax.jit(
        lambda p, *a: model.apply(p, *a, method=method))(params, *args))
    want = reference_outputs(name, want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, tol)


@pytest.mark.parametrize('name', NETWORKS)
def test_network_f32_matches_numpy(name):
    check_network(name, jnp.float32, F32_TOL)


@pytest.mark.parametrize('name', BF16_NETWORKS)
def test_network_bf16_matches_numpy(name):
    check_network(name, jnp.bfloat16, BF16_TOL)


# --- parameter trees per family and role --------------------------------------
def _dense(name, i, o, bias=True):
    t = {f'{name}/kernel': (i, o)}
    if bias:
        t[f'{name}/bias'] = (o,)
    return t


def _mg_tree(n_act, embed, conv_f, scalar_in, scalar_out, arch='lstm',
             critic_in=256, image=True):
    t = {}
    for head in ('actor', 'critic'):
        t.update(_dense(f'{head}_fc0', critic_in if head == 'critic'
                        else 256, 32))
        t.update(_dense(f'{head}_fc1', 32, 32))
    t.update(_dense('actor_head', 32, n_act))
    t.update(_dense('critic_head', 32, 1))
    if image:
        t.update({'image_conv/kernel': (3, 3, 3, conv_f),
                  'image_conv/bias': (conv_f,)})
    t.update(_dense('scalar_embed', scalar_in, scalar_out))
    gates = ('i', 'f', 'g', 'o') if arch == 'lstm' else ('r', 'z', 'n')
    for g in gates:
        t.update(_dense(f'core/cell/i{g}', embed, 256, bias=arch == 'gru'))
        t.update(_dense(f'core/cell/h{g}', 256, 256,
                        bias=arch == 'lstm' or g == 'n'))
    return t


def _walker_tree(obs_dim, act_dim, gru=False):
    t = {'dist/log_std': (act_dim,)}
    t.update(_dense('dist/mean', 64, act_dim))
    trunk_in = 64 if gru else obs_dim
    for name in ('actor', 'critic'):
        t.update(_dense(f'{name}1', trunk_in, 64))
        t.update(_dense(f'{name}2', 64, 64))
    t.update(_dense('critic_head', 64, 1))
    if gru:
        for g in ('r', 'z', 'n'):
            t.update(_dense(f'core/cell/i{g}', obs_dim, 64))
            t.update(_dense(f'core/cell/h{g}', 64, 64, bias=g == 'n'))
    return t


def _cr_tree():
    t = {}
    specs = [(4, 3, 8), (3, 8, 16), (3, 16, 32), (3, 32, 64), (3, 64, 128),
             (3, 128, 256)]
    for i, (k, c, f) in enumerate(specs):
        t.update({f'conv{i}/kernel': (k, k, c, f), f'conv{i}/bias': (f,)})
    t.update(_dense('actor_fc', 256, 100))
    t.update(_dense('critic_fc', 256, 100))
    t.update(_dense('fc_alpha', 100, 3))
    t.update(_dense('fc_beta', 100, 3))
    t.update(_dense('critic_head', 100, 1))
    return t


def _cr_teacher_tree(embed, ts_dim, categorical=False):
    t = {'conv1/kernel': (2, 2, 1, 8), 'conv1/bias': (8,),
         'conv2/kernel': (2, 2, 8, 16), 'conv2/bias': (16,)}
    t.update(_dense('ts_embedding', ts_dim, 8))
    t.update(_dense('critic_head', embed, 1))
    if categorical:
        t.update(_dense('actor_fc', embed, 256))
        t.update(_dense('actor_head', 256, 101))
        t.update(_dense('goal_embedding', 2, 8))
        t.update(_dense('goal_fc', embed, 256))
        t.update(_dense('goal_head', 256, 1))
    else:
        t.update(_dense('fc_alpha', embed, 3))
        t.update(_dense('fc_beta', embed, 3))
    return t


MG = 'MultiGrid-GoalLastFewerBlocksAdversarial-v0'
MINI = 'MultiGrid-MiniAdversarial-v0'
TREES = {
    'mg_paired': (
        ['--env_name', MG, '--ued_algo', 'paired',
         '--recurrent_adversary_env', 'true'],
        {'agent': _mg_tree(7, 149, 16, 4, 5),
         'adversary_agent': _mg_tree(7, 149, 16, 4, 5),
         'adversary_env': _mg_tree(169, 21692, 128, 28, 10)}),
    'mg_gru': (
        ['--env_name', MINI, '--ued_algo', 'paired', '--recurrent_arch',
         'gru', '--recurrent_adversary_env', 'true'],
        {'agent': _mg_tree(7, 149, 16, 4, 5, 'gru'),
         'adversary_agent': _mg_tree(7, 149, 16, 4, 5, 'gru'),
         'adversary_env': _mg_tree(16, 2108, 128, 10, 10, 'gru')}),
    'mg_global_critic': (
        ['--env_name', MINI, '--ued_algo', 'domain_randomization',
         '--use_global_critic', 'true'],
        {'agent': {**_mg_tree(7, 149, 16, 4, 5, critic_in=272),
                   'global_conv1/kernel': (2, 2, 3, 8),
                   'global_conv1/bias': (8,),
                   'global_conv2/kernel': (3, 3, 8, 16),
                   'global_conv2/bias': (16,)}}),
    'mg_global_policy': (
        ['--env_name', MINI, '--ued_algo', 'domain_randomization',
         '--use_global_policy', 'true'],
        {'agent': {**_mg_tree(7, 21, 16, 4, 5, image=False),
                   'global_conv1/kernel': (2, 2, 3, 8),
                   'global_conv1/bias': (8,),
                   'global_conv2/kernel': (3, 3, 8, 16),
                   'global_conv2/bias': (16,)}}),
    'walker_paired': (
        ['--env_name', 'BipedalWalker-Adversarial-v0', '--ued_algo',
         'paired', '--recurrent_agent', 'false'],
        {'agent': _walker_tree(24, 4), 'adversary_agent': _walker_tree(24, 4),
         'adversary_env': _walker_tree(19, 1)}),
    'walker_gru': (
        ['--env_name', 'BipedalWalker-Adversarial-v0', '--ued_algo',
         'domain_randomization', '--recurrent_arch', 'gru'],
        {'agent': _walker_tree(24, 4, gru=True)}),
    'cr_paired': (
        ['--env_name', 'CarRacing-Bezier-Adversarial-v0', '--ued_algo',
         'paired', '--recurrent_agent', 'false'],
        {'agent': _cr_tree(), 'adversary_agent': _cr_tree(),
         'adversary_env': _cr_teacher_tree(1036, 13)}),
    'cr_categorical_goal': (
        ['--env_name', 'CarRacing-Bezier-Adversarial-v0', '--ued_algo',
         'minimax', '--recurrent_agent', 'false', '--use_categorical_adv',
         'true', '--sparse_rewards', 'true', '--use_skip', 'true',
         '--choose_start_pos', 'true'],
        {'agent': _cr_tree(),
         'adversary_env': _cr_teacher_tree(1044, 15, categorical=True)}),
}


def param_shapes(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {'/'.join(k.key for k in path[1:]): tuple(v.shape)
            for path, v in flat}


@pytest.mark.parametrize('config', list(TREES))
def test_param_tree_paths_and_shapes(config):
    argv, want = TREES[config]
    args = parser.parse_args(argv + ['--num_processes', '2'])
    env = make_env(args.env_name, full_obs=bool(
        args.use_global_critic or args.use_global_policy), args=args)
    models = make_all_models(args, env)
    assert set(models) == set(want)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    for role, model in models.items():
        reset = env.reset if role == 'adversary_env' else env.reset_random
        # shapes only: traced, never compiled or run
        params = jax.eval_shape(
            lambda k: model.init(jax.random.PRNGKey(1), jax.vmap(reset)(k)[1],
                                 model.initial_carry((2,)), jnp.ones(2)),
            keys)
        assert param_shapes(params) == want[role], role
