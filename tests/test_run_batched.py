"""run_batched(K) ≡ K sequential run() calls.

The K-cycle dispatch moves the per-cycle host control points (replay
decision, ACCEL edit coin, easy-base selection) in-program; this must not
change the math. The replay decision uses the same fold_in key as run(),
and the edit coin comes from the same np.random stream — with
level_editor_prob=1.0 (the ACCEL campaign setting) the drawn values are
decision-irrelevant, so sequential and batched trajectories must agree to
float tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcd_isaac_tpu.arguments import parser
from dcd_isaac_tpu.envs.registry import make_env
from dcd_isaac_tpu.runner.adversarial_runner import AdversarialRunner
from dcd_isaac_tpu.utils.make_agent import make_all_models


def _make_runner(argv):
    args = parser.parse_args(argv)
    env = make_env(args.env_name, args=args)
    models = make_all_models(args, env)
    return AdversarialRunner(args, env, models, jax.random.PRNGKey(7))


ACCEL_ARGV = [
    '--env_name', 'MultiGrid-MiniAdversarial-v0',
    '--ued_algo', 'domain_randomization',
    '--use_plr', 'true',
    '--no_exploratory_grad_updates', 'true',
    '--use_editor', 'true',
    '--level_editor_prob', '1.0',
    '--num_edits', '2',
    '--base_levels', 'batch',
    '--num_processes', '8',
    '--num_steps', '56',
    '--ppo_epoch', '1',
    '--num_mini_batch', '1',
    '--level_replay_seed_buffer_size', '16',
    '--level_replay_prob', '0.95',
    '--level_replay_rho', '0.5',
    '--level_replay_strategy', 'positive_value_loss',
]

PAIRED_ARGV = [
    '--env_name', 'MultiGrid-MiniAdversarial-v0',
    '--ued_algo', 'paired',
    '--use_plr', 'true',
    '--num_processes', '8',
    '--num_steps', '56',
    '--ppo_epoch', '1',
    '--num_mini_batch', '1',
    '--level_replay_seed_buffer_size', '16',
    '--level_replay_prob', '0.95',
    '--recurrent_adversary_env', 'true',
]

WALKER_ACCEL_ARGV = [
    '--env_name', 'BipedalWalker-Adversarial-Easy-v0',
    '--ued_algo', 'domain_randomization',
    '--use_plr', 'true',
    '--use_editor', 'true',
    '--level_editor_prob', '1.0',
    '--base_levels', 'easy',
    '--normalize_returns', 'true',
    '--num_processes', '4',
    '--num_steps', '8',
    '--ppo_epoch', '1',
    '--num_mini_batch', '1',
    '--level_replay_seed_buffer_size', '8',
]

CR_ROBUST_PLR_ARGV = [
    '--env_name', 'CarRacing-Bezier-Adversarial-v0',
    '--ued_algo', 'domain_randomization',
    '--use_plr', 'true',
    '--no_exploratory_grad_updates', 'true',
    '--frame_stack', '4',
    '--num_action_repeat', '8',
    '--normalize_returns', 'true',
    '--num_processes', '2',
    '--num_steps', '4',
    '--ppo_epoch', '1',
    '--num_mini_batch', '1',
    '--level_replay_seed_buffer_size', '8',
]


@pytest.mark.parametrize(
    'argv', [ACCEL_ARGV, PAIRED_ARGV, WALKER_ACCEL_ARGV, CR_ROBUST_PLR_ARGV],
    ids=['accel', 'paired_plr', 'walker_accel', 'cr_robust_plr'])
def test_cycle_programs_keep_state_avals(argv):
    """Each cycle program returns the runner state with the shapes, dtypes
    and weak types it took; otherwise the second call of every program
    compiles it again."""
    r = _make_runner(argv)
    N = r.args.num_processes

    def avals(tree):
        return [(x.shape, x.dtype, x.weak_type) for x in jax.tree.leaves(tree)]

    want = avals(r.state)
    programs = {'generate': (r._build_cycle_generate(), ()),
                'multi': (r._build_cycle_multi(), (jnp.zeros((2,)),))}
    if r.use_plr:
        programs['replay'] = (r._build_cycle_replay(), ())
    if r.use_editor:
        programs['edit'] = (r._build_cycle_edit(),
                            (jnp.zeros((N,), jnp.int32),))
    for name, (fn, extra) in programs.items():
        out = jax.eval_shape(fn, r.state, *extra)[0]
        assert avals(out) == want, name


@pytest.mark.parametrize(
    'argv,k',
    [(ACCEL_ARGV, 5),
     pytest.param(PAIRED_ARGV, 3, marks=pytest.mark.slow)],
    ids=['accel', 'paired_plr'])
def test_batched_matches_sequential(argv, k):
    np.random.seed(123)
    r_seq = _make_runner(argv)
    seq_stats = [r_seq.run() for _ in range(k)]

    np.random.seed(123)
    r_bat = _make_runner(argv)
    bat_stats = r_bat.run_batched(k)

    assert len(bat_stats) == k
    for i, (a, b) in enumerate(zip(seq_stats, bat_stats)):
        assert set(a) == set(b), (
            f'cycle {i}: key mismatch {set(a) ^ set(b)}')
        for key in a:
            np.testing.assert_allclose(
                a[key], b[key], rtol=2e-4, atol=2e-5,
                err_msg=f'cycle {i}, stat {key}')

    # counters
    for attr in ('num_updates', 'total_num_edits', 'student_grad_updates',
                 'total_seeds_collected', 'total_episodes_collected'):
        assert getattr(r_seq, attr) == getattr(r_bat, attr), attr

    # final device state: params and PLR buffer
    pa = jax.tree.leaves(r_seq.state.agent.params)
    pb = jax.tree.leaves(r_bat.state.agent.params)
    for x, y in zip(pa, pb):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5)
    if r_seq.state.plr_agent is not None:
        np.testing.assert_allclose(
            r_seq.state.plr_agent.scores, r_bat.state.plr_agent.scores,
            rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(
            np.asarray(r_seq.state.plr_agent.unseen),
            np.asarray(r_bat.state.plr_agent.unseen))


@pytest.mark.slow
def test_batched_easy_base_runs():
    """base_levels=easy uses an in-program argsort (ties may legitimately
    differ from the host np.argsort) — check it runs and edits happen."""
    argv = list(ACCEL_ARGV)
    argv[argv.index('batch')] = 'easy'
    np.random.seed(0)
    r = _make_runner(argv)
    stats = r.run_batched(5)
    assert r.num_updates == 5
    assert r.total_num_edits >= 1
    assert all(np.isfinite(s['agent_value_loss']) for s in stats)
