"""CLI config surface.

Mirrors reference arguments.py flag-for-flag (same names, same defaults) so
the reference's grid configs (train_scripts/grid_configs/*.json) drive this
framework unchanged.  A few accelerator-specific flags are added at the
bottom.
"""

import argparse


def str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ('yes', 'true', 't', 'y', '1')


# (dest, type, default) — transcription of the reference parser's surface.
_FLAGS = [
    # PPO / optimization
    ('algo', str, 'ppo'),
    ('lr', float, 1e-4),
    ('eps', float, 1e-5),
    ('alpha', float, 0.99),
    ('gamma', float, 0.995),
    ('use_gae', str2bool, True),
    ('gae_lambda', float, 0.95),
    ('entropy_coef', float, 0.0),
    ('adv_entropy_coef', float, 0.0),
    ('value_loss_coef', float, 0.5),
    ('max_grad_norm', float, 0.5),
    ('adv_max_grad_norm', float, 0.5),
    ('normalize_returns', str2bool, False),
    ('adv_normalize_returns', str2bool, False),
    ('use_popart', str2bool, False),
    ('adv_use_popart', str2bool, False),
    ('seed', int, 1),
    ('num_processes', int, 32),
    ('num_steps', int, 256),
    ('ppo_epoch', int, 5),
    ('adv_ppo_epoch', int, 5),
    ('num_mini_batch', int, 1),
    ('adv_num_mini_batch', int, 1),
    ('clip_param', float, 0.2),
    ('clip_value_loss', str2bool, True),
    ('clip_reward', float, None),
    ('adv_clip_reward', float, None),
    ('num_env_steps', int, 500000),
    # model
    ('recurrent_arch', str, 'lstm'),
    ('recurrent_agent', str2bool, True),
    ('recurrent_adversary_env', str2bool, False),
    ('recurrent_hidden_size', int, 256),
    # UED
    ('ued_algo', str, 'paired'),
    ('protagonist_plr', str2bool, False),
    ('antagonist_plr', str2bool, False),
    ('use_reset_random_dr', str2bool, False),
    # PLR
    ('use_plr', str2bool, False),
    ('level_replay_strategy', str, 'value_l1'),
    ('level_replay_eps', float, 0.05),
    ('level_replay_score_transform', str, 'rank'),
    ('level_replay_temperature', float, 0.1),
    ('level_replay_schedule', str, 'proportionate'),
    ('level_replay_rho', float, 1.0),
    ('level_replay_prob', float, 0.0),
    ('level_replay_alpha', float, 1.0),
    ('staleness_coef', float, 0.3),
    ('staleness_transform', str, 'power'),
    ('staleness_temperature', float, 1.0),
    ('train_full_distribution', str2bool, True),
    ('level_replay_seed_buffer_size', int, 4000),
    ('level_replay_seed_buffer_priority', str, 'replay_support'),
    ('reject_unsolvable_seeds', str2bool, False),
    ('no_exploratory_grad_updates', str2bool, False),
    # ACCEL
    ('use_editor', str2bool, False),
    ('level_editor_prob', float, 0.0),
    ('level_editor_method', str, 'random'),
    ('base_levels', str, 'batch'),
    ('num_edits', int, 0),
    # fine-tuning / logging / checkpointing
    ('xpid_finetune', str, None),
    ('model_finetune', str, 'model'),
    ('no_cuda', str2bool, False),
    ('xpid', str, 'latest'),
    ('log_dir', str, '~/logs/dcd/'),
    ('log_interval', int, 1),
    ('checkpoint_interval', int, 100),
    ('archive_interval', int, 0),
    ('checkpoint_basis', str, 'num_updates'),
    ('weight_log_interval', int, 0),
    ('screenshot_interval', int, 5000),
    ('screenshot_batch_size', int, 1),
    ('render', str2bool, False),
    ('checkpoint', str2bool, False),
    ('disable_checkpoint', str2bool, False),
    ('log_grad_norm', str2bool, False),
    ('log_action_complexity', str2bool, False),
    ('log_replay_complexity', str2bool, False),
    ('log_plr_buffer_stats', str2bool, False),
    ('verbose', str2bool, False),
    # evaluation
    ('test_interval', int, 250),
    ('test_num_episodes', int, 10),
    ('test_num_processes', int, 2),
    ('test_env_names', str,
     'MultiGrid-SixteenRooms-v0,MultiGrid-Labyrinth-v0,MultiGrid-Maze-v0'),
    # environment
    ('env_name', str, 'MultiGrid-GoalLastAdversarial-v0'),
    ('handle_timelimits', str2bool, False),
    ('singleton_env', str2bool, False),
    ('use_global_critic', str2bool, False),
    ('use_global_policy', str2bool, False),
    # CarRacing
    ('grayscale', str2bool, False),
    ('crop_frame', str2bool, False),
    ('reward_shaping', str2bool, False),
    ('num_action_repeat', int, 1),
    ('frame_stack', int, 1),
    ('num_control_points', int, 12),
    ('min_rad_ratio', float, 0.333333333),
    ('max_rad_ratio', float, 1.0),
    ('use_skip', str2bool, False),
    ('choose_start_pos', str2bool, False),
    ('use_sketch', str2bool, True),
    ('use_categorical_adv', str2bool, False),
    ('sparse_rewards', str2bool, False),
    ('num_goal_bins', int, 1),
    # --- accelerator additions ------------------------------------------
    # The accelerator-side defaults below (bf16, rollout unroll, fusion off)
    # were chosen on the earlier (pre-GPU) build and are not yet measured on the
    # H100 (ROADMAP C3).
    # bfloat16 model compute. Default None = auto: bf16 on accelerator
    # backends, f32 on CPU (tests/dryrun keep exact f32 numerics).
    # train.py, bench.py and eval.py all resolve this the same way.
    ('bf16', str2bool, None),
    # vmap both PAIRED students' rollout+update into one program.  Default
    # off: at large N the doubled live activations pushed XLA into remat and
    # the fused cycle lost, and its cold compile is ~2x slower.  It may
    # still win at small N — it remains available as a flag.
    ('fuse_paired', str2bool, False),
    # vmap ONLY the two students' rollouts (not their PPO updates) into one
    # 2N-batch scan. Unlike the full fusion this does not double the live
    # activations of the update backward (the r3 regression), it just halves
    # the rollout scan's launch count and doubles per-step matmul batch.
    ('fuse_paired_rollouts', str2bool, False),
    # K update cycles per compiled dispatch (runner.run_batched): amortizes
    # the per-cycle host round trip that binds small-N production configs.
    # 1 = the sequential
    # reference-shaped loop. Logging stays per-cycle; eval/weight-log/
    # screenshot cadences snap to dispatch boundaries (intervals should be
    # multiples of K to avoid extra recompiles).
    ('cycles_per_dispatch', int, 1),
    # lax.scan unroll for the rollout step loop. Default None = auto:
    # 4 on accelerator backends, 1 on CPU (keeps test-suite compiles
    # small). Numerically identical either way.
    ('rollout_unroll', int, None),
    ('mesh_shape', str, ''),            # e.g. "dp:4" / "dp:2,tp:2"
    ('profile_dir', str, ''),           # jax.profiler trace output
    ('multihost', str2bool, False),     # jax.distributed.initialize()
    # jax.distributed coordinates: a GPU host group needs all three
    # (jax.distributed.initialize() finds no cluster on its own there)
    ('coordinator_address', str, ''),
    ('num_hosts', int, 0),
    ('host_idx', int, -1),
    ('debug_nans', str2bool, False),    # dev-mode NaN checking (SURVEY §5.2)
]


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='dcd_isaac_tpu')
    for dest, typ, default in _FLAGS:
        kwargs = dict(type=typ, default=default)
        if typ is str2bool:
            kwargs.update(nargs='?', const=True)
        parser.add_argument(f'--{dest}', **kwargs)
    return parser


parser = make_parser()


def defaults() -> argparse.Namespace:
    return parser.parse_args([])
