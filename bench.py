"""Throughput benchmark: env-steps/s on MultiGrid PAIRED (the headline
metric; BASELINE.md north star).

Runs full DCD PAIRED cycles (teacher construction scan + student +
antagonist rollouts + 3 PPO updates) on the default adversarial env
(15x15, n_clutter=50) and reports student+antagonist env-steps/s.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "bf16",
"device", "compile_s", "peak_bytes_in_use"}. ``vs_baseline`` is measured
against the reference architecture's subprocess ceiling (~1e3 env-steps/s;
SURVEY.md §6). ``device`` names what JAX ran on (platform, device_kind,
count). The full-size run needs a GPU and fails without one; ``--quick`` is
the small CPU rehearsal, labelled with whatever platform it ran on.
"""

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--quick', action='store_true',
                    help='small config for smoke runs')
    ap.add_argument('--num_processes', type=int, default=None)
    ap.add_argument('--num_steps', type=int, default=None)
    ap.add_argument('--cycles', type=int, default=None)
    ap.add_argument('--mesh_shape', type=str, default='',
                    help="shard the benchmark over a mesh, e.g. 'dp:8'")
    # precision follows the product default: --bf16 auto = bf16 on an
    # accelerator, f32 on CPU (arguments.py). The resolved mode is emitted
    # in the JSON line.
    ap.add_argument('--bf16', type=str, default='auto')
    ap.add_argument('--fuse_paired', type=str, default='false')
    ap.add_argument('--fuse_paired_rollouts', type=str, default='false')
    ap.add_argument('--rollout_unroll', type=str, default='auto')
    args_cli = ap.parse_args()

    import jax

    from dcd_isaac_tpu.utils.compile_cache import enable_persistent_cache
    from dcd_isaac_tpu.utils.device import device_summary, peak_bytes_in_use
    enable_persistent_cache()

    device = device_summary()
    if not args_cli.quick and device['platform'] != 'gpu':
        raise SystemExit(
            f"bench.py: the full-size run needs a GPU, JAX found "
            f"{device['platform']!r}; use --quick for a CPU rehearsal")

    from dcd_isaac_tpu.arguments import parser
    from dcd_isaac_tpu.envs.registry import make_env
    from dcd_isaac_tpu.runner.adversarial_runner import AdversarialRunner
    from dcd_isaac_tpu.utils.make_agent import make_all_models

    if args_cli.quick:
        N, T, cycles, env_name = 64, 64, 3, 'MultiGrid-MiniAdversarial-v0'
    else:
        # N=8192 was the batch size picked on the earlier pre-GPU build; it is
        # not yet swept on the H100 (ROADMAP A2). T=256 matches the
        # reference rollout length.
        N, T, cycles, env_name = 8192, 256, 3, 'MultiGrid-Adversarial-v0'
    N = args_cli.num_processes or N
    T = args_cli.num_steps or T
    cycles = args_cli.cycles or cycles

    argv = [
        '--env_name', env_name,
        '--ued_algo', 'paired',
        '--num_processes', str(N),
        '--num_steps', str(T),
        '--ppo_epoch', '5',
        '--num_mini_batch', '1',
        '--recurrent_adversary_env', 'true',
        # handle_timelimits off: the reference's multigrid configs
        # (mg_25b_*.json) do not use proper-time-limit bootstrapping
        '--fuse_paired', args_cli.fuse_paired,
        '--fuse_paired_rollouts', args_cli.fuse_paired_rollouts,
    ]
    if args_cli.rollout_unroll != 'auto':
        argv += ['--rollout_unroll', args_cli.rollout_unroll]
    if args_cli.bf16 != 'auto':
        argv += ['--bf16', args_cli.bf16]
    args = parser.parse_args(argv)

    env = make_env(args.env_name)
    models = make_all_models(args, env)
    runner = AdversarialRunner(args, env, models, jax.random.PRNGKey(0))

    if args_cli.mesh_shape:
        from dcd_isaac_tpu.parallel.mesh import make_mesh_from_spec
        runner.attach_mesh(make_mesh_from_spec(args_cli.mesh_shape))

    # warmup / compile (two cycles: the runner-state pytree must be warm)
    t0 = time.perf_counter()
    runner.run()
    runner.run()
    jax.block_until_ready(runner.state.agent.params)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(cycles):
        runner.run()
    jax.block_until_ready(runner.state.agent.params)
    dt = time.perf_counter() - t0

    # student + antagonist env steps per cycle (teacher construction steps
    # excluded, matching the reference sps definition, train.py:184-186)
    env_steps = 2 * N * T * cycles
    sps = env_steps / dt

    baseline_sps = 1000.0  # reference subprocess architecture (SURVEY.md §6)
    from dcd_isaac_tpu.utils.make_agent import resolve_bf16
    print(json.dumps({
        'metric': 'env_steps_per_sec_multigrid_paired',
        'value': round(sps, 1),
        'unit': 'steps/s',
        'vs_baseline': round(sps / baseline_sps, 2),
        # precision mode actually measured: comparisons across runs are
        # self-describing
        'bf16': resolve_bf16(args),
        'device': device,
        # the two warm-up cycles, compilation included
        'compile_s': round(compile_s, 2),
        'peak_bytes_in_use': peak_bytes_in_use(),
    }))


if __name__ == '__main__':
    main()
