"""Training driver (reference train.py:38-237).

``python -m dcd_isaac_tpu.train --env_name=... --ued_algo=...`` — builds the
env engine, models, runner and evaluator; runs the update loop with
logging / checkpointing / in-training zero-shot evaluation.
"""

from __future__ import annotations

import os
import sys
import time

import jax
import numpy as np

from .arguments import parser
from .envs.registry import make_env
from .runner.adversarial_runner import AdversarialRunner
from .runner.evaluation import Evaluator
from .utils.checkpoint import archive_path, load_checkpoint, save_checkpoint
from .utils.filewriter import FileWriter
from .utils.make_agent import make_all_models


def main(argv=None):
    args = parser.parse_args(argv)

    from .utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    # Multi-host: one SPMD program over several hosts (SURVEY.md §5.8).
    # Must run before any device use.
    if args.multihost:
        kw = {}
        if args.coordinator_address:
            kw = dict(coordinator_address=args.coordinator_address,
                      num_processes=args.num_hosts,
                      process_id=args.host_idx)
        jax.distributed.initialize(**kw)
    is_main = jax.process_index() == 0

    if args.debug_nans:
        jax.config.update('jax_debug_nans', True)

    env = make_env(
        args.env_name,
        full_obs=bool(args.use_global_critic or args.use_global_policy),
        args=args)
    models = make_all_models(args, env)
    rng = jax.random.PRNGKey(args.seed)

    runner = AdversarialRunner(args, env, models, rng)

    # SPMD scale-out over a device mesh (--mesh_shape dp:4): the env batch
    # shards over the devices, params replicate, XLA psums gradients.
    if args.mesh_shape:
        from .parallel.mesh import make_mesh_from_spec
        mesh = make_mesh_from_spec(args.mesh_shape)
        dp = mesh.shape.get('dp', 1)
        assert args.num_processes % max(dp, 1) == 0, (
            f'num_processes={args.num_processes} not divisible by dp={dp}')
        runner.attach_mesh(mesh)

    log_dir = os.path.expandvars(os.path.expanduser(args.log_dir))
    # single-writer discipline across hosts: only process 0 owns the
    # xpid dir; other hosts run the same SPMD program silently
    if is_main:
        filewriter = FileWriter(
            xpid=args.xpid, xp_args=vars(args), rootdir=log_dir)
    else:
        from .utils.filewriter import NullFileWriter
        filewriter = NullFileWriter()
    checkpoint_path = os.path.join(log_dir, args.xpid, 'model.tar')

    # resume (reference train.py:128-134)
    initial_update = 0
    if args.checkpoint and os.path.exists(checkpoint_path):
        runner.state, host = load_checkpoint(
            checkpoint_path, runner.state, env_name=args.env_name)
        runner.load_host_state_dict(host)
        if runner.mesh is not None:    # re-shard the restored state
            runner.attach_mesh(runner.mesh)
        initial_update = runner.num_updates
        print(f'Resumed from update {initial_update}', flush=True)
    elif args.xpid_finetune and not os.path.exists(checkpoint_path):
        # fine-tuning init (reference train.py:112-141): student agent
        # params + optimizer from the base run; everything else fresh
        from .utils.checkpoint import load_agent_finetune
        base_path = os.path.join(
            log_dir, args.xpid_finetune, f'{args.model_finetune}.tar')
        runner.state = runner.state.replace(
            agent=load_agent_finetune(base_path, runner.state.agent))
        if runner.mesh is not None:
            runner.attach_mesh(runner.mesh)
        print(f'Fine-tuning from {base_path}', flush=True)

    evaluator = None
    test_env_names = [e for e in args.test_env_names.split(',') if e]
    if test_env_names and args.test_interval > 0 and is_main:
        evaluator = Evaluator(
            test_env_names, num_episodes=args.test_num_episodes)

    num_updates = int(
        args.num_env_steps) // args.num_steps // args.num_processes

    last_logged_update = filewriter.latest_tick - 1

    if args.cycles_per_dispatch > 1:
        _run_batched_loop(
            args, runner, evaluator, filewriter, models, initial_update,
            num_updates, last_logged_update, is_main, test_env_names,
            checkpoint_path)
        _finalize(args, runner, evaluator, filewriter, models,
                  checkpoint_path)
        return runner

    # jax.profiler trace window: updates [2, 5) after compile warm-up
    # (the reference has no profiler at all, SURVEY §5.1)
    profile_dir = os.path.expanduser(args.profile_dir or '')
    prof_start = initial_update + 2
    prof_stop = min(prof_start + 3, num_updates)
    profiling = False

    timer = time.time()
    for j in range(initial_update, num_updates):
        if profile_dir and j == prof_start and prof_stop > prof_start:
            jax.profiler.start_trace(profile_dir)
            profiling = True
        t_cycle = time.perf_counter()
        stats = runner.run()
        stats['cycle_time_s'] = time.perf_counter() - t_cycle
        if profiling and j == prof_stop - 1:
            jax.block_until_ready(runner.state.agent.params)
            jax.profiler.stop_trace()
            profiling = False
            print(f'Profile written to {profile_dir}', flush=True)

        if evaluator is not None and args.test_interval > 0 and (
                (j % args.test_interval == 0) or j == num_updates - 1):
            test_stats = evaluator.evaluate(
                models['agent'], runner.state.agent.params,
                seed=args.seed + j)
            stats.update(test_stats)

        if j % args.log_interval == 0 and j > last_logged_update:
            now = time.time()
            sps = (args.num_processes * args.num_steps
                   * args.log_interval) / max(now - timer, 1e-9)
            timer = now
            stats['sps'] = sps
            stats['total_updates'] = j + 1
            filewriter.log(stats)
            if is_main:
                msg = (f"u{j + 1}/{num_updates} sps={sps:.0f} "
                       f"ret={stats.get('mean_agent_return', 0):.3f}")
                if 'solved_rate:' + (test_env_names[0] if test_env_names
                                     else '') in stats:
                    msg += (f" solve0="
                            f"{stats['solved_rate:' + test_env_names[0]]:.2f}")
                print(msg, flush=True)

        if args.use_plr and args.weight_log_interval > 0 and \
                j % args.weight_log_interval == 0:
            from .level_replay import plr as plr_lib
            w = np.asarray(plr_lib.sample_weights(
                runner.state.plr_agent, runner.plr_cfg))
            filewriter.log_level_weights(
                w, seeds=np.asarray(runner.state.plr_agent.slot_ids))

        if args.screenshot_interval > 0 and is_main and \
                j % args.screenshot_interval == 0 and runner.use_plr:
            import jax.numpy as _jnp
            from .utils.screenshots import save_level_screenshots
            buf = runner.state.plr_agent
            n_top = min(args.screenshot_batch_size * 4, 8)
            top = np.argsort(-np.asarray(buf.scores))[:n_top]
            save_level_screenshots(
                args.env_name, np.asarray(buf.levels[_jnp.asarray(top)]),
                os.path.join(filewriter.basepath, 'screenshots'),
                prefix=f'update{j}')

        checkpoint_basis = (
            runner.num_updates if args.checkpoint_basis == 'num_updates'
            else runner.student_grad_updates)
        if args.checkpoint and not args.disable_checkpoint and \
                args.checkpoint_interval > 0 and \
                checkpoint_basis % args.checkpoint_interval == 0:
            host = runner.host_state_dict()
            save_checkpoint(checkpoint_path, runner.state, host)
            if args.archive_interval > 0 and \
                    checkpoint_basis % args.archive_interval == 0:
                save_checkpoint(
                    archive_path(checkpoint_path, checkpoint_basis),
                    runner.state, host)

    _finalize(args, runner, evaluator, filewriter, models, checkpoint_path)
    return runner


def _finalize(args, runner, evaluator, filewriter, models, checkpoint_path):
    """Final checkpoint + eval (reference train.py / eval.py
    final_test_eval)."""
    if args.checkpoint and not args.disable_checkpoint:
        save_checkpoint(checkpoint_path, runner.state,
                        runner.host_state_dict())
    if evaluator is not None:
        final_stats = evaluator.evaluate(
            models['agent'], runner.state.agent.params, seed=args.seed)
        filewriter.log_final_test_eval(final_stats)
    filewriter.mark_completed()
    if jax.process_index() == 0:
        from .utils.device import device_report
        print(device_report(), flush=True)
        if runner.mesh is not None:
            from .parallel.mesh import placement_summary
            # {devices spanned: leaves}; a leaf on fewer devices than the
            # mesh holds sits whole on one of them
            print(f'mesh placement {placement_summary(runner.state)}',
                  flush=True)


def _run_batched_loop(args, runner, evaluator, filewriter, models,
                      initial_update, num_updates, last_logged_update,
                      is_main, test_env_names, checkpoint_path):
    """Update loop dispatching K compiled cycles at a time
    (--cycles_per_dispatch; runner.run_batched).

    Per-cycle rows still go to logs.csv with exact update indices.
    Boundary actions (in-training eval, level-weight log, screenshots)
    fire at the same update indices as the sequential loop but observe the
    state BEFORE that update instead of after it — a one-update skew, only
    visible in logging cadence, never in the training math. Checkpoints
    save at the first dispatch boundary past each interval multiple.
    """
    import jax.numpy as jnp

    from .level_replay import plr as plr_lib

    K = args.cycles_per_dispatch
    iv_ckpt = args.checkpoint_interval

    def basis():
        return (runner.num_updates if args.checkpoint_basis == 'num_updates'
                else runner.student_grad_updates)

    ckpt_bucket = basis() // iv_ckpt if iv_ckpt > 0 else 0
    arch_bucket = (basis() // args.archive_interval
                   if args.archive_interval > 0 else 0)
    profile_dir = os.path.expanduser(args.profile_dir or '')
    dispatch_idx = 0
    j = initial_update
    while j < num_updates:
        test_stats = None
        if evaluator is not None and args.test_interval > 0 and \
                j % args.test_interval == 0:
            test_stats = evaluator.evaluate(
                models['agent'], runner.state.agent.params,
                seed=args.seed + j)
        if args.use_plr and args.weight_log_interval > 0 and \
                j % args.weight_log_interval == 0:
            w = np.asarray(plr_lib.sample_weights(
                runner.state.plr_agent, runner.plr_cfg))
            filewriter.log_level_weights(
                w, seeds=np.asarray(runner.state.plr_agent.slot_ids))
        if args.screenshot_interval > 0 and is_main and \
                j % args.screenshot_interval == 0 and runner.use_plr:
            from .utils.screenshots import save_level_screenshots
            buf = runner.state.plr_agent
            n_top = min(args.screenshot_batch_size * 4, 8)
            top = np.argsort(-np.asarray(buf.scores))[:n_top]
            save_level_screenshots(
                args.env_name, np.asarray(buf.levels[jnp.asarray(top)]),
                os.path.join(filewriter.basepath, 'screenshots'),
                prefix=f'update{j}')

        # dispatch up to K cycles, stopping at the next boundary where an
        # exact-index action fires (constant size when intervals are
        # multiples of K — one compile)
        k_eff = min(K, num_updates - j)
        for iv in (args.test_interval, args.weight_log_interval,
                   args.screenshot_interval):
            if iv and iv > 0:
                k_eff = min(k_eff, ((j // iv) + 1) * iv - j)

        profiling = bool(profile_dir) and dispatch_idx == 1
        if profiling:
            jax.profiler.start_trace(profile_dir)
        t0 = time.perf_counter()
        stats_list = runner.run_batched(k_eff)
        if profiling:
            jax.block_until_ready(runner.state.agent.params)
            jax.profiler.stop_trace()
            print(f'Profile written to {profile_dir}', flush=True)
        dt = time.perf_counter() - t0
        dispatch_idx += 1

        # final-update eval (sequential loop's `j == num_updates - 1` arm,
        # see the sequential path above): merged into the final update's
        # row, exactly as the sequential loop does — observed params are
        # post-final-update (the dispatch completed before assembly)
        final_test_stats = None
        if evaluator is not None and args.test_interval > 0 and \
                j + k_eff >= num_updates and \
                (num_updates - 1) % args.test_interval != 0:
            final_test_stats = evaluator.evaluate(
                models['agent'], runner.state.agent.params,
                seed=args.seed + num_updates - 1)

        for i, stats in enumerate(stats_list):
            jj = j + i
            stats['cycle_time_s'] = dt / len(stats_list)
            if test_stats is not None and i == 0:
                stats.update(test_stats)
            if final_test_stats is not None and jj == num_updates - 1:
                stats.update(final_test_stats)
            if jj % args.log_interval == 0 and jj > last_logged_update:
                # throughput at dispatch granularity (all rows of one
                # dispatch share a single wall-clock measurement)
                sps = (args.num_processes * args.num_steps
                       * len(stats_list)) / max(dt, 1e-9)
                stats['sps'] = sps
                stats['total_updates'] = jj + 1
                filewriter.log(stats)
                if is_main:
                    msg = (f"u{jj + 1}/{num_updates} sps={sps:.0f} "
                           f"ret={stats.get('mean_agent_return', 0):.3f}")
                    key = 'solved_rate:' + (
                        test_env_names[0] if test_env_names else '')
                    if key in stats:
                        msg += f" solve0={stats[key]:.2f}"
                    print(msg, flush=True)
        j += k_eff

        if args.checkpoint and not args.disable_checkpoint and iv_ckpt > 0:
            b = basis()
            if b // iv_ckpt > ckpt_bucket:
                ckpt_bucket = b // iv_ckpt
                host = runner.host_state_dict()
                save_checkpoint(checkpoint_path, runner.state, host)
                if args.archive_interval > 0 and \
                        b // args.archive_interval > arch_bucket:
                    arch_bucket = b // args.archive_interval
                    # archive named at the interval boundary it crossed
                    # (the grad-update basis advances stochastically inside
                    # a dispatch, so the raw counter lands a few past the
                    # multiple — e.g. 20023; eval tooling expects
                    # model_20000.tar, and the sequential loop's exact
                    # `basis % interval == 0` check produces multiples too)
                    save_checkpoint(
                        archive_path(checkpoint_path,
                                     arch_bucket * args.archive_interval),
                        runner.state, host)



if __name__ == '__main__':
    main()
