"""Per-phase timing of the PAIRED cycle on the current backend.

Times the teacher construction scan, student rollout, GAE+PLR scoring and
the PPO update as separately-jitted programs at bench shapes, to attribute
the cycle cost.  Run on the GPU (no JAX_PLATFORMS override) or on the CPU
with JAX_PLATFORMS=cpu.

    python tools/profile_phases.py [--num_processes N] [--num_steps T]
"""

import argparse
import time

import jax
import jax.numpy as jnp


def timeit(fn, *args, iters=3, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--num_processes', type=int, default=4096)
    ap.add_argument('--num_steps', type=int, default=256)
    ap.add_argument('--env_name', type=str, default='MultiGrid-Adversarial-v0')
    cli = ap.parse_args()
    N, T = cli.num_processes, cli.num_steps

    from dcd_isaac_tpu.arguments import parser
    from dcd_isaac_tpu.envs.registry import make_env
    from dcd_isaac_tpu.runner.adversarial_runner import AdversarialRunner
    from dcd_isaac_tpu.utils.make_agent import make_all_models

    args = parser.parse_args([
        '--env_name', cli.env_name,
        '--ued_algo', 'paired',
        '--num_processes', str(N),
        '--num_steps', str(T),
        '--ppo_epoch', '5',
        '--num_mini_batch', '1',
        '--recurrent_adversary_env', 'true',
        '--handle_timelimits', 'true',
    ])
    env = make_env(args.env_name)
    models = make_all_models(args, env)
    runner = AdversarialRunner(args, env, models, jax.random.PRNGKey(0))
    state = runner.state
    rng = jax.random.PRNGKey(1)

    # --- teacher construction scan ---------------------------------------
    @jax.jit
    def teacher(params, rng):
        env_states, adv_obs = jax.vmap(env.reset)(jax.random.split(rng, N))
        return runner.teacher_rollout_fn(params, env_states, adv_obs, rng)

    t_teacher = timeit(teacher, state.adversary_env.params, rng)
    env_states, t_ro, t_nv = teacher(state.adversary_env.params, rng)

    # --- student rollout (env scan + policy steps) ------------------------
    from dcd_isaac_tpu.algos.rollout import initial_step_carry

    @jax.jit
    def student_rollout(params, env_states, rng):
        es, obs = jax.vmap(env.reset_agent)(env_states)
        carry = initial_step_carry(
            env, models['agent'], es, obs, rng,
            level_seeds=jnp.full((N,), -1, jnp.int32))
        return runner._ro_same(params, carry)

    t_rollout = timeit(student_rollout, state.agent.params, env_states, rng)
    final, steps, next_value, ro_stats = student_rollout(
        state.agent.params, env_states, rng)

    # --- GAE ---------------------------------------------------------------
    from dcd_isaac_tpu.algos.storage import compute_gae

    @jax.jit
    def gae(steps, next_value):
        return compute_gae(steps, next_value, args.gamma, args.gae_lambda,
                           use_proper_time_limits=True)

    t_gae = timeit(gae, steps, next_value)
    returns = gae(steps, next_value)

    # --- PPO update (5 epochs) ---------------------------------------------
    @jax.jit
    def update(agent_state, steps, returns, rng):
        return runner.update_agent(
            agent_state, steps, returns,
            models['agent'].initial_carry((N,)), rng, False)

    t_update = timeit(update, state.agent, steps, returns, rng)

    # --- teacher PPO update (regret-replaced rewards) ------------------------
    t_ret = gae(t_ro, t_nv)

    @jax.jit
    def teacher_update(teacher_state, t_ro, t_ret, rng):
        return runner.update_teacher(
            teacher_state, t_ro, t_ret,
            models['adversary_env'].initial_carry((N,)), rng, False)

    t_tupd = timeit(teacher_update, state.adversary_env, t_ro, t_ret, rng)

    # --- full cycle --------------------------------------------------------
    runner.run()
    runner.run()
    t0 = time.perf_counter()
    runner.run()
    jax.block_until_ready(runner.state.agent.params)
    t_cycle = time.perf_counter() - t0

    total_attr = t_teacher + t_tupd + 2 * (t_rollout + t_gae + t_update)
    print(f'N={N} T={T} backend={jax.devices()[0].platform}')
    print(f'teacher scan        : {t_teacher*1e3:9.1f} ms')
    print(f'teacher PPO update  : {t_tupd*1e3:9.1f} ms')
    print(f'student rollout     : {t_rollout*1e3:9.1f} ms  (x2 agents)')
    print(f'GAE                 : {t_gae*1e3:9.1f} ms  (x2)')
    print(f'PPO update (5 ep)   : {t_update*1e3:9.1f} ms  (x2)')
    print(f'attributed 2-agent  : {total_attr*1e3:9.1f} ms')
    print(f'full PAIRED cycle   : {t_cycle*1e3:9.1f} ms')
    print(f'rollout steps/s (2 agents): {2*N*T/t_cycle:,.0f}')


if __name__ == '__main__':
    main()
