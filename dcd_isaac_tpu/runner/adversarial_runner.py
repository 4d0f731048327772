"""The DCD cycle: teacher → student(s) → regret → curriculum updates.

JAX re-design of reference envs/runners/adversarial_runner.py.  The
reference's Python orchestration over subprocess envs becomes three compiled
programs — ``cycle_generate`` (new levels: DR reset or constructive teacher
scan), ``cycle_replay`` (PLR replay with in-scan level resampling) and
``cycle_edit`` (ACCEL mutation + discard-grad evaluation) — selected by two
host-side coin flips per cycle (replay decision, edit decision), exactly the
reference's control points (run(), adversarial_runner.py:676-896).

UED algorithms are configurations of this cycle (README.MD:50-58): DR, PLR,
Robust PLR, ACCEL, PAIRED, REPAIRED, Minimax, ALP-GMM.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..algos.ppo import (
    AgentTrainState, PPOConfig, init_agent_state, make_ppo_update,
)
from ..algos.rollout import (
    RolloutConfig, initial_step_carry, make_adversary_rollout,
    make_student_rollout,
)
from ..algos.storage import batched_value_loss, compute_gae
from ..level_replay import plr as plr_lib
from ..models import popart as popart_lib
from ..models.multigrid_models import MultigridNetwork
from ..utils import struct


@struct.dataclass
class RMS:
    """Running mean/var for teacher return normalization
    (reference util RunningMeanStd)."""
    mean: jnp.ndarray
    var: jnp.ndarray
    count: jnp.ndarray

    @classmethod
    def create(cls):
        return cls(jnp.float32(0), jnp.float32(1), jnp.float32(1e-4))

    def update(self, x):
        bm, bv, bc = x.mean(), x.var(), x.shape[0]
        delta = bm - self.mean
        tot = self.count + bc
        new_mean = self.mean + delta * bc / tot
        m_a = self.var * self.count
        m_b = bv * bc
        m2 = m_a + m_b + delta ** 2 * self.count * bc / tot
        return RMS(new_mean, m2 / tot, tot)


@struct.dataclass
class RunnerState:
    rng: jax.Array
    agent: AgentTrainState
    adversary_agent: Optional[AgentTrainState]
    adversary_env: Optional[AgentTrainState]
    plr_agent: Optional[plr_lib.PLRBuffer]
    plr_antagonist: Optional[plr_lib.PLRBuffer]
    teacher_rollout: Optional[Any]      # last teacher construction rollout
    teacher_next_value: Optional[jnp.ndarray]
    env_return_rms: Optional[RMS]
    ret_rms: Optional[Any]              # VecNormalize (accum, mean, var, cnt)


class AdversarialRunner:
    """Owns models + compiled cycle programs; host-side counters/log state."""

    def __init__(self, args, env, models: Dict[str, Any], rng):
        self.args = args
        self.env = env
        self.models = models
        N = args.num_processes

        self.is_dr = args.ued_algo == 'domain_randomization'
        self.is_alp_gmm = args.ued_algo == 'alp_gmm'
        self.is_training_env = args.ued_algo in (
            'paired', 'flexible_paired', 'minimax')
        self.is_paired = args.ued_algo in ('paired', 'flexible_paired')
        self.use_plr = args.use_plr
        self.use_editor = args.use_editor
        self.robust_plr = getattr(args, 'no_exploratory_grad_updates', False)

        self.ppo_cfg = PPOConfig(
            clip_param=args.clip_param, ppo_epoch=args.ppo_epoch,
            num_mini_batch=args.num_mini_batch,
            value_loss_coef=args.value_loss_coef,
            entropy_coef=args.entropy_coef, lr=args.lr, eps=args.eps,
            max_grad_norm=args.max_grad_norm,
            clip_value_loss=args.clip_value_loss,
            use_popart=args.use_popart)
        self.adv_ppo_cfg = dataclasses.replace(
            self.ppo_cfg, ppo_epoch=args.adv_ppo_epoch,
            num_mini_batch=args.adv_num_mini_batch,
            entropy_coef=args.adv_entropy_coef,
            max_grad_norm=args.adv_max_grad_norm,
            use_popart=args.adv_use_popart)

        self.plr_cfg = None
        if self.use_plr:
            # Fixed-seed PLR (train_full_distribution=False,
            # level_sampler.py:38,97-118): a pre-filled seed set, no staging.
            # Only meaningful for the original PLR regime (DR level source) —
            # teacher/editor methods generate new levels, which cannot live
            # in a fixed seed set (the reference would crash too: its
            # observe_external_unseen_sample needs staging sets).
            if not args.train_full_distribution:
                assert self.is_dr and not self.use_editor, (
                    '--train_full_distribution false requires '
                    'ued_algo=domain_randomization without --use_editor')
            self.plr_cfg = plr_lib.PLRConfig(
                capacity=args.level_replay_seed_buffer_size,
                num_actors=N,
                full_distribution=args.train_full_distribution,
                strategy=args.level_replay_strategy,
                replay_schedule=args.level_replay_schedule,
                score_transform=args.level_replay_score_transform,
                temperature=args.level_replay_temperature,
                eps=args.level_replay_eps,
                rho=args.level_replay_rho,
                replay_prob=args.level_replay_prob,
                alpha=args.level_replay_alpha,
                staleness_coef=args.staleness_coef,
                staleness_transform=args.staleness_transform,
                staleness_temperature=args.staleness_temperature,
                seed_buffer_priority=args.level_replay_seed_buffer_priority,
                gamma=args.gamma,
                reject_unsolvable=args.reject_unsolvable_seeds,
            )

        ro_cfg = RolloutConfig(
            num_steps=args.num_steps,
            clip_reward=args.clip_reward,
            handle_timelimits=args.handle_timelimits,
            normalize_returns_gamma=(
                0.99 if args.normalize_returns else None),
            unroll=(getattr(args, 'rollout_unroll', None)
                    or (4 if jax.default_backend() != 'cpu' else 1)))
        self._student_ro_cfg = ro_cfg

        # compiled update fns
        self.update_agent = make_ppo_update(models['agent'], self.ppo_cfg, N)
        self.update_antagonist = (
            make_ppo_update(models['adversary_agent'], self.ppo_cfg, N)
            if self.is_paired else None)
        self.update_teacher = (
            make_ppo_update(models['adversary_env'], self.adv_ppo_cfg, N)
            if self.is_training_env else None)

        # teacher rollout program
        self.teacher_random = self.is_dr  # DR = uniform-random adversary
        self.teacher_rollout_fn = make_adversary_rollout(
            env, models['adversary_env'], env.adversary_rollout_steps,
            random_agent=self.teacher_random) if self.is_training_env else None

        # student rollout programs (per auto-reset behavior)
        self._ro_same = make_student_rollout(env, models['agent'], ro_cfg)
        self._ro_random = make_student_rollout(
            env, models['agent'], ro_cfg, reset_fn=self._reset_random_fn())
        self._ro_same_ant = (
            make_student_rollout(env, models['adversary_agent'], ro_cfg)
            if self.is_paired else None)

        # ALP-GMM teacher (host-side; reference adversarial_runner.py:152-173)
        self.alp_gmm_teacher = None
        if self.is_alp_gmm:
            from ..teachers.teacher_controller import TeacherController
            if args.env_name.startswith('MultiGrid'):
                dim = env.params.adversary_action_dim
                bounds = {'actions': [0, dim, min(
                    env.params.adversary_max_steps, 26)]}
                reward_bounds = None
            elif args.env_name.startswith('Bipedal'):
                n = 5 if 'POET' in args.env_name else 8
                bounds = {'actions': [0, 2, n]}
                reward_bounds = (-200, 350)
            else:
                raise ValueError(
                    f'ALP-GMM unsupported for {args.env_name}')
            self.alp_gmm_teacher = TeacherController(
                teacher='ALP-GMM', nb_test_episodes=0,
                param_env_bounds=bounds, reward_bounds=reward_bounds,
                seed=args.seed, teacher_params={})

        # host-side bookkeeping (reference runner.reset())
        self.num_updates = 0
        self.total_num_edits = 0
        self.total_episodes_collected = 0
        self.total_seeds_collected = 0
        self.student_grad_updates = 0
        self.agent_returns = deque(maxlen=10)
        self.adversary_agent_returns = deque(maxlen=10)
        self.latest_env_stats = {}

        self._jit_cache = {}
        self.mesh = None               # set via attach_mesh (--mesh_shape)
        # One compiled program: run eagerly, the env resets and param
        # inits dispatch (and, on a GPU, compile) hundreds of small ops.
        self.state = jax.jit(self._init_state)(rng)

    # ------------------------------------------------------------------
    def attach_mesh(self, mesh):
        """Shard the runner state over a device mesh (SPMD scale-out).

        Env-batch leaves shard over the 'dp' axis; params/optimizer/PLR
        replicate — XLA inserts the gradient psum and batch collectives.
        The compiled cycle programs then run as one SPMD program per cycle
        (the reference's env fan-out + learner, parallel_wrappers.py:103-137,
        fused into one jitted step).
        """
        from ..parallel.mesh import place_runner_state
        self.mesh = mesh
        self.state = place_runner_state(
            self.state, mesh, self.args.num_processes)

    # ------------------------------------------------------------------
    def _reset_random_fn(self):
        env = self.env

        def reset_fn(rng, state, seed):
            state, obs = env.reset_random(rng)
            return state, obs, seed
        return reset_fn

    def _replay_reset_fn(self, levels, weights):
        """Mid-rollout replay resample from frozen weights
        (adversarial_runner.py:551-558)."""
        env = self.env

        def reset_fn(rng, state, seed):
            r1, r2 = jax.random.split(rng)
            new_seed = jax.random.choice(
                r1, weights.shape[0], (), p=weights).astype(jnp.int32)
            state, obs = env.reset_to_level(levels[new_seed])
            return state, obs, new_seed
        return reset_fn

    def _init_state(self, rng) -> RunnerState:
        args = self.args
        env = self.env
        N = args.num_processes
        r = jax.random.split(rng, 8)

        # example observations for init
        st, obs = jax.vmap(env.reset_random)(jax.random.split(r[0], N))
        _, adv_obs = jax.vmap(env.reset)(jax.random.split(r[1], N))

        agent = init_agent_state(
            self.models['agent'], self.ppo_cfg, r[2], obs, N)
        adversary_agent = (
            init_agent_state(self.models['adversary_agent'], self.ppo_cfg,
                             r[3], obs, N) if self.is_paired else None)
        adversary_env = (
            init_agent_state(self.models['adversary_env'], self.adv_ppo_cfg,
                             r[4], adv_obs, N)
            if self.is_training_env else None)

        plr_agent = plr_antagonist = None
        if self.use_plr:
            prefill = None
            if not self.plr_cfg.full_distribution:
                # Fixed training-seed set: level i = deterministic random
                # level from sub-key i of the run seed (the reference's
                # fixed seed list, level_sampler.py:123-128).
                keys = jax.random.split(
                    jax.random.PRNGKey(args.seed),
                    self.plr_cfg.capacity)

                def _lvl(k):
                    st, _ = env.reset_random(k)
                    return env.get_level(st)
                prefill = jax.lax.map(jax.jit(_lvl), keys, batch_size=256)
            plr_agent = plr_lib.init_plr(self.plr_cfg, env.level_shape,
                                         env.level_dtype, levels=prefill)
            if self.is_paired and not (
                    args.protagonist_plr or args.antagonist_plr):
                plr_antagonist = plr_lib.init_plr(
                    self.plr_cfg, env.level_shape, env.level_dtype)

        # Pre-populate a zero teacher rollout so the runner-state pytree
        # structure is stable from cycle 1 (None→Rollout would force a
        # second trace/compile of every cycle program).
        teacher_rollout = teacher_next_value = None
        if self.is_training_env:
            shapes = jax.eval_shape(
                lambda: self.teacher_rollout_fn(
                    adversary_env.params,
                    *jax.vmap(env.reset)(jax.random.split(r[6], N)),
                    r[7]))
            teacher_rollout = jax.tree.map(
                lambda s: jnp.zeros(s.shape, s.dtype), shapes[1])
            teacher_next_value = jnp.zeros((N,))

        return RunnerState(
            rng=r[5],
            agent=agent,
            adversary_agent=adversary_agent,
            adversary_env=adversary_env,
            plr_agent=plr_agent,
            plr_antagonist=plr_antagonist,
            teacher_rollout=teacher_rollout,
            teacher_next_value=teacher_next_value,
            env_return_rms=(RMS.create() if args.adv_normalize_returns
                            else None),
            ret_rms=((jnp.zeros((N,)), jnp.float32(0.0), jnp.float32(1.0),
                      jnp.float32(1e-4))
                     if args.normalize_returns else None),
        )

    # ------------------------------------------------------------------
    # Level generation (teacher phase)
    # ------------------------------------------------------------------
    def _generate_levels(self, state: RunnerState, rng):
        """→ (env_states, teacher_rollout?, teacher_next_value?)

        Branches (reference agent_rollout is_env, adversarial_runner.py:455-483):
          * paired/minimax → constructive rollout by the teacher policy
          * DR + PLR (default) → constructive rollout with a uniform-random
            teacher (reference ACAgent.random, train.py:84-86)
          * DR without PLR, or use_reset_random_dr → env.reset_random
        """
        env, args = self.env, self.args
        N = args.num_processes
        if self.is_training_env:
            env_states, adv_obs = jax.vmap(env.reset)(
                jax.random.split(rng, N))
            params = state.adversary_env.params
            env_states, t_rollout, t_next_value = self.teacher_rollout_fn(
                params, env_states, adv_obs, rng)
            return env_states, t_rollout, t_next_value
        adversary_discrete = getattr(self.env, 'adversary_discrete', True)
        if (self.is_dr and self.use_plr and not args.use_reset_random_dr
                and adversary_discrete):
            return self._random_design(rng), None, None
        env_states, _ = jax.vmap(env.reset_random)(jax.random.split(rng, N))
        return env_states, None, None

    def _random_design(self, rng):
        """Uniform-random adversary builds levels constructively."""
        env = self.env
        N = self.args.num_processes
        rng, r0 = jax.random.split(rng)
        env_states, _ = jax.vmap(env.reset)(jax.random.split(r0, N))
        num_actions = env.adversary_num_actions

        def step(carry, _):
            states, rng = carry
            rng, r1, r2 = jax.random.split(rng, 3)
            actions = jax.random.randint(r1, (N,), 0, num_actions)
            states, _, _ = jax.vmap(env.step_adversary)(
                states, actions, jax.random.split(r2, N))
            return (states, rng), None

        (env_states, _), _ = jax.lax.scan(
            step, (env_states, rng), None,
            length=env.adversary_rollout_steps)
        return env_states

    # ------------------------------------------------------------------
    # Student phase (rollout + GAE + PLR scoring + PPO update)
    # ------------------------------------------------------------------
    def _rollout_pair(self, params_a, params_b, env_states, level_seeds,
                      rng_a, rng_b):
        """Run protagonist + antagonist rollouts as ONE vmapped scan.

        The two PAIRED students share architecture and play the same
        levels independently, so their rollouts stack on a leading agent
        axis: per-step model matmuls run at 2N batch instead of two
        sequential N-batch scans (halves launch overhead, doubles MXU
        tile occupancy).  Numerically identical to the sequential path —
        same RNG keys per lane, same ops.  Skipped when VecNormalize
        returns-RMS is on (the reference threads one RMS sequentially
        through both rollouts).
        """
        env_states, obs = jax.vmap(self.env.reset_agent)(env_states)
        carry_a = initial_step_carry(
            self.env, self.models['agent'], env_states, obs, rng_a,
            level_seeds=level_seeds, ret_rms=None)
        carry_b = initial_step_carry(
            self.env, self.models['adversary_agent'], env_states, obs,
            rng_b, level_seeds=level_seeds, ret_rms=None)
        stack = lambda a, b: jax.tree.map(
            lambda x, y: jnp.stack([x, y]), a, b)
        out = jax.vmap(self._ro_same)(
            stack(params_a, params_b), stack(carry_a, carry_b))
        take = lambda i: jax.tree.map(lambda x: x[i], out)
        return take(0), take(1)

    def _student_phase(self, agent_state, rollout_fn, update_fn, env_states,
                       level_seeds, plr_buf, rng, discard_grad: bool,
                       update_sampler: bool, model, ret_rms=None,
                       precomputed=None, defer_update=False):
        args = self.args
        N = args.num_processes
        if precomputed is not None:
            final, steps, next_value, ro_stats = precomputed
        else:
            env_states, obs = jax.vmap(self.env.reset_agent)(env_states)
            carry = initial_step_carry(
                self.env, model, env_states, obs, rng,
                level_seeds=level_seeds, ret_rms=ret_rms)
            final, steps, next_value, ro_stats = rollout_fn(
                agent_state.params, carry)

        if self.ppo_cfg.use_popart:
            values_d = popart_lib.denormalize(agent_state.popart, steps.values)
            next_value_d = popart_lib.denormalize(
                agent_state.popart, next_value)
            trunc_d = popart_lib.denormalize(
                agent_state.popart, steps.trunc_values)
            gae_rollout = steps.replace(values=values_d, trunc_values=trunc_d)
        else:
            values_d, next_value_d, gae_rollout = (
                steps.values, next_value, steps)

        returns = compute_gae(
            gae_rollout, next_value_d, args.gamma, args.gae_lambda,
            use_proper_time_limits=args.handle_timelimits)

        staged_scores = staged_counts = None
        if plr_buf is not None and update_sampler:
            plr_returns = returns
            if self.plr_cfg.strategy == 'alt_advantage_abs':
                plr_returns = compute_gae(
                    gae_rollout, next_value_d, self.plr_cfg.alt_gamma,
                    args.gae_lambda,
                    use_proper_time_limits=args.handle_timelimits)
            plr_buf, staged_scores, staged_counts = plr_lib.update_with_rollout(
                plr_buf, self.plr_cfg, steps, plr_returns, values_d)

        bvl = batched_value_loss(
            returns, values_d,
            clipped=not (args.adv_use_popart or args.adv_normalize_returns))

        rng, sub = jax.random.split(rng)
        info = {
            'rollout': ro_stats,
            'batched_value_loss': bvl,
            'final_env_states': final.env_state,
            'level_seeds_final': final.level_seeds,
            'ret_rms': (final.ret_accum, final.rms_mean, final.rms_var,
                        final.rms_count),
            'actions': steps.actions,
            'dones': steps.dones,
        }
        if defer_update:
            # caller fuses both students' PPO updates into one vmapped
            # program (_update_pair); hand back the update inputs
            pending = (agent_state, steps, returns, sub)
            return pending, plr_buf, staged_scores, staged_counts, info

        new_agent_state, upd_stats = update_fn(
            agent_state, steps, returns, model.initial_carry((N,)), sub,
            discard_grad)
        info['update'] = upd_stats
        return new_agent_state, plr_buf, staged_scores, staged_counts, info

    def _update_pair(self, pend_a, pend_b, discard_grad):
        """One vmapped PPO update over both PAIRED students (same
        architecture, same PPOConfig): epochs × minibatches run at a
        stacked agent axis instead of two sequential programs."""
        N = self.args.num_processes
        stack = lambda a, b: jax.tree.map(
            lambda x, y: jnp.stack([x, y]), a, b)
        sa, steps_a, ret_a, rng_a = pend_a
        sb, steps_b, ret_b, rng_b = pend_b
        carry0 = self.models['agent'].initial_carry((N,))
        states, stats = jax.vmap(
            self.update_agent, in_axes=(0, 0, 0, None, 0, None))(
            stack(sa, sb), stack(steps_a, steps_b), stack(ret_a, ret_b),
            carry0, stack(rng_a, rng_b), discard_grad)
        take = lambda t, i: jax.tree.map(lambda x: x[i], t)
        return ((take(states, 0), take(states, 1)),
                (take(stats, 0), take(stats, 1)))

    # ------------------------------------------------------------------
    # Teacher regret + update
    # ------------------------------------------------------------------
    def _env_return(self, state, agent_ro, antag_ro):
        """reference _compute_env_return (adversarial_runner.py:637-674)."""
        args = self.args
        mean_p = agent_ro['mean_return']
        max_p = agent_ro['max_return']
        if args.ued_algo == 'paired':
            env_ret = jnp.maximum(antag_ro['max_return'] - mean_p, 0.0)
        elif args.ued_algo == 'flexible_paired':
            ant_wins = antag_ro['max_return'] > max_p
            env_max = jnp.where(ant_wins, antag_ro['max_return'], max_p)
            env_mean = jnp.where(ant_wins, mean_p, antag_ro['mean_return'])
            env_ret = jnp.maximum(env_max - env_mean, 0.0)
        elif args.ued_algo == 'minimax':
            env_ret = -max_p
        else:
            env_ret = jnp.zeros_like(mean_p)

        rms = state.env_return_rms
        if rms is not None:
            rms = rms.update(env_ret)
            env_ret = env_ret / jnp.sqrt(rms.var + 1e-8)
        if args.adv_clip_reward is not None:
            env_ret = jnp.clip(
                env_ret, -args.adv_clip_reward, args.adv_clip_reward)
        return env_ret, rms

    def _teacher_update(self, state, env_ret, rng):
        args = self.args
        t_ro = state.teacher_rollout.replace_final_reward(env_ret)
        returns = compute_gae(
            t_ro, state.teacher_next_value, args.gamma, args.gae_lambda)
        model = self.models['adversary_env']
        new_teacher, stats = self.update_teacher(
            state.adversary_env, t_ro, returns,
            model.initial_carry((args.num_processes,)), rng, False)
        return new_teacher, stats

    # ------------------------------------------------------------------
    # Compiled cycle programs
    # ------------------------------------------------------------------
    def _build_cycle_generate(self):
        args = self.args
        N = args.num_processes
        S = self.plr_cfg.capacity if self.use_plr else 0
        discard = self.use_plr and self.robust_plr
        env = self.env

        fixed_seed = self.use_plr and not self.plr_cfg.full_distribution

        def cycle(state: RunnerState):
            rng, r_gen, r_stu, r_ant, r_t = jax.random.split(state.rng, 5)
            plr_in = state.plr_agent
            if fixed_seed:
                # Fixed-seed mode: draw unseen training seeds ∝ unseen
                # weights (_sample_unseen_level, level_sampler.py:686-698);
                # scores apply directly to those slots (no staging).
                seeds, fixed_levels, plr_in = plr_lib.sample_unseen_levels(
                    plr_in, self.plr_cfg, r_gen, N)
                env_states, _ = jax.vmap(env.reset_to_level)(fixed_levels)
                t_rollout = t_next_value = None
            else:
                env_states, t_rollout, t_next_value = self._generate_levels(
                    state, r_gen)
                seeds = (jnp.arange(N, dtype=jnp.int32) + S if self.use_plr
                         else jnp.full((N,), -1, jnp.int32))

            ro_fn = (self._ro_random if (self.is_dr and not self.use_plr)
                     else self._ro_same)
            pre_a = pre_b = None
            fusable = (
                self.is_paired and state.ret_rms is None
                and jax.tree_util.tree_structure(state.agent.params)
                == jax.tree_util.tree_structure(
                    state.adversary_agent.params))
            # full fusion (rollouts + updates) vs rollout-only fusion:
            # the update half was the measured r3 regression (PERF.md r3)
            can_fuse = fusable and getattr(args, 'fuse_paired', False)
            fuse_ro = can_fuse or (
                fusable and getattr(args, 'fuse_paired_rollouts', False))
            if fuse_ro:
                pre_a, pre_b = self._rollout_pair(
                    state.agent.params, state.adversary_agent.params,
                    env_states, seeds, r_stu, r_ant)
            agent_state, plr_a, st_scores, st_counts, a_info = (
                self._student_phase(
                    state.agent, ro_fn, self.update_agent, env_states, seeds,
                    plr_in, r_stu, discard,
                    update_sampler=self.use_plr,
                    model=self.models['agent'], ret_rms=state.ret_rms,
                    precomputed=pre_a, defer_update=can_fuse))
            ret_rms = (a_info['ret_rms'] if state.ret_rms is not None
                       else None)

            ant_state, plr_b = state.adversary_agent, state.plr_antagonist
            b_info = None
            if self.is_paired:
                ant_state, plr_b, st_scores_b, st_counts_b, b_info = (
                    self._student_phase(
                        state.adversary_agent, self._ro_same_ant,
                        self.update_antagonist, env_states, seeds,
                        state.plr_antagonist, r_ant, discard,
                        update_sampler=state.plr_antagonist is not None,
                        model=self.models['adversary_agent'],
                        ret_rms=ret_rms, precomputed=pre_b,
                        defer_update=can_fuse))
                if ret_rms is not None:
                    ret_rms = b_info['ret_rms']
            if can_fuse:
                # agent_state/ant_state currently hold the pending update
                # inputs; run both updates as one vmapped program
                (agent_state, ant_state), (ua, ub) = self._update_pair(
                    agent_state, ant_state, discard)
                a_info['update'] = ua
                b_info['update'] = ub

            # promote this cycle's new levels into the PLR buffer(s)
            # (full-distribution staging only; fixed-seed slots were
            # updated in place by update_with_rollout)
            levels = solvable = None
            if self.use_plr and not fixed_seed:
                levels = jax.vmap(env.get_level)(env_states)
                solvable = (
                    jax.vmap(lambda s: s.passable)(env_states)
                    if hasattr(env_states, 'passable')
                    else jnp.ones((N,), bool))
                plr_a = plr_lib.promote_staged(
                    plr_a, self.plr_cfg, levels, st_scores, st_counts,
                    staged_solvable=solvable)
                if plr_b is not None:
                    plr_b = plr_lib.promote_staged(
                        plr_b, self.plr_cfg, levels, st_scores_b, st_counts_b,
                        staged_solvable=solvable)

            env_ret, rms = self._env_return(
                state, a_info['rollout'],
                b_info['rollout'] if b_info else a_info['rollout'])

            state = state.replace(
                rng=rng, agent=agent_state, adversary_agent=ant_state,
                plr_agent=plr_a, plr_antagonist=plr_b,
                teacher_rollout=t_rollout if t_rollout is not None
                else state.teacher_rollout,
                teacher_next_value=t_next_value if t_next_value is not None
                else state.teacher_next_value,
                env_return_rms=rms, ret_rms=ret_rms)

            t_stats = None
            if self.is_training_env and not self.teacher_random:
                new_teacher, t_stats = self._teacher_update(
                    state, env_ret, r_t)
                state = state.replace(adversary_env=new_teacher)

            stats = self._device_stats(
                state, env_states, a_info, b_info, t_stats, env_ret)
            return state, stats

        return cycle

    def _build_cycle_alp_gmm(self):
        args = self.args
        N = args.num_processes
        env = self.env

        def cycle(state: RunnerState, tasks):
            rng, r_env, r_stu = jax.random.split(state.rng, 3)
            env_states, _ = jax.vmap(env.reset_alp_gmm)(
                tasks, jax.random.split(r_env, N))
            seeds = jnp.full((N,), -1, jnp.int32)
            agent_state, _, _, _, a_info = self._student_phase(
                state.agent, self._ro_same, self.update_agent, env_states,
                seeds, None, r_stu, False, update_sampler=False,
                model=self.models['agent'], ret_rms=state.ret_rms)
            ret_rms = (a_info['ret_rms'] if state.ret_rms is not None
                       else None)
            env_ret, rms = self._env_return(
                state, a_info['rollout'], a_info['rollout'])
            state = state.replace(
                rng=rng, agent=agent_state, env_return_rms=rms,
                ret_rms=ret_rms)
            stats = self._device_stats(
                state, env_states, a_info, None, None, env_ret)
            stats['_alp_mean_return'] = a_info['rollout']['mean_return']
            stats['_alp_epi_count'] = a_info['rollout']['episode_count']
            return state, stats

        return cycle

    def _build_cycle_replay(self, force_env_stats: bool = False):
        """``force_env_stats``: always compute fresh env-complexity stats
        (run_batched needs the generate/replay stat pytrees structurally
        identical for lax.cond; the host assembly then drops them when
        --log_replay_complexity is off, matching the sequential path)."""
        args = self.args
        N = args.num_processes
        env = self.env
        model = self.models['agent']

        def cycle(state: RunnerState):
            rng, r_s1, r_s2, r_stu, r_ant, r_t = jax.random.split(state.rng, 6)
            # protagonist levels from its sampler
            seeds, levels, plr_a = plr_lib.sample_replay_levels(
                state.plr_agent, self.plr_cfg, r_s1, N)
            env_states, _ = jax.vmap(env.reset_to_level)(levels)
            w = plr_lib.sample_weights(plr_a, self.plr_cfg)
            ro_fn = make_student_rollout(
                env, model, self._student_ro_cfg,
                reset_fn=self._replay_reset_fn(plr_a.levels, w))
            agent_state, plr_a, _, _, a_info = self._student_phase(
                state.agent, ro_fn, self.update_agent, env_states, seeds,
                plr_a, r_stu, False, update_sampler=True, model=model,
                ret_rms=state.ret_rms)
            ret_rms = (a_info['ret_rms'] if state.ret_rms is not None
                       else None)

            ant_state, plr_b = state.adversary_agent, state.plr_antagonist
            b_info = None
            if self.is_paired:
                buf_b = plr_b if plr_b is not None else plr_a
                seeds_b, levels_b, buf_b = plr_lib.sample_replay_levels(
                    buf_b, self.plr_cfg, r_s2, N)
                env_states_b, _ = jax.vmap(env.reset_to_level)(levels_b)
                w_b = plr_lib.sample_weights(buf_b, self.plr_cfg)
                ro_fn_b = make_student_rollout(
                    env, self.models['adversary_agent'], self._student_ro_cfg,
                    reset_fn=self._replay_reset_fn(buf_b.levels, w_b))
                ant_state, buf_b, _, _, b_info = self._student_phase(
                    state.adversary_agent, ro_fn_b, self.update_antagonist,
                    env_states_b, seeds_b, buf_b, r_ant, False,
                    update_sampler=True,
                    model=self.models['adversary_agent'], ret_rms=ret_rms)
                if ret_rms is not None:
                    ret_rms = b_info['ret_rms']
                if plr_b is not None:
                    plr_b = buf_b
                else:
                    plr_a = buf_b

            env_ret, rms = self._env_return(
                state, a_info['rollout'],
                b_info['rollout'] if b_info else a_info['rollout'])

            state = state.replace(
                rng=rng, agent=agent_state, adversary_agent=ant_state,
                plr_agent=plr_a, plr_antagonist=plr_b, env_return_rms=rms,
                ret_rms=ret_rms)

            t_stats = None
            if (self.is_training_env and not self.teacher_random
                    and state.teacher_rollout is not None):
                new_teacher, t_stats = self._teacher_update(
                    state, env_ret, r_t)
                state = state.replace(adversary_env=new_teacher)

            # ACCEL 'easy' base selection metric
            easy_metric = (a_info['rollout']['mean_return']
                           - a_info['batched_value_loss'])
            # --log_replay_complexity: env stats over the replayed levels
            # (reference adversarial_runner.py:825-830)
            stats = self._device_stats(
                state,
                env_states if (args.log_replay_complexity or force_env_stats)
                else None,
                a_info, b_info, t_stats, env_ret)
            return state, stats, seeds, easy_metric

        return cycle

    def _build_cycle_edit(self):
        """ACCEL: mutate replayed levels, evaluate children with discard_grad,
        insert with lineage (adversarial_runner.py:756-795)."""
        args = self.args
        N = args.num_processes
        env = self.env
        model = self.models['agent']
        S = self.plr_cfg.capacity

        def cycle(state: RunnerState, parent_seeds):
            rng, r_mut, r_stu = jax.random.split(state.rng, 3)
            parent_levels = state.plr_agent.levels[parent_seeds]
            parent_edits = state.plr_agent.num_edits[parent_seeds]
            env_states, _ = jax.vmap(env.reset_to_level)(parent_levels)
            env_states, _ = jax.vmap(
                lambda s, r: env.mutate_level(s, r, args.num_edits)
            )(env_states, jax.random.split(r_mut, N))

            seeds = jnp.arange(N, dtype=jnp.int32) + S
            agent_state, plr_a, st_scores, st_counts, a_info = (
                self._student_phase(
                    state.agent, self._ro_same, self.update_agent,
                    env_states, seeds, state.plr_agent, r_stu,
                    True, update_sampler=True, model=model,
                    ret_rms=state.ret_rms))
            ret_rms = (a_info['ret_rms'] if state.ret_rms is not None
                       else None)

            levels = jax.vmap(env.get_level)(env_states)
            solvable = (
                jax.vmap(lambda s: s.passable)(env_states)
                if hasattr(env_states, 'passable')
                else jnp.ones((N,), bool))
            plr_a = plr_lib.promote_staged(
                plr_a, self.plr_cfg, levels, st_scores, st_counts,
                staged_solvable=solvable,
                staged_num_edits=parent_edits + 1)
            state = state.replace(rng=rng, agent=agent_state, plr_agent=plr_a,
                                  ret_rms=ret_rms)
            return state, a_info['rollout']

        return cycle

    # ------------------------------------------------------------------
    def _device_stats(self, state, env_states, a_info, b_info, t_stats,
                      env_ret):
        stats = {
            'mean_env_return': env_ret.mean(),
            'agent_value_loss': a_info['update']['value_loss'],
            'agent_pg_loss': a_info['update']['action_loss'],
            'agent_dist_entropy': a_info['update']['dist_entropy'],
            'agent_grad_norm': a_info['update']['grad_norm'],
            'mean_agent_return_batch': a_info['rollout']['mean_return'].mean(),
            'episodes': a_info['rollout']['episode_count'].sum(),
            'returns_sum': (a_info['rollout']['mean_return']
                            * a_info['rollout']['episode_count']).sum(),
        }
        if b_info is not None:
            stats.update({
                'adversary_value_loss': b_info['update']['value_loss'],
                'adversary_pg_loss': b_info['update']['action_loss'],
                'adversary_dist_entropy': b_info['update']['dist_entropy'],
                'mean_adversary_agent_return_batch':
                    b_info['rollout']['mean_return'].mean(),
                'adversary_episodes': b_info['rollout']['episode_count'].sum(),
                'adversary_returns_sum': (
                    b_info['rollout']['mean_return']
                    * b_info['rollout']['episode_count']).sum(),
            })
        if t_stats is not None:
            stats.update({
                'adversary_env_pg_loss': t_stats['action_loss'],
                'adversary_env_value_loss': t_stats['value_loss'],
                'adversary_env_dist_entropy': t_stats['dist_entropy'],
            })
        if env_states is not None:
            env_stats = {}
            if hasattr(env_states, 'n_clutter_placed'):
                # solved_path_length: mean over envs either student solved
                # (reference _get_env_stats_multigrid, :284-294)
                max_r = a_info['rollout']['max_return']
                if b_info is not None:
                    max_r = jnp.maximum(max_r, b_info['rollout']['max_return'])
                solved = max_r > 0
                spl = env_states.shortest_path_length
                env_stats.update({
                    'num_blocks': env_states.n_clutter_placed.mean(),
                    'passable_ratio': env_states.passable.mean(),
                    'shortest_path_length': spl.mean(),
                    'solved_path_length': jnp.where(
                        solved.any(),
                        (spl * solved).sum()
                        / jnp.clip(solved.sum(), 1, None), 0.0),
                })
            elif hasattr(env_states, 'level_params'):
                p = env_states.level_params
                env_stats.update({
                    'ground_roughness': p[:, 0].mean(),
                    'pit_gap_high': jnp.maximum(p[:, 1], p[:, 2]).mean(),
                    'stump_height_high': jnp.maximum(p[:, 3], p[:, 4]).mean(),
                    'stair_height_high': jnp.maximum(p[:, 5], p[:, 6]).mean(),
                })
            elif hasattr(env_states, 'track'):
                # CarRacing: export the track polylines; geo-complexity is
                # computed host-side in _run_impl (reference
                # _get_env_stats_car_racing + util/geo_complexity.py)
                stats['_track_points'] = env_states.track.points
                stats['_track_valid'] = env_states.track.valid
            stats['_env_stats'] = env_stats
        if state.plr_agent is not None:
            stats.update(plr_lib.plr_stats(state.plr_agent, self.plr_cfg))
        if self.args.log_action_complexity:
            # exported on every cycle (generate AND replay) so the
            # generate/replay stat pytrees are structurally identical —
            # required by the lax.cond program selection in run_batched
            stats['_actions'] = a_info['actions']
            stats['_dones'] = a_info['dones']
        return stats

    # ------------------------------------------------------------------
    # Host-side checkpoint state (reference state_dict
    # adversarial_runner.py:195-216 — incl. both return deques and
    # latest_env_stats)
    # ------------------------------------------------------------------
    def host_state_dict(self) -> Dict[str, Any]:
        return {
            'num_updates': self.num_updates,
            'total_num_edits': self.total_num_edits,
            'total_episodes_collected': self.total_episodes_collected,
            'total_seeds_collected': self.total_seeds_collected,
            'student_grad_updates': self.student_grad_updates,
            'agent_returns': list(self.agent_returns),
            'adversary_agent_returns': list(self.adversary_agent_returns),
            'latest_env_stats': dict(self.latest_env_stats),
        }

    def load_host_state_dict(self, host: Dict[str, Any]):
        for k, v in host.items():
            if k in ('agent_returns', 'adversary_agent_returns'):
                dq = getattr(self, k)
                dq.clear()
                dq.extend(v)
            elif k == 'latest_env_stats':
                self.latest_env_stats = dict(v)
            else:
                setattr(self, k, v)

    # ------------------------------------------------------------------
    def _jit(self, name, builder):
        if name not in self._jit_cache:
            # Donate the RunnerState input: every cycle program consumes
            # the old state and returns the new one, so XLA can update
            # params/optimizer/PLR buffers in place instead of copying
            # (all host reads of the old state happen before the call;
            # donation semantics smoke-tested by forcing this on CPU).
            # CPU ignores donation (would only warn) — skip it there.
            import os as _os
            donate = ((0,) if jax.default_backend() != 'cpu'
                      and not _os.environ.get('DCD_NO_DONATE') else ())
            fn = builder()
            if self.mesh is not None:
                fn = self._keep_state_placement(fn)
            self._jit_cache[name] = jax.jit(fn, donate_argnums=donate)
        return self._jit_cache[name]

    def _keep_state_placement(self, fn):
        """Return the state with the shardings it came in with. Left to
        itself, XLA may choose other output shardings, and the next call
        then compiles the program again for them."""
        shardings = jax.tree.map(lambda x: x.sharding, self.state)

        def pinned(state, *args):
            state, *rest = fn(state, *args)
            return (jax.lax.with_sharding_constraint(state, shardings),
                    *rest)
        return pinned

    def run(self) -> Dict[str, float]:
        """One full DCD cycle; returns host-side stats dict."""
        if self.mesh is not None:
            with jax.set_mesh(self.mesh):
                return self._run_impl()
        return self._run_impl()

    def _run_impl(self) -> Dict[str, float]:
        args = self.args
        np_rng = np.random

        level_replay = False
        if self.use_plr:
            # host-side coin for program selection (decision itself uses the
            # same formula as the reference, on current buffer state).
            # fold_in with a fixed tag keeps the coin independent of the
            # cycle program's own splits of state.rng.
            dec_rng = jax.random.fold_in(self.state.rng, 0x5EED)
            level_replay = bool(plr_lib.sample_replay_decision(
                self.state.plr_agent, self.plr_cfg, dec_rng))

        student_grad = not (self.use_plr and not level_replay
                            and self.robust_plr)
        if student_grad:
            self.student_grad_updates += 1

        if self.is_alp_gmm:
            tasks = jnp.asarray(self.alp_gmm_teacher.sample_batch(
                args.num_processes))
            cycle = self._jit('alp', self._build_cycle_alp_gmm)
            self.state, stats = cycle(self.state, tasks)
            seeds = easy_metric = None
            # Record mean episode return per env slot to the teacher
            # (coarser than the reference's per-episode recording —
            # documented deviation; same reward attribution per task).
            mr = np.asarray(stats.pop('_alp_mean_return'))
            ec = np.asarray(stats.pop('_alp_epi_count'))
            for i in range(args.num_processes):
                if ec[i] > 0:
                    self.alp_gmm_teacher.record_train_episode(
                        float(mr[i]), index=i)
            self.total_seeds_collected += args.num_processes
        elif level_replay:
            cycle = self._jit('replay', self._build_cycle_replay)
            self.state, stats, seeds, easy_metric = cycle(self.state)
        else:
            cycle = self._jit('generate', self._build_cycle_generate)
            self.state, stats = cycle(self.state)
            seeds = easy_metric = None
            self.total_seeds_collected += args.num_processes

        # ACCEL edit branch
        edit = (self.use_editor and level_replay
                and np_rng.random() < args.level_editor_prob)
        if edit:
            if args.base_levels == 'easy' and args.num_processes >= 4:
                order = np.argsort(np.asarray(easy_metric))[:4]
                parents = jnp.asarray(
                    np.tile(np.asarray(seeds)[order],
                            args.num_processes // 4))
            else:
                parents = seeds
            cycle_edit = self._jit('edit', self._build_cycle_edit)
            self.state, edit_ro = cycle_edit(self.state, parents)
            self.total_num_edits += 1

        self.num_updates += 1
        return self._host_assemble(stats, level_replay)

    def _host_assemble(self, stats, level_replay: bool):
        """Host-side per-cycle stat assembly + counter bookkeeping.

        ``stats``: one cycle's device stats (jax or numpy leaves), with
        counters (num_updates / total_num_edits / student_grad_updates /
        total_seeds_collected) already advanced for this cycle.
        """
        args = self.args
        stats = dict(stats)
        if '_actions' in stats:
            from ..native.lz import action_complexity
            acts = np.asarray(stats.pop('_actions'))
            dns = np.asarray(stats.pop('_dones'))
            if acts.ndim == 2:  # discrete trajectories only
                stats['agent_action_complexity'] = action_complexity(
                    acts, dns)
            else:
                stats.pop('agent_action_complexity', None)
        env_stats = stats.pop('_env_stats', None)
        if (env_stats is not None and level_replay
                and not args.log_replay_complexity):
            # run_batched computes env stats on every cycle for structural
            # parity; without --log_replay_complexity the sequential path
            # would not have fresh stats here — drop to match it
            env_stats = None
        tp = stats.pop('_track_points', None)
        tv = stats.pop('_track_valid', None)
        if tp is not None and env_stats is not None:
            from ..utils.geo_complexity import batch_track_complexity
            track_stats = batch_track_complexity(
                np.asarray(tp), np.asarray(tv))
            env_stats.update(
                {'track_' + k: v for k, v in track_stats.items()})
        host = {k: float(np.asarray(v)) for k, v in stats.items()}

        # Env complexity stats: fresh on generate cycles (and on replay
        # cycles under --log_replay_complexity, 'plr_'-prefixed); otherwise
        # re-log the latest (reference adversarial_runner.py:825-840).
        if env_stats is not None:
            prefix = 'plr_' if level_replay else ''
            fresh = {prefix + k: float(np.asarray(v))
                     for k, v in env_stats.items()}
            host.update(fresh)
            if self.use_plr:
                self.latest_env_stats.update(fresh)
        elif self.latest_env_stats:
            host.update(self.latest_env_stats)

        n_epi = host.pop('episodes', 0)
        ret_sum = host.pop('returns_sum', 0.0)
        self.total_episodes_collected += int(n_epi)
        if n_epi > 0:
            self.agent_returns.append(ret_sum / n_epi)
        adv_epi = host.pop('adversary_episodes', None)
        adv_sum = host.pop('adversary_returns_sum', None)
        if adv_epi is not None and adv_epi > 0:
            self.adversary_agent_returns.append(adv_sum / adv_epi)
        host['mean_agent_return'] = (
            float(np.mean(self.agent_returns)) if self.agent_returns else 0.0)
        if self.is_paired:
            host['mean_adversary_agent_return'] = (
                float(np.mean(self.adversary_agent_returns))
                if self.adversary_agent_returns else 0.0)
        host.update({
            # Deviation (PARITY.md #9): ACCEL edit-scoring rollouts are
            # counted as real N*T env steps; the reference's step budget
            # (train.py:160) counts update cycles only.
            'steps': ((self.num_updates + self.total_num_edits)
                      * args.num_processes * args.num_steps),
            'total_episodes': self.total_episodes_collected,
            'total_seeds': self.total_seeds_collected,
            'total_student_grad_updates': self.student_grad_updates,
            'level_replay': int(level_replay),
            'total_num_edits': self.total_num_edits,
        })
        return host

    # ------------------------------------------------------------------
    # K-cycle batched dispatch
    # ------------------------------------------------------------------
    def _build_cycle_multi(self):
        """One compiled program running K full DCD cycles via lax.scan.

        Kills the production-config launch-latency wall (PERF.md r3: at
        the reference's N=32 the chip idled at 17k steps/s, 29x under the
        N=4096 bench — every cycle paid a host round trip).  The per-cycle
        host control points move in-program:

          * the replay decision (reference sample_replay_decision) is
            computed from the live buffer state with the same fold_in key
            the sequential path uses, selecting the generate / replay
            program via lax.cond;
          * the ACCEL edit coin is pre-drawn on host (np.random, the same
            source as the sequential path) and passed in as a (K,) array;
          * the 'easy' base selection (4 easiest by mean_return - bvl,
            reference adversarial_runner.py:763-770) becomes an in-program
            argsort.

        Stats for all K cycles come back stacked; the host assembly then
        replays the exact per-cycle bookkeeping.
        """
        args = self.args
        N = args.num_processes

        gen_cycle = self._build_cycle_generate()
        replay_cycle = (self._build_cycle_replay(force_env_stats=True)
                        if self.use_plr else None)
        edit_cycle = self._build_cycle_edit() if self.use_editor else None

        def one_cycle(state: RunnerState, coin):
            if not self.use_plr:
                state, stats = gen_cycle(state)
                stats['_level_replay'] = jnp.bool_(False)
                stats['_edited'] = jnp.bool_(False)
                return state, stats

            dec_rng = jax.random.fold_in(state.rng, 0x5EED)
            replay = plr_lib.sample_replay_decision(
                state.plr_agent, self.plr_cfg, dec_rng)

            def do_gen(state):
                state, stats = gen_cycle(state)
                return (state, stats, jnp.full((N,), -1, jnp.int32),
                        jnp.zeros((N,)))

            def do_replay(state):
                return replay_cycle(state)

            state, stats, seeds, easy = jax.lax.cond(
                replay, do_replay, do_gen, state)

            edited = jnp.bool_(False)
            if self.use_editor:
                edited = replay & (coin < args.level_editor_prob)

                def do_edit(state):
                    if args.base_levels == 'easy' and N >= 4:
                        order = jnp.argsort(easy)[:4]
                        parents = jnp.tile(seeds[order], N // 4)
                    else:
                        parents = seeds
                    state, _ = edit_cycle(state, parents)
                    return state

                state = jax.lax.cond(edited, do_edit, lambda s: s, state)

            stats['_level_replay'] = replay
            stats['_edited'] = edited
            return state, stats

        def multi(state: RunnerState, coins: jnp.ndarray):
            return jax.lax.scan(one_cycle, state, coins)

        return multi

    def run_batched(self, k: int):
        """Run ``k`` DCD cycles in ONE compiled dispatch.

        Returns a list of ``k`` host stats dicts — one per cycle, with the
        identical bookkeeping the sequential run() performs.  Falls back
        to sequential run() for ALP-GMM (its teacher is a host-side GMM
        consulted every cycle).
        """
        if self.is_alp_gmm or k == 1:
            return [self.run() for _ in range(k)]
        if self.use_editor and self.args.base_levels == 'easy':
            assert self.args.num_processes % 4 == 0, (
                'base_levels=easy requires num_processes % 4 == 0')
        coins = jnp.asarray(np.random.random(k), jnp.float32)

        fn = self._jit('multi', self._build_cycle_multi)
        if self.mesh is not None:
            with jax.set_mesh(self.mesh):
                self.state, stacked = fn(self.state, coins)
        else:
            self.state, stacked = fn(self.state, coins)
        stacked = jax.device_get(stacked)

        out = []
        for i in range(k):
            s = jax.tree.map(lambda x: x[i], stacked)
            level_replay = bool(s.pop('_level_replay'))
            edited = bool(s.pop('_edited'))
            if not (self.use_plr and not level_replay and self.robust_plr):
                self.student_grad_updates += 1
            if not level_replay:
                self.total_seeds_collected += self.args.num_processes
            if edited:
                self.total_num_edits += 1
            self.num_updates += 1
            out.append(self._host_assemble(s, level_replay))
        return out
