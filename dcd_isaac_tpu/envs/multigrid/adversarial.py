"""Adversarial (UED) MultiGrid environment, pure JAX.

JAX re-design of reference envs/multigrid/adversarial.py.  The teacher
("adversary_env") builds a level one placement per ``step_adversary``; levels
are fixed-size (W, H, 3) uint8 encodings (the same byte layout as the
reference's ``Grid.encode()``), so the level store is a dense HBM tensor.

All functions are pure and vmappable over a batch of env instances.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from .constants import EMPTY, GOAL, WALL
from .core import (
    MultiGridParams, MultiGridState, compute_metrics, empty_grid, encode_grid,
    decode_grid, free_cell_mask, gen_obs, init_state, reset_agent,
    sample_cell_from_mask, step_agent,
)

# ACCEL editor action sets (reference adversarial.py:40-56).
EDITOR_ACTION_SPACES = {
    'walls_none': ('-', '.'),
    'walls_none_goal': ('-', '.', 'g'),
    'walls_none_agent_goal': ('-', '.', 'a', 'g'),
}


class AdversarialMultiGrid:
    """Functional UED MultiGrid env.

    Methods take and return :class:`MultiGridState`; use ``jax.vmap`` over the
    leading batch axis.  ``params`` is static configuration.
    """

    def __init__(self, params: MultiGridParams | None = None, **kwargs):
        self.params = params or MultiGridParams(**kwargs)

    # -- spaces ------------------------------------------------------------
    @property
    def obs_shapes(self):
        v = self.params.agent_view_size
        return {'image': (v, v, 3), 'direction': ()}

    @property
    def adversary_obs_shapes(self):
        p = self.params
        return {
            'image': (p.width, p.height, 3),
            'time_step': (),
            'random_z': (p.random_z_dim,),
        }

    @property
    def num_actions(self) -> int:
        return 7

    @property
    def adversary_num_actions(self) -> int:
        return self.params.adversary_action_dim

    @property
    def adversary_rollout_steps(self) -> int:
        return self.params.adversary_max_steps

    @property
    def level_shape(self):
        return (self.params.width, self.params.height, 3)

    @property
    def level_dtype(self):
        import jax.numpy as jnp
        return jnp.uint8

    @property
    def max_episode_steps(self) -> int:
        return self.params.max_steps

    # -- observation helpers ----------------------------------------------
    def _adversary_obs(self, state: MultiGridState, rng: jax.Array) -> dict:
        return {
            'image': encode_grid(state),
            'time_step': state.adv_step_count,
            'random_z': jax.random.uniform(rng, (self.params.random_z_dim,)),
        }

    # -- UED protocol ------------------------------------------------------
    def reset(self, rng: jax.Array) -> Tuple[MultiGridState, dict]:
        """Empty grid ready for adversary construction (reference reset())."""
        p = self.params
        rng_dir, rng_z = jax.random.split(rng)
        state = init_state(p).replace(
            agent_start_dir=jax.random.randint(rng_dir, (), 0, 4),
        )
        return state, self._adversary_obs(state, rng_z)

    def step_adversary(
        self, state: MultiGridState, loc: jnp.ndarray, rng: jax.Array
    ) -> Tuple[MultiGridState, dict, jnp.ndarray]:
        """One constructive teacher move → (state, obs, done).

        Reference: adversarial.py:452-539.  ``loc`` indexes the interior
        (size-2)^2 cells.  Goal/agent placement order follows
        ``choose_goal_last``; remaining moves drop walls on empty cells.  The
        teacher episode always lasts ``n_clutter + 2`` steps; moves beyond
        ``adv_max_steps`` (variable-block mode) are no-ops.
        """
        p = self.params
        loc = loc.astype(jnp.int32)
        interior = p.width - 2
        x = loc % interior + 1
        y = loc // interior + 1

        rng_noise, rng_goalpos, rng_agent, rng_z = jax.random.split(rng, 4)

        # Variable block-budget: first action sets the budget
        # (adversarial.py:469-472).
        if p.resample_n_clutter:
            first = state.adv_step_count == 0
            sampled_max = (
                (loc * p.n_clutter) // p.adversary_action_dim + 2
            ).astype(jnp.int32)
            adv_max_steps = jnp.where(first, sampled_max, state.adv_max_steps)
        else:
            adv_max_steps = state.adv_max_steps

        t = state.adv_step_count
        active = t < adv_max_steps
        if p.choose_goal_last:
            choose_goal = active & (t == adv_max_steps - 2)
            choose_agent = active & (t == adv_max_steps - 1)
        else:
            choose_goal = active & (t == 0)
            choose_agent = active & (t == 1)
        place_wall = active & ~choose_goal & ~choose_agent

        grid = state.grid
        cell = grid[x, y].astype(jnp.int32)
        n_clutter_placed = state.n_clutter_placed
        goal_pos = state.goal_pos
        agent_start_pos = state.agent_start_pos

        # --- place goal (clearing any wall there) -------------------------
        goal_here = choose_goal
        if p.goal_noise > 0:
            noisy = jax.random.uniform(rng_noise) < p.goal_noise
            goal_here = choose_goal & ~noisy
            # Noisy: uniform over free cells.
            rand_pos = sample_cell_from_mask(rng_goalpos, grid == EMPTY)
            grid = jnp.where(
                choose_goal & noisy,
                grid.at[rand_pos[0], rand_pos[1]].set(GOAL),
                grid,
            )
            goal_pos = jnp.where(choose_goal & noisy, rand_pos, goal_pos)

        removed_wall = goal_here & (cell == WALL)
        n_clutter_placed = n_clutter_placed - removed_wall.astype(jnp.int32)
        grid = jnp.where(goal_here, grid.at[x, y].set(GOAL), grid)
        goal_pos = jnp.where(goal_here, jnp.stack([x, y]), goal_pos)

        # --- place agent --------------------------------------------------
        cell_after_goal = grid[x, y].astype(jnp.int32)
        agent_removed_wall = choose_agent & (cell_after_goal == WALL)
        n_clutter_placed = n_clutter_placed - agent_removed_wall.astype(jnp.int32)
        grid = jnp.where(choose_agent & (cell_after_goal == WALL),
                         grid.at[x, y].set(EMPTY), grid)
        cell_cleared = grid[x, y].astype(jnp.int32)
        # Goal already at (x, y) → place the agent uniformly at random
        # (adversarial.py:504-512).
        collide = choose_agent & (cell_cleared != EMPTY)
        rand_agent = sample_cell_from_mask(rng_agent, grid == EMPTY)
        agent_xy = jnp.where(collide, rand_agent, jnp.stack([x, y]))
        agent_start_pos = jnp.where(choose_agent, agent_xy, agent_start_pos)

        # --- place wall (no-op on occupied cells; the reference grid holds
        # the Agent object, so the agent's cell is occupied too) -----------
        on_agent = (agent_start_pos[0] == x) & (agent_start_pos[1] == y) \
            & (agent_start_pos[0] >= 0)
        wall_ok = place_wall & (grid[x, y].astype(jnp.int32) == EMPTY) \
            & ~on_agent
        grid = jnp.where(wall_ok, grid.at[x, y].set(WALL), grid)
        n_clutter_placed = n_clutter_placed + wall_ok.astype(jnp.int32)

        adv_step_count = t + 1
        done = adv_step_count >= p.adversary_max_steps  # static horizon

        state = state.replace(
            grid=grid,
            goal_pos=goal_pos,
            agent_start_pos=agent_start_pos,
            adv_step_count=adv_step_count,
            adv_max_steps=adv_max_steps,
            n_clutter_placed=n_clutter_placed,
        )
        state = jax.lax.cond(
            done, lambda s: compute_metrics(s, p), lambda s: s, state
        )
        return state, self._adversary_obs(state, rng_z), done

    def reset_random(self, rng: jax.Array) -> Tuple[MultiGridState, dict]:
        """Domain-randomized level (reference reset_random, :541-581).

        Goal and agent uniform over free cells, then ``n_clutter // 2`` walls
        (or U[0, n_clutter) walls in variable-block mode) dropped uniformly at
        random on free cells.
        """
        p = self.params
        rng_goal, rng_agent, rng_dir, rng_n, rng_walls = jax.random.split(rng, 5)
        state = init_state(p)
        grid = state.grid

        goal = sample_cell_from_mask(rng_goal, grid == EMPTY)
        grid = grid.at[goal[0], goal[1]].set(GOAL)

        agent = sample_cell_from_mask(rng_agent, grid == EMPTY)
        agent_dir = jax.random.randint(rng_dir, (), 0, 4)

        if p.resample_n_clutter:
            n_walls = jax.random.randint(rng_n, (), 0, max(p.n_clutter, 1))
        else:
            n_walls = jnp.int32(p.n_clutter // 2)

        max_walls = max(p.n_clutter // 2, p.n_clutter if p.resample_n_clutter else 0)

        def place_one(i, carry):
            grid, placed, rng = carry
            rng, sub = jax.random.split(rng)
            mask = (grid == EMPTY).at[agent[0], agent[1]].set(False)
            pos = sample_cell_from_mask(sub, mask)
            do = i < n_walls
            grid = jnp.where(
                do & jnp.any(mask), grid.at[pos[0], pos[1]].set(WALL), grid
            )
            placed = placed + (do & jnp.any(mask)).astype(jnp.int32)
            return grid, placed, rng

        grid, placed, _ = jax.lax.fori_loop(
            0, max_walls, place_one, (grid, jnp.int32(0), rng_walls)
        )

        state = state.replace(
            grid=grid,
            goal_pos=goal,
            agent_start_pos=agent,
            agent_start_dir=agent_dir,
            n_clutter_placed=placed,
            adv_step_count=jnp.int32(p.adversary_max_steps),
        )
        state = compute_metrics(state, p)
        return reset_agent(state, p)

    # -- levels ------------------------------------------------------------
    def get_level(self, state: MultiGridState) -> jnp.ndarray:
        """Level = start-of-episode grid encoding (agent at start pos)."""
        enc_state = state.replace(
            agent_pos=state.agent_start_pos, agent_dir=state.agent_start_dir
        )
        return encode_grid(enc_state)

    def reset_to_level(
        self, level: jnp.ndarray
    ) -> Tuple[MultiGridState, dict]:
        """Rebuild state from a (W, H, 3) encoding (reference reset_to_encoding)."""
        p = self.params
        grid, agent_pos, agent_dir, goal_pos = decode_grid(level, p)
        n_walls = (grid[1:-1, 1:-1] == WALL).sum().astype(jnp.int32)
        state = init_state(p).replace(
            grid=grid,
            agent_start_pos=agent_pos,
            agent_start_dir=agent_dir,
            goal_pos=goal_pos,
            n_clutter_placed=n_walls,
            adv_step_count=jnp.int32(p.adversary_max_steps),
        )
        state = compute_metrics(state, p)
        return reset_agent(state, p)

    def mutate_level(
        self, state: MultiGridState, rng: jax.Array, num_edits: int
    ) -> Tuple[MultiGridState, dict]:
        """ACCEL mutation operator (reference adversarial.py:317-397).

        ``num_edits`` interior locations are drawn with replacement; each gets
        a random editor action (wall / clear / move-agent / move-goal).  The
        reference dedups repeated locations — sampling with replacement and
        applying sequentially is equivalent except when the same location
        draws two different actions (later overwrites earlier either way).
        Goal and agent are re-placed uniformly if an edit removed them.
        """
        p = self.params
        actions = EDITOR_ACTION_SPACES[p.editor_actions]
        interior = p.width - 2
        num_tiles = interior * interior

        rng_loc, rng_act, rng_seq, rng_goal, rng_agent = jax.random.split(rng, 5)
        locs = jax.random.randint(rng_loc, (num_edits,), 0, num_tiles)
        act_idx = jax.random.randint(rng_act, (num_edits,), 0, len(actions))

        grid = state.grid
        goal_pos = state.goal_pos
        agent_pos = state.agent_start_pos

        def apply_edit(carry, inp):
            grid, goal_pos, agent_pos = carry
            loc, a = inp
            x = loc % interior + 1
            y = loc // interior + 1
            # _clean_loc: clear the cell; dropping goal/agent marks them gone.
            was_goal = (goal_pos[0] == x) & (goal_pos[1] == y)
            was_agent = (agent_pos[0] == x) & (agent_pos[1] == y)
            goal_pos = jnp.where(was_goal, jnp.array([-1, -1]), goal_pos)
            agent_pos = jnp.where(was_agent, jnp.array([-1, -1]), agent_pos)
            grid = grid.at[x, y].set(EMPTY)

            is_wall = a == actions.index('-')
            grid = jnp.where(is_wall, grid.at[x, y].set(WALL), grid)
            if 'g' in actions:
                is_goal = a == actions.index('g')
                old = goal_pos
                grid = jnp.where(
                    is_goal & (old[0] >= 0),
                    grid.at[jnp.maximum(old[0], 0), jnp.maximum(old[1], 0)]
                    .set(EMPTY),
                    grid,
                )
                grid = jnp.where(is_goal, grid.at[x, y].set(GOAL), grid)
                goal_pos = jnp.where(is_goal, jnp.stack([x, y]), goal_pos)
            if 'a' in actions:
                is_agent = a == actions.index('a')
                agent_pos = jnp.where(is_agent, jnp.stack([x, y]), agent_pos)
            return (grid, goal_pos, agent_pos), None

        (grid, goal_pos, agent_pos), _ = jax.lax.scan(
            apply_edit, (grid, goal_pos, agent_pos),
            (locs.astype(jnp.int32), act_idx.astype(jnp.int32)),
        )

        # Ensure goal exists (uniform over free cells).
        def occupied_mask(grid, agent_pos):
            m = grid == EMPTY
            has = agent_pos[0] >= 0
            return m.at[jnp.maximum(agent_pos[0], 0),
                        jnp.maximum(agent_pos[1], 0)].set(
                m[jnp.maximum(agent_pos[0], 0), jnp.maximum(agent_pos[1], 0)]
                & ~has)

        need_goal = goal_pos[0] < 0
        gpos = sample_cell_from_mask(rng_goal, occupied_mask(grid, agent_pos))
        grid = jnp.where(need_goal, grid.at[gpos[0], gpos[1]].set(GOAL), grid)
        goal_pos = jnp.where(need_goal, gpos, goal_pos)

        need_agent = agent_pos[0] < 0
        apos = sample_cell_from_mask(rng_agent, grid == EMPTY)
        agent_pos = jnp.where(need_agent, apos, agent_pos)

        n_walls = (grid[1:-1, 1:-1] == WALL).sum().astype(jnp.int32)
        state = state.replace(
            grid=grid,
            goal_pos=goal_pos,
            agent_start_pos=agent_pos,
            n_clutter_placed=n_walls,
            step_count=jnp.int32(0),
            adv_step_count=jnp.int32(p.adversary_max_steps),
        )
        state = compute_metrics(state, p)
        return reset_agent(state, p)

    def reset_alp_gmm(self, task: jnp.ndarray, rng: jax.Array):
        """ALP-GMM task = teacher action sequence (floats → action ids)
        replayed through step_adversary (runner _init_alp_gmm bounds:
        {'actions': [0, (size-2)^2, n_steps]})."""
        p = self.params
        rng, r0 = jax.random.split(rng)
        state, _ = self.reset(r0)
        n = task.shape[0]

        def body(carry, a):
            state, rng = carry
            rng, sub = jax.random.split(rng)
            a = jnp.clip(jnp.round(a), 0, p.adversary_action_dim - 1)
            state, _, _ = self.step_adversary(state, a.astype(jnp.int32), sub)
            return (state, rng), None

        (state, rng), _ = jax.lax.scan(body, (state, rng), task)
        # finish any remaining design steps with no-op walls at loc 0
        extra = p.adversary_max_steps - n
        for _ in range(max(extra, 0)):
            rng, sub = jax.random.split(rng)
            state, _, _ = self.step_adversary(state, jnp.int32(0), sub)
        return reset_agent(state, p)

    # -- student -----------------------------------------------------------
    def reset_agent(self, state: MultiGridState) -> Tuple[MultiGridState, dict]:
        return reset_agent(state, self.params)

    def step(self, state, action, rng=None):
        """→ (state, obs, reward, done, info) with time-limit truncation flag.

        ``truncated`` mirrors the reference TimeLimit wrapper semantics
        (wrappers/time_limit.py:24-33): done due to the step budget rather
        than a terminal goal/lava event.
        """
        state, obs, reward, done = step_agent(state, action, self.params)
        info = {'truncated': done & ~state.agent_done}
        return state, obs, reward, done, info
