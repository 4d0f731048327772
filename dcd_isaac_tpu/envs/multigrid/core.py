"""Pure-JAX MultiGrid engine.

An accelerator-native re-design of the reference's object-graph grid engine
(reference: envs/multigrid/multigrid.py:341-1039).  The grid is a dense
(W, H) uint8 array of MiniGrid cell-type codes indexed ``grid[x, y]`` (the
reference's image layout), the single agent is an overlay (pos, dir) rather
than an in-grid object, and every transition is a masked array update so
thousands of env instances step in lockstep under ``jit``/``vmap``.

Semantics reproduced exactly (single-agent, ``minigrid_mode``):
  * step order: bump step_count, act, regenerate obs, terminate on
    goal/lava/timeout (multigrid.py:866-975)
  * reward on goal: ``1 - 0.9 * step_count / max_steps`` (minigrid _reward)
  * egocentric view: slice + rotate-left (dir+1) with wall padding and the
    agent's own cell blanked (multigrid.py:977-1015)
  * occlusion masking when ``see_through_walls=False`` (minigrid process_vis)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .constants import (
    AGENT, DIR_TO_VEC, EMPTY, GOAL, LAVA, TYPE_COLOR, UNSEEN, WALKABLE, WALL,
    FORWARD, LEFT, RIGHT,
)
from ...utils import struct


@dataclasses.dataclass(frozen=True)
class MultiGridParams:
    """Static configuration (hashable; safe to close over under jit)."""
    size: int = 15
    agent_view_size: int = 5
    max_steps: int = 250
    see_through_walls: bool = True
    n_clutter: int = 50
    resample_n_clutter: bool = False
    choose_goal_last: bool = False
    goal_noise: float = 0.0
    random_z_dim: int = 50
    editor_actions: str = 'walls_none_agent_goal'
    full_obs: bool = False  # add 'full_obs' (MultiGridFullyObsWrapper)

    @property
    def width(self) -> int:
        return self.size

    @property
    def height(self) -> int:
        return self.size

    @property
    def adversary_max_steps(self) -> int:
        return self.n_clutter + 2

    @property
    def adversary_action_dim(self) -> int:
        return (self.size - 2) ** 2

    @property
    def max_shortest_path(self) -> int:
        return (self.size - 2) * (self.size - 2) + 1


@struct.dataclass
class MultiGridState:
    """Dynamic env state; a pytree of arrays, one leaf-set per instance."""
    grid: jnp.ndarray           # (W, H) uint8 cell types (no agent overlay)
    agent_pos: jnp.ndarray      # (2,) int32 (x, y); (-1, -1) when unplaced
    agent_dir: jnp.ndarray      # () int32
    agent_done: jnp.ndarray     # () bool — reached goal/lava this episode
    step_count: jnp.ndarray     # () int32
    agent_start_pos: jnp.ndarray  # (2,) int32; (-1, -1) when unplaced
    agent_start_dir: jnp.ndarray  # () int32
    goal_pos: jnp.ndarray       # (2,) int32; (-1, -1) when unplaced
    # Adversary bookkeeping
    adv_step_count: jnp.ndarray  # () int32
    adv_max_steps: jnp.ndarray   # () int32 (≠ static when resample_n_clutter)
    n_clutter_placed: jnp.ndarray  # () int32
    # Cached level metrics (recomputed when the level changes)
    passable: jnp.ndarray       # () bool
    shortest_path_length: jnp.ndarray  # () int32
    distance_to_goal: jnp.ndarray      # () int32


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------

def empty_grid(params: MultiGridParams) -> jnp.ndarray:
    """Interior-empty grid with the surrounding wall rectangle."""
    w, h = params.width, params.height
    grid = jnp.full((w, h), EMPTY, dtype=jnp.uint8)
    grid = grid.at[0, :].set(WALL)
    grid = grid.at[-1, :].set(WALL)
    grid = grid.at[:, 0].set(WALL)
    grid = grid.at[:, -1].set(WALL)
    return grid


def init_state(params: MultiGridParams) -> MultiGridState:
    neg = jnp.array([-1, -1], dtype=jnp.int32)
    return MultiGridState(
        grid=empty_grid(params),
        agent_pos=neg,
        agent_dir=jnp.int32(0),
        agent_done=jnp.bool_(False),
        step_count=jnp.int32(0),
        agent_start_pos=neg,
        agent_start_dir=jnp.int32(0),
        goal_pos=neg,
        adv_step_count=jnp.int32(0),
        adv_max_steps=jnp.int32(params.adversary_max_steps),
        n_clutter_placed=jnp.int32(0),
        passable=jnp.bool_(False),
        shortest_path_length=jnp.int32(params.max_shortest_path),
        distance_to_goal=jnp.int32(-1),
    )


def free_cell_mask(state: MultiGridState) -> jnp.ndarray:
    """(W, H) bool mask of empty cells not occupied by the agent."""
    mask = state.grid == EMPTY
    has_agent = state.agent_pos[0] >= 0
    agent_cell = (
        jnp.zeros_like(mask)
        .at[state.agent_pos[0], state.agent_pos[1]]
        .set(has_agent)
    )
    return mask & ~agent_cell


def sample_cell_from_mask(rng: jax.Array, mask: jnp.ndarray) -> jnp.ndarray:
    """Uniformly sample an (x, y) cell where ``mask`` is True.

    Exact-uniform replacement for the reference's rejection sampling
    (multigrid.py:place_obj).  Falls back to cell (0, 0) if the mask is empty
    (callers guarantee non-empty in practice).
    """
    w = mask.shape[0]
    logits = jnp.where(mask.ravel(), 0.0, -jnp.inf)
    flat = jax.random.categorical(rng, logits)
    flat = jnp.where(jnp.any(mask), flat, 0)
    return jnp.stack([flat // mask.shape[1], flat % mask.shape[1]]).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Encoding (byte-compatible with the reference's Grid.encode())
# ---------------------------------------------------------------------------

def encode_grid(state: MultiGridState) -> jnp.ndarray:
    """Full-grid (W, H, 3) uint8 encoding with agent overlay.

    Matches reference multigrid.py:138-149 / Agent.encode(): channels are
    (type, color, state); the agent encodes as (AGENT, agent_id=0, dir).
    """
    types = state.grid
    colors = jnp.asarray(TYPE_COLOR)[types.astype(jnp.int32)]
    states = jnp.zeros_like(types)
    enc = jnp.stack([types, colors, states], axis=-1)
    has_agent = state.agent_pos[0] >= 0
    agent_code = jnp.stack(
        [jnp.uint8(AGENT), jnp.uint8(0), state.agent_dir.astype(jnp.uint8)]
    )
    x = jnp.maximum(state.agent_pos[0], 0)
    y = jnp.maximum(state.agent_pos[1], 0)
    enc = enc.at[x, y, :].set(
        jnp.where(has_agent, agent_code, enc[x, y, :])
    )
    return enc


def decode_grid(
    encoding: jnp.ndarray, params: MultiGridParams
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Invert :func:`encode_grid` → (grid, agent_pos, agent_dir, goal_pos).

    Mirrors reference Grid.set_encoding (multigrid.py:264-280): the agent and
    goal positions are recovered from their cell codes; the agent cell reverts
    to EMPTY in the type grid.  Missing agent/goal → (-1, -1).
    """
    types = encoding[..., 0].astype(jnp.uint8)

    def find(type_code):
        hit = types == type_code
        any_hit = jnp.any(hit)
        flat = jnp.argmax(hit.ravel())
        pos = jnp.stack([flat // types.shape[1], flat % types.shape[1]])
        return jnp.where(any_hit, pos, jnp.array([-1, -1])).astype(jnp.int32), any_hit

    agent_pos, has_agent = find(AGENT)
    goal_pos, _ = find(GOAL)
    ax = jnp.maximum(agent_pos[0], 0)
    ay = jnp.maximum(agent_pos[1], 0)
    agent_dir = jnp.where(
        has_agent, encoding[ax, ay, 2].astype(jnp.int32), jnp.int32(0)
    )
    grid = jnp.where(types == AGENT, jnp.uint8(EMPTY), types)
    # Any 'unseen' codes (shouldn't occur in level encodings) become empty.
    grid = jnp.where(grid == UNSEEN, jnp.uint8(EMPTY), grid)
    return grid, agent_pos, agent_dir, goal_pos


# ---------------------------------------------------------------------------
# Observation generation
# ---------------------------------------------------------------------------

def _rotate_left(a: jnp.ndarray) -> jnp.ndarray:
    """Reference Grid.rotate_left for [x, y]-indexed arrays: B = A.T[:, ::-1]."""
    return jnp.swapaxes(a, 0, 1)[:, ::-1]


def _process_vis(view: jnp.ndarray, view_size: int) -> jnp.ndarray:
    """MiniGrid occlusion flood (process_vis) on a rotated [x, y] view.

    The agent sits at (view_size // 2, view_size - 1).  Statically unrolled —
    the view is tiny (5x5 or 7x7).
    """
    v = view_size
    see_behind = view != WALL  # walls are the only occluders in this suite
    mask = jnp.zeros((v, v), dtype=jnp.bool_).at[v // 2, v - 1].set(True)

    for j in reversed(range(v)):
        for i in range(v - 1):
            cond = mask[i, j] & see_behind[i, j]
            mask = mask.at[i + 1, j].set(mask[i + 1, j] | cond)
            if j > 0:
                mask = mask.at[i + 1, j - 1].set(mask[i + 1, j - 1] | cond)
                mask = mask.at[i, j - 1].set(mask[i, j - 1] | cond)
        for i in reversed(range(1, v)):
            cond = mask[i, j] & see_behind[i, j]
            mask = mask.at[i - 1, j].set(mask[i - 1, j] | cond)
            if j > 0:
                mask = mask.at[i - 1, j - 1].set(mask[i - 1, j - 1] | cond)
                mask = mask.at[i, j - 1].set(mask[i, j - 1] | cond)
    return mask


@functools.lru_cache()
def _view_offset_table(v: int) -> np.ndarray:
    """(4, v, v, 2) grid offsets per direction for the egocentric view.

    View cell (i, j) — agent at (v//2, v-1) facing "up" — maps to
    ``agent_pos + forward·(v-1-j) + right·(i - v//2)``.  One static table
    turns the reference's slice+rotate pipeline (multigrid.py:977-996)
    into a single batched gather, the hot op of every env step.
    """
    vecs = np.array([(1, 0), (0, 1), (-1, 0), (0, -1)], np.int32)
    offs = np.zeros((4, v, v, 2), np.int32)
    for d in range(4):
        f, r = vecs[d], vecs[(d + 1) % 4]
        for i in range(v):
            for j in range(v):
                offs[d, i, j] = f * (v - 1 - j) + r * (i - v // 2)
    return offs


def gen_obs(state: MultiGridState, params: MultiGridParams) -> dict:
    """Egocentric partial observation {'image': (v, v, 3) uint8, 'direction': ()}.

    Reference: multigrid.py:977-1041 (gen_obs_grid + encode), re-expressed
    as one gather through a static offset table (out-of-bounds reads as
    Wall, like Grid.slice's padding).
    """
    v = params.agent_view_size
    W, H = params.width, params.height
    d = state.agent_dir

    coords = state.agent_pos[None, None, :] + jnp.asarray(
        _view_offset_table(v))[d]                       # (v, v, 2)
    inb = ((coords[..., 0] >= 0) & (coords[..., 0] < W)
           & (coords[..., 1] >= 0) & (coords[..., 1] < H))
    flat = (jnp.clip(coords[..., 0], 0, W - 1) * H
            + jnp.clip(coords[..., 1], 0, H - 1))
    window = jnp.where(inb, state.grid.reshape(-1)[flat], jnp.uint8(WALL))

    # The agent's own cell shows what it carries (nothing here) → empty.
    window = window.at[v // 2, v - 1].set(EMPTY)

    if params.see_through_walls:
        vis = jnp.ones((v, v), dtype=jnp.bool_)
    else:
        vis = _process_vis(window, v)

    types = jnp.where(vis, window, jnp.uint8(UNSEEN))
    colors = jnp.where(
        vis, jnp.asarray(TYPE_COLOR)[window.astype(jnp.int32)], jnp.uint8(0))
    img = jnp.stack([types, colors, jnp.zeros_like(types)], axis=-1)
    obs = {'image': img, 'direction': d}
    if params.full_obs:
        obs['full_obs'] = encode_grid(state)
    return obs


# ---------------------------------------------------------------------------
# Agent step
# ---------------------------------------------------------------------------

def step_agent(
    state: MultiGridState, action: jnp.ndarray, params: MultiGridParams
) -> Tuple[MultiGridState, dict, jnp.ndarray, jnp.ndarray]:
    """One agent step → (state, obs, reward, done).

    Reference: multigrid.py:866-975 (step_one_agent + step), competitive
    single-agent mode.  ``done`` does NOT auto-reset; harness handles that.
    """
    step_count = state.step_count + 1
    action = action.astype(jnp.int32)

    d = state.agent_dir
    new_dir = jnp.where(
        action == LEFT, (d + 3) % 4, jnp.where(action == RIGHT, (d + 1) % 4, d)
    )

    fwd = state.agent_pos + jnp.asarray(DIR_TO_VEC)[d]
    fwd_type = state.grid[fwd[0], fwd[1]].astype(jnp.int32)

    is_fwd = action == FORWARD
    hit_goal = is_fwd & (fwd_type == GOAL)
    hit_lava = is_fwd & (fwd_type == LAVA)
    moved = is_fwd & jnp.asarray(WALKABLE)[fwd_type]

    new_pos = jnp.where(moved, fwd, state.agent_pos)
    reward = jnp.where(
        hit_goal,
        1.0 - 0.9 * (step_count.astype(jnp.float32) / params.max_steps),
        0.0,
    )
    agent_done = state.agent_done | hit_goal | hit_lava
    done = agent_done | (step_count >= params.max_steps)

    state = state.replace(
        agent_pos=new_pos,
        agent_dir=new_dir,
        agent_done=agent_done,
        step_count=step_count,
    )
    obs = gen_obs(state, params)
    return state, obs, reward, done


def reset_agent(
    state: MultiGridState, params: MultiGridParams
) -> Tuple[MultiGridState, dict]:
    """Reset the agent onto its start position, keeping the level intact.

    Reference: adversarial.py:238-269.
    """
    state = state.replace(
        agent_pos=state.agent_start_pos,
        agent_dir=state.agent_start_dir,
        agent_done=jnp.bool_(False),
        step_count=jnp.int32(0),
    )
    return state, gen_obs(state, params)


# ---------------------------------------------------------------------------
# Shortest path / passability (in-jit BFS by parallel relaxation)
# ---------------------------------------------------------------------------

def shortest_path(
    grid: jnp.ndarray,
    start: jnp.ndarray,
    goal: jnp.ndarray,
    params: MultiGridParams,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(passable, shortest_path_length) between start and goal.

    Replaces the reference's networkx grid-graph query
    (adversarial.py:423-447) with a fixed-point distance relaxation over the
    open-cell mask — a handful of vectorized shift-mins instead of a host-side
    graph algorithm, so it can run inside the jitted pipeline (needed for
    ``reject_unsolvable_seeds``).
    """
    inf = jnp.int32(params.max_shortest_path)
    open_mask = grid != WALL
    # Exterior boundary is walls, so interior relaxation never leaks out.
    valid = (start[0] >= 0) & (goal[0] >= 0)
    sx = jnp.maximum(start[0], 0)
    sy = jnp.maximum(start[1], 0)

    dist0 = jnp.full(grid.shape, inf, dtype=jnp.int32).at[sx, sy].set(0)
    dist0 = jnp.where(open_mask, dist0, inf)

    def body(carry):
        dist, _ = carry
        up = jnp.full_like(dist, inf).at[:, 1:].set(dist[:, :-1])
        down = jnp.full_like(dist, inf).at[:, :-1].set(dist[:, 1:])
        left = jnp.full_like(dist, inf).at[1:, :].set(dist[:-1, :])
        right = jnp.full_like(dist, inf).at[:-1, :].set(dist[1:, :])
        nbr = jnp.minimum(jnp.minimum(up, down), jnp.minimum(left, right))
        new = jnp.minimum(dist, jnp.minimum(nbr + 1, inf))
        new = jnp.where(open_mask, new, inf)
        return new, jnp.any(new != dist)

    def cond(carry):
        return carry[1]

    dist, _ = jax.lax.while_loop(cond, body, (dist0, jnp.bool_(True)))
    d = dist[jnp.maximum(goal[0], 0), jnp.maximum(goal[1], 0)]
    passable = valid & (d < inf)
    spl = jnp.where(passable, d, inf)
    return passable, spl


def compute_metrics(state: MultiGridState, params: MultiGridParams) -> MultiGridState:
    """Recompute passability/shortest-path/manhattan-distance level metrics."""
    passable, spl = shortest_path(
        state.grid, state.agent_start_pos, state.goal_pos, params
    )
    dist = jnp.abs(state.goal_pos - state.agent_start_pos).sum()
    has_both = (state.agent_start_pos[0] >= 0) & (state.goal_pos[0] >= 0)
    return state.replace(
        passable=passable,
        shortest_path_length=spl,
        distance_to_goal=jnp.where(has_both, dist, -1).astype(jnp.int32),
    )
