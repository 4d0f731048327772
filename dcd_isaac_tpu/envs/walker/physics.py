"""Pure-JAX 2D rigid-body physics for the BipedalWalker.

Replaces Box2D (reference envs/bipedalwalker/walker_env.py:120-541,
``b2World.Step(1/50, 180, 60)``) with a batched impulse solver designed for
an accelerator: the walker is a fixed-topology articulated body (hull + 4 leg segments,
4 revolute joints with motors and limits) colliding with static terrain
(a heightfield edge-chain + axis-aligned obstacle boxes).  All state is a
small pytree of arrays; thousands of walkers step in lockstep under
jit/vmap with no host round trips.

Solver: sequential impulses per Box2D's algorithm — joints solved
Gauss-Seidel, contacts solved Jacobi with under-relaxation (batched over
contact points so the sequential depth per velocity iteration is O(joints),
not O(contacts)); Baumgarte stabilization replaces Box2D's position solver.
Iteration counts are much lower than the reference's 180/60 (they are far
past convergence for 5 bodies); stability was the design target, not
bit-exact Box2D trajectories (the target is behavioural parity).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ...utils import struct

# --- constants (walker_env.py:33-57) --------------------------------------
FPS = 50
DT = 1.0 / FPS
SCALE = 30.0
MOTORS_TORQUE = 80.0
SPEED_HIP = 4.0
SPEED_KNEE = 6.0
LIDAR_RANGE = 160.0 / SCALE
INITIAL_RANDOM = 5.0
LEG_DOWN = -8.0 / SCALE
LEG_W, LEG_H = 8.0 / SCALE, 34.0 / SCALE
VIEWPORT_W, VIEWPORT_H = 600, 400
TERRAIN_STEP = 14.0 / SCALE
TERRAIN_LENGTH = 200
TERRAIN_HEIGHT = VIEWPORT_H / SCALE / 4
TERRAIN_GRASS = 10
TERRAIN_STARTPAD = 20
FRICTION = 2.5
GRAVITY = -10.0

HULL_POLY = np.array(
    [(-30, 9), (6, 9), (34, 1), (34, -8), (-30, -8)], np.float64) / SCALE

NUM_BODIES = 5          # 0 hull, 1 upper-L, 2 lower-L, 3 upper-R, 4 lower-R
VEL_ITERS = 40
# Unroll factor for the velocity-solver scan (numerics identical for any
# value). 1 was chosen on the earlier (pre-GPU) build and is not yet measured on
# the GPU.
VEL_UNROLL = 1
# Full-f32 passes for the small rotation contractions: on the GPU an f32
# matmul at default precision may run in TF32 (10-bit mantissa), far
# coarser than the Box2D parity envelopes. The dots are tiny, so the cost
# is nil.
HIGHEST = jax.lax.Precision.HIGHEST
POS_BAUMGARTE = 0.2
PEN_SLOP = 0.005


def _polygon_mass(verts, density):
    """Box2D b2PolygonShape::ComputeMass (area, centroid, inertia)."""
    # ensure counter-clockwise winding (Box2D normalizes hulls; the gym
    # HULL_POLY is listed clockwise)
    signed = 0.0
    for i in range(len(verts)):
        p1, p2 = verts[i], verts[(i + 1) % len(verts)]
        signed += p1[0] * p2[1] - p2[0] * p1[1]
    if signed < 0:
        verts = verts[::-1]
    area = 0.0
    c = np.zeros(2)
    I = 0.0
    ref = verts[0]
    for i in range(len(verts)):
        p1 = verts[i] - ref
        p2 = verts[(i + 1) % len(verts)] - ref
        cross = p1[0] * p2[1] - p1[1] * p2[0]
        tri_area = 0.5 * cross
        area += tri_area
        c += tri_area / 3.0 * (p1 + p2)
        intx2 = p1[0] ** 2 + p1[0] * p2[0] + p2[0] ** 2
        inty2 = p1[1] ** 2 + p1[1] * p2[1] + p2[1] ** 2
        I += (0.25 / 3.0) * cross * (intx2 + inty2)
    c /= area
    mass = density * area
    # inertia about centroid
    I = density * I - mass * (c @ c)
    c += ref
    return mass, c, I


def _box_verts(hw, hh):
    return np.array([(-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)], np.float64)


# Per-body local vertices (padded to 5) and mass properties.
_LEG_V = _box_verts(LEG_W / 2, LEG_H / 2)
_LOWER_V = _box_verts(0.8 * LEG_W / 2, LEG_H / 2)


def _pad5(v):
    out = np.zeros((5, 2))
    out[:len(v)] = v
    out[len(v):] = v[-1]
    return out


BODY_VERTS = np.stack([
    _pad5(HULL_POLY), _pad5(_LEG_V), _pad5(_LOWER_V),
    _pad5(_LEG_V), _pad5(_LOWER_V)])              # (5, 5, 2)
BODY_NVERTS = np.array([5, 4, 4, 4, 4])
_hm, _hc, _hI = _polygon_mass(HULL_POLY, 5.0)
_lm, _lc, _lI = _polygon_mass(_LEG_V, 1.0)
_wm, _wc, _wI = _polygon_mass(_LOWER_V, 1.0)
# Box2D stores centroid-relative dynamics; our shapes are centroid-centered
# for legs; the hull centroid is offset — shift hull verts so the body origin
# is its centroid (position bookkeeping below accounts for this at reset).
HULL_CENTROID = _hc
BODY_VERTS[0] -= _hc
BODY_MASS = np.array([_hm, _lm, _wm, _lm, _wm])
BODY_I = np.array([_hI, _lI, _wI, _lI, _wI])
INV_M = 1.0 / BODY_MASS
INV_I = 1.0 / BODY_I
# friction per body (HULL_FD 0.1; legs Box2D default 0.2); contact friction
# mixes with terrain friction 2.5 via sqrt(f1*f2)
BODY_FRICTION = np.array([0.1, 0.2, 0.2, 0.2, 0.2])
CONTACT_FRICTION = np.sqrt(BODY_FRICTION * FRICTION)

# Revolute joints: (bodyA, bodyB), local anchors (body-origin frame),
# limits, speed scale. Anchors on the hull are relative to its centroid.
JOINT_A = np.array([0, 1, 0, 3])
JOINT_B = np.array([1, 2, 3, 4])
JOINT_ANCHOR_A = np.array([
    [0.0, LEG_DOWN], [0.0, -LEG_H / 2],
    [0.0, LEG_DOWN], [0.0, -LEG_H / 2]])
JOINT_ANCHOR_A[0] -= HULL_CENTROID
JOINT_ANCHOR_A[2] -= HULL_CENTROID
JOINT_ANCHOR_B = np.array([
    [0.0, LEG_H / 2], [0.0, LEG_H / 2],
    [0.0, LEG_H / 2], [0.0, LEG_H / 2]])
JOINT_LOWER = np.array([-0.8, -1.6, -0.8, -1.6])
JOINT_UPPER = np.array([1.1, -0.1, 1.1, -0.1])
# referenceAngle = angleB - angleA at creation (hip: leg tilt ±0.05; knee: 0)
JOINT_REF = np.array([-0.05, 0.0, 0.05, 0.0])
JOINT_SPEED = np.array([SPEED_HIP, SPEED_KNEE, SPEED_HIP, SPEED_KNEE])

MAX_BOXES = 64          # static obstacle budget (stumps/stairs/pit walls)


@struct.dataclass
class Bodies:
    pos: jnp.ndarray     # (5, 2) centroid positions
    angle: jnp.ndarray   # (5,)
    vel: jnp.ndarray     # (5, 2)
    angvel: jnp.ndarray  # (5,)


@struct.dataclass
class Terrain:
    xs: jnp.ndarray          # (TERRAIN_LENGTH,) heightfield x
    ys: jnp.ndarray          # (TERRAIN_LENGTH,) heightfield y
    boxes: jnp.ndarray       # (MAX_BOXES, 4) x0, y0, x1, y1
    n_boxes: jnp.ndarray     # () int32


def rot(angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.stack([jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2)


def cross_sv(w, v):
    """scalar × vector (2D cross): w × v = (-w*v_y, w*v_x)."""
    return jnp.stack([-w * v[..., 1], w * v[..., 0]], -1)


def world_vertices(bodies: Bodies) -> jnp.ndarray:
    """(5, 5, 2) world-space vertices of every body."""
    R = rot(bodies.angle)                       # (5, 2, 2)
    return bodies.pos[:, None, :] + jnp.einsum(
        'bij,bvj->bvi', R, jnp.asarray(BODY_VERTS), precision=HIGHEST)


def ground_height(terrain: Terrain, x: jnp.ndarray):
    """Heightfield lookup with local segment normal → (y, normal (…,2))."""
    idx = jnp.clip(
        jnp.searchsorted(terrain.xs, x, side='right') - 1, 0,
        TERRAIN_LENGTH - 2)
    x0, x1 = terrain.xs[idx], terrain.xs[idx + 1]
    y0, y1 = terrain.ys[idx], terrain.ys[idx + 1]
    t = jnp.clip((x - x0) / jnp.maximum(x1 - x0, 1e-8), 0.0, 1.0)
    y = y0 + t * (y1 - y0)
    d = jnp.stack([x1 - x0, y1 - y0], -1)
    n = jnp.stack([-d[..., 1], d[..., 0]], -1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    return y, n


def _contact_candidates(bodies: Bodies, terrain: Terrain):
    """Vertex-vs-terrain contacts: (points, normals, penetration, body_idx).

    Flattened over 25 candidate vertices × (heightfield + boxes).
    """
    wv = world_vertices(bodies)                 # (5, 5, 2)
    body_idx = jnp.repeat(jnp.arange(NUM_BODIES), 5)
    pts = wv.reshape(-1, 2)                     # (25, 2)
    vert_valid = (jnp.arange(5)[None, :]
                  < jnp.asarray(BODY_NVERTS)[:, None]).reshape(-1)

    # heightfield
    gy, gn = ground_height(terrain, pts[:, 0])
    pen_h = (gy - pts[:, 1]) * gn[:, 1]  # approx depth along normal
    pen_h = jnp.where(vert_valid, pen_h, -1.0)

    # boxes: penetration = min-axis overlap
    b = terrain.boxes                            # (M, 4)
    box_valid = jnp.arange(MAX_BOXES) < terrain.n_boxes
    px = pts[:, 0][:, None]
    py = pts[:, 1][:, None]
    dx0 = px - b[None, :, 0]
    dx1 = b[None, :, 2] - px
    dy0 = py - b[None, :, 1]
    dy1 = b[None, :, 3] - py
    inside = (dx0 > 0) & (dx1 > 0) & (dy0 > 0) & (dy1 > 0)
    inside = inside & box_valid[None, :] & vert_valid[:, None]
    depths = jnp.stack([dx0, dx1, dy0, dy1], -1)      # (25, M, 4)
    min_axis = jnp.argmin(depths, -1)
    pen_b = jnp.where(inside, jnp.min(depths, -1), -1.0)
    normals_tab = jnp.array(
        [[-1.0, 0.0], [1.0, 0.0], [0.0, -1.0], [0.0, 1.0]])
    n_b = normals_tab[min_axis]                      # (25, M, 2)

    # take best box contact per vertex
    best_box = jnp.argmax(pen_b, axis=1)
    pen_box = jnp.max(pen_b, axis=1)
    n_box = jnp.take_along_axis(
        n_b, best_box[:, None, None].repeat(2, -1), 1).squeeze(1)

    use_box = pen_box > pen_h
    pen = jnp.where(use_box, pen_box, pen_h)
    normal = jnp.where(use_box[:, None], n_box, gn)
    return pts, normal, pen, body_idx


def physics_step(bodies: Bodies, terrain: Terrain,
                 motor_speed: jnp.ndarray, motor_torque: jnp.ndarray):
    """One 1/50s step → (bodies, lower_leg_contacts (2,), joint_angles (4,),
    joint_speeds (4,), hull_contact ()).

    motor_speed/motor_torque are per-joint (4,) — the action mapping
    (walker_env.py:519-531) is done by the caller.
    """
    inv_m = jnp.asarray(INV_M)
    inv_i = jnp.asarray(INV_I)

    # --- contact generation (once per step, like Box2D) -------------------
    pts, normal, pen, body_idx = _contact_candidates(bodies, terrain)
    active = pen > 0.0
    mu = jnp.asarray(CONTACT_FRICTION)[body_idx]

    # Mass splitting for the Jacobi contact sweep: impulses computed as if
    # each body's mass were divided among its active contacts, which keeps
    # simultaneous multi-point impulses from overshooting.
    n_per_body = jax.ops.segment_sum(
        active.astype(jnp.float32), body_idx, NUM_BODIES)
    split = jnp.maximum(n_per_body[body_idx], 1.0)

    r = pts - bodies.pos[body_idx]               # (25, 2) arm from centroid
    # effective mass along normal: 1/(invM + invI (r×n)^2)
    rxn = r[:, 0] * normal[:, 1] - r[:, 1] * normal[:, 0]
    k_n = (inv_m[body_idx] + inv_i[body_idx] * rxn ** 2) * split
    tangent = jnp.stack([-normal[:, 1], normal[:, 0]], -1)
    rxt = r[:, 0] * tangent[:, 1] - r[:, 1] * tangent[:, 0]
    k_t = (inv_m[body_idx] + inv_i[body_idx] * rxt ** 2) * split

    bias = jnp.minimum(
        POS_BAUMGARTE / DT * jnp.maximum(pen - PEN_SLOP, 0.0), 2.0)

    # --- joint precomputation --------------------------------------------
    ja, jb = jnp.asarray(JOINT_A), jnp.asarray(JOINT_B)

    def joint_anchors(bodies):
        Ra = rot(bodies.angle[ja])
        Rb = rot(bodies.angle[jb])
        ra = jnp.einsum('jik,jk->ji', Ra, jnp.asarray(JOINT_ANCHOR_A),
                        precision=HIGHEST)
        rb = jnp.einsum('jik,jk->ji', Rb, jnp.asarray(JOINT_ANCHOR_B),
                        precision=HIGHEST)
        return ra, rb

    ra, rb = joint_anchors(bodies)

    joint_angle = (bodies.angle[jb] - bodies.angle[ja]
                   - jnp.asarray(JOINT_REF))
    inv_i_sum = inv_i[ja] + inv_i[jb]
    # limit state
    at_lower = joint_angle <= jnp.asarray(JOINT_LOWER)
    at_upper = joint_angle >= jnp.asarray(JOINT_UPPER)
    limit_bias = (POS_BAUMGARTE / DT) * (
        jnp.where(at_lower, joint_angle - jnp.asarray(JOINT_LOWER), 0.0)
        + jnp.where(at_upper, joint_angle - jnp.asarray(JOINT_UPPER), 0.0))

    max_motor_impulse = motor_torque * DT

    def solve_velocity(carry, _):
        vel, angvel, acc_n, acc_t, acc_m = carry

        # -- joints (Gauss-Seidel over the 4 joints, vectorized per type) --
        # motor + limit (angular)
        w_rel = angvel[jb] - angvel[ja]
        # motor drives w_rel toward motor_speed
        m_imp = -(w_rel - motor_speed) / jnp.maximum(inv_i_sum, 1e-9)
        new_acc = jnp.clip(acc_m + m_imp, -max_motor_impulse,
                           max_motor_impulse)
        m_imp = new_acc - acc_m
        acc_m = new_acc
        angvel = angvel.at[ja].add(-inv_i[ja] * m_imp)
        angvel = angvel.at[jb].add(inv_i[jb] * m_imp)

        # limits: hard stop with bias
        w_rel = angvel[jb] - angvel[ja]
        l_imp = -(w_rel + limit_bias) / jnp.maximum(inv_i_sum, 1e-9)
        l_imp = jnp.where(at_lower, jnp.maximum(l_imp, 0.0),
                          jnp.where(at_upper, jnp.minimum(l_imp, 0.0), 0.0))
        angvel = angvel.at[ja].add(-inv_i[ja] * l_imp)
        angvel = angvel.at[jb].add(inv_i[jb] * l_imp)

        # point-to-point: relative velocity at anchor = 0 (2x2 solve)
        va = vel[ja] + cross_sv(angvel[ja], ra)
        vb = vel[jb] + cross_sv(angvel[jb], rb)
        cdot = vb - va
        # K matrix
        ma = inv_m[ja] + inv_m[jb]
        k11 = ma + inv_i[ja] * ra[:, 1] ** 2 + inv_i[jb] * rb[:, 1] ** 2
        k12 = -inv_i[ja] * ra[:, 0] * ra[:, 1] - inv_i[jb] * rb[:, 0] * rb[:, 1]
        k22 = ma + inv_i[ja] * ra[:, 0] ** 2 + inv_i[jb] * rb[:, 0] ** 2
        det = jnp.maximum(k11 * k22 - k12 * k12, 1e-9)
        px = -(k22 * cdot[:, 0] - k12 * cdot[:, 1]) / det
        py = -(k11 * cdot[:, 1] - k12 * cdot[:, 0]) / det
        P = jnp.stack([px, py], -1)
        vel = vel.at[ja].add(-inv_m[ja, None] * P)
        vel = vel.at[jb].add(inv_m[jb, None] * P)
        angvel = angvel.at[ja].add(
            -inv_i[ja] * (ra[:, 0] * P[:, 1] - ra[:, 1] * P[:, 0]))
        angvel = angvel.at[jb].add(
            inv_i[jb] * (rb[:, 0] * P[:, 1] - rb[:, 1] * P[:, 0]))

        # -- contacts (Jacobi over all points, relaxed) --------------------
        v_pt = vel[body_idx] + cross_sv(angvel[body_idx], r)
        vn = jnp.sum(v_pt * normal, -1)
        lam = -(vn - bias) / jnp.maximum(k_n, 1e-9)
        new_acc_n = jnp.maximum(acc_n + jnp.where(active, lam, 0.0), 0.0)
        lam = new_acc_n - acc_n
        acc_n = new_acc_n
        imp = lam[:, None] * normal
        dvel = jax.ops.segment_sum(
            imp * inv_m[body_idx][:, None], body_idx, NUM_BODIES)
        dang = jax.ops.segment_sum(
            (r[:, 0] * imp[:, 1] - r[:, 1] * imp[:, 0]) * inv_i[body_idx],
            body_idx, NUM_BODIES)
        vel = vel + dvel
        angvel = angvel + dang

        v_pt = vel[body_idx] + cross_sv(angvel[body_idx], r)
        vt = jnp.sum(v_pt * tangent, -1)
        lam_t = -vt / jnp.maximum(k_t, 1e-9)
        max_f = mu * acc_n
        new_acc_t = jnp.clip(acc_t + jnp.where(active, lam_t, 0.0),
                             -max_f, max_f)
        lam_t = new_acc_t - acc_t
        acc_t = new_acc_t
        imp = lam_t[:, None] * tangent
        vel = vel + jax.ops.segment_sum(
            imp * inv_m[body_idx][:, None], body_idx, NUM_BODIES)
        angvel = angvel + jax.ops.segment_sum(
            (r[:, 0] * imp[:, 1] - r[:, 1] * imp[:, 0]) * inv_i[body_idx],
            body_idx, NUM_BODIES)

        return (vel, angvel, acc_n, acc_t, acc_m), None

    # integrate gravity
    vel = bodies.vel + jnp.array([0.0, GRAVITY]) * DT
    angvel = bodies.angvel

    (vel, angvel, acc_n, _, _), _ = jax.lax.scan(
        solve_velocity,
        (vel, angvel, jnp.zeros(25), jnp.zeros(25), jnp.zeros(4)),
        None, length=VEL_ITERS, unroll=VEL_UNROLL)

    pos = bodies.pos + vel * DT
    angle = bodies.angle + angvel * DT
    new_bodies = Bodies(pos=pos, angle=angle, vel=vel, angvel=angvel)

    # observations
    touching = active & (acc_n > 0)
    body_touch = jax.ops.segment_max(
        touching.astype(jnp.int32), body_idx, NUM_BODIES) > 0
    lower_contact = jnp.stack([body_touch[2], body_touch[4]])
    hull_contact = body_touch[0]

    joint_angle = (angle[jb] - angle[ja] - jnp.asarray(JOINT_REF))
    joint_speed = angvel[jb] - angvel[ja]
    return (new_bodies, lower_contact, joint_angle, joint_speed,
            hull_contact)


def lidar(bodies: Bodies, terrain: Terrain) -> jnp.ndarray:
    """10-ray lidar fractions (walker_env.py:534-541)."""
    p0 = bodies.pos[0]
    i = jnp.arange(10, dtype=jnp.float32)
    dirs = jnp.stack(
        [jnp.sin(1.5 * i / 10.0), -jnp.cos(1.5 * i / 10.0)], -1) * LIDAR_RANGE
    p1 = p0[None, :] + dirs                      # (10, 2)

    # ray vs heightfield segments
    ax = terrain.xs[:-1]
    ay = terrain.ys[:-1]
    bx = terrain.xs[1:]
    by = terrain.ys[1:]

    def ray_fraction(p1_single):
        d = p1_single - p0
        ex = bx - ax
        ey = by - ay
        denom = d[0] * ey - d[1] * ex
        t = ((ax - p0[0]) * ey - (ay - p0[1]) * ex) / jnp.where(
            jnp.abs(denom) < 1e-9, 1e-9, denom)
        s = jnp.where(
            jnp.abs(ex) > jnp.abs(ey),
            (p0[0] + t * d[0] - ax) / jnp.where(jnp.abs(ex) < 1e-9, 1e-9, ex),
            (p0[1] + t * d[1] - ay) / jnp.where(jnp.abs(ey) < 1e-9, 1e-9, ey))
        hit = (t >= 0) & (t <= 1) & (s >= 0) & (s <= 1)
        frac_h = jnp.min(jnp.where(hit, t, 1.0))

        # ray vs boxes (slab test)
        b = terrain.boxes
        valid = jnp.arange(MAX_BOXES) < terrain.n_boxes
        inv = 1.0 / jnp.where(jnp.abs(d) < 1e-9, 1e-9, d)
        t0x = (b[:, 0] - p0[0]) * inv[0]
        t1x = (b[:, 2] - p0[0]) * inv[0]
        t0y = (b[:, 1] - p0[1]) * inv[1]
        t1y = (b[:, 3] - p0[1]) * inv[1]
        tmin = jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y))
        tmax = jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y))
        hit_b = (tmax >= tmin) & (tmax >= 0) & (tmin <= 1) & valid
        frac_b = jnp.min(jnp.where(hit_b, jnp.maximum(tmin, 0.0), 1.0))
        return jnp.minimum(frac_h, frac_b)

    return jax.vmap(ray_fraction)(p1)
