"""Top-down car dynamics in jnp.

Replaces gym's Box2D multi-body Car (gymnasium car_dynamics.py — hull + 4
wheel bodies with revolute joints) with a single-rigid-body model carrying
kinematic wheels: wheel angular speeds and steering angles are explicit
state, friction-circle tire forces are applied at the wheel anchor points.
The tire model (engine power, brake, friction limit, force coefficients)
is transcribed exactly; the joint constraint dynamics collapse into the
rigid-body aggregation, which is the standard simplification for top-down
cars and preserves the driving behavior.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ...utils import struct

# gym car_dynamics constants
SIZE = 0.02
ENGINE_POWER = 1e8 * SIZE ** 2
WHEEL_MOMENT = 4000 * SIZE ** 2
FRICTION_LIMIT = 1e6 * SIZE ** 2
WHEEL_R = 27 * SIZE
WHEELPOS = np.array(
    [(-55, 80), (55, 80), (-55, -82), (55, -82)], np.float64) * SIZE
HULL_POLYS = [
    np.array([(-60, 130), (60, 130), (60, 110), (-60, 110)]) * SIZE,
    np.array([(-15, 120), (15, 120), (20, 20), (-20, 20)]) * SIZE,
    np.array([(25, 20), (50, -10), (50, -40), (20, -90), (-20, -90),
              (-50, -40), (-50, -10), (-25, 20)]) * SIZE,
    np.array([(-50, -120), (50, -120), (50, -90), (-50, -90)]) * SIZE,
]
FORCE_COEF = 205000 * SIZE ** 2
STEER_LIMIT = 0.42  # joint limits ±0.4 + small slack
DT = 1.0 / 50.0


def _poly_mass(verts, density):
    """Box2D polygon mass/centroid/inertia; handles either winding and
    origins outside the polygon (fan from verts[0], signed areas)."""
    signed = 0.0
    for i in range(len(verts)):
        p1, p2 = verts[i], verts[(i + 1) % len(verts)]
        signed += p1[0] * p2[1] - p2[0] * p1[1]
    if signed < 0:
        verts = verts[::-1]
    ref = verts[0]
    area = 0.0
    c = np.zeros(2)
    I = 0.0
    for i in range(len(verts)):
        p1 = verts[i] - ref
        p2 = verts[(i + 1) % len(verts)] - ref
        cross = p1[0] * p2[1] - p1[1] * p2[0]
        tri = 0.5 * cross
        area += tri
        c += tri / 3.0 * (p1 + p2)
        I += (0.25 / 3.0) * cross * (p1 @ p1 + p1 @ p2 + p2 @ p2)
    c /= max(area, 1e-12)
    m = density * area
    I = density * I - m * (c @ c)
    c = c + ref
    return m, c, I + 0.0


# aggregate mass/inertia: hull polys (density 1) + wheels (density 0.1,
# box 2*WHEEL_R x WHEEL_W) lumped at their anchors
_m_tot, _I_tot = 0.0, 0.0
for _v in HULL_POLYS:
    _m, _c, _I = _poly_mass(_v, 1.0)
    _m_tot += _m
    _I_tot += _I + _m * (_c @ _c)
_wheel_box = np.array([(-14, -27), (14, -27), (14, 27), (-14, 27)]) * SIZE
_wm, _, _wI = _poly_mass(_wheel_box, 0.1)
for _p in WHEELPOS:
    _m_tot += _wm
    _I_tot += _wI + _wm * (_p @ _p)
CAR_MASS = float(_m_tot)
CAR_I = float(_I_tot)


@struct.dataclass
class CarState:
    pos: jnp.ndarray          # (2,)
    angle: jnp.ndarray        # ()
    vel: jnp.ndarray          # (2,)
    angvel: jnp.ndarray       # ()
    wheel_omega: jnp.ndarray  # (4,)
    steer_angle: jnp.ndarray  # () front-wheel joint angle
    gas: jnp.ndarray          # () smoothed rear-wheel gas
    fuel_spent: jnp.ndarray   # ()


def init_car(angle, x, y) -> CarState:
    return CarState(
        pos=jnp.stack([x, y]).astype(jnp.float32),
        angle=jnp.asarray(angle, jnp.float32),
        vel=jnp.zeros(2),
        angvel=jnp.float32(0.0),
        wheel_omega=jnp.zeros(4),
        steer_angle=jnp.float32(0.0),
        gas=jnp.float32(0.0),
        fuel_spent=jnp.float32(0.0),
    )


def car_step(car: CarState, steer_cmd, gas_cmd, brake_cmd,
             wheel_on_road: jnp.ndarray) -> CarState:
    """One 1/50 s step.  Commands follow gym Car.steer/gas/brake semantics:
    steer ∈ [-1, 1] (target joint angle), gas ∈ [0, 1] (ramped by ≤0.1 per
    call), brake ∈ [0, 1].  ``wheel_on_road`` (4,) selects road vs grass
    friction (FrictionDetector / w.tiles)."""
    # gas ramp (car_dynamics.gas)
    gas_cmd = jnp.clip(gas_cmd, 0, 1)
    gas = car.gas + jnp.clip(gas_cmd - car.gas, None, 0.1)

    # steering joint motor: rate = sign(err) * min(50|err|, 3)
    err = steer_cmd - car.steer_angle
    rate = jnp.sign(err) * jnp.minimum(50.0 * jnp.abs(err), 3.0)
    steer_angle = jnp.clip(
        car.steer_angle + DT * rate, -STEER_LIMIT, STEER_LIMIT)

    ca, sa = jnp.cos(car.angle), jnp.sin(car.angle)
    R = jnp.array([[ca, -sa], [sa, ca]])
    wheel_world = car.pos + _rotate(R)               # (4, 2)

    # wheel orientations: front wheels add the steering angle
    wheel_ang = car.angle + jnp.array([1.0, 1.0, 0.0, 0.0]) * steer_angle
    forw = jnp.stack([-jnp.sin(wheel_ang), jnp.cos(wheel_ang)], -1)
    side = jnp.stack([jnp.cos(wheel_ang), jnp.sin(wheel_ang)], -1)

    # wheel point velocities: v + w × r
    r = wheel_world - car.pos
    v_pt = car.vel + car.angvel * jnp.stack([-r[:, 1], r[:, 0]], -1)
    vf = (forw * v_pt).sum(-1)
    vs = (side * v_pt).sum(-1)

    omega = car.wheel_omega
    # engine on rear wheels
    wheel_gas = jnp.array([0.0, 0.0, 1.0, 1.0]) * gas
    omega = omega + DT * ENGINE_POWER * wheel_gas / WHEEL_MOMENT / (
        jnp.abs(omega) + 5.0)
    fuel = car.fuel_spent + DT * ENGINE_POWER * wheel_gas.sum()

    # brake on all wheels
    brake = jnp.clip(brake_cmd, 0, 1)
    hard = brake >= 0.9
    brake_delta = jnp.minimum(15.0 * brake, jnp.abs(omega))
    omega = jnp.where(hard, 0.0, omega - jnp.sign(omega) * brake_delta)

    vr = omega * WHEEL_R
    f_force = (-vf + vr) * FORCE_COEF
    p_force = -vs * FORCE_COEF
    force = jnp.sqrt(f_force ** 2 + p_force ** 2)

    friction_limit = FRICTION_LIMIT * jnp.where(wheel_on_road, 1.0, 0.6)
    over = force > friction_limit
    scale = jnp.where(over, friction_limit / jnp.maximum(force, 1e-9), 1.0)
    f_force = f_force * scale
    p_force = p_force * scale

    omega = omega - DT * f_force * WHEEL_R / WHEEL_MOMENT

    F = p_force[:, None] * side + f_force[:, None] * forw   # (4, 2)
    F_tot = F.sum(0)
    tau = (r[:, 0] * F[:, 1] - r[:, 1] * F[:, 0]).sum()

    vel = car.vel + DT * F_tot / CAR_MASS
    angvel = car.angvel + DT * tau / CAR_I
    pos = car.pos + DT * vel
    angle = car.angle + DT * angvel

    return CarState(
        pos=pos, angle=angle, vel=vel, angvel=angvel, wheel_omega=omega,
        steer_angle=steer_angle, gas=gas, fuel_spent=fuel)


def _rotate(R: jnp.ndarray) -> jnp.ndarray:
    """WHEELPOS rotated by R, in full f32 (not TF32) on the GPU."""
    return jnp.matmul(WHEELPOS, R.T, precision=jax.lax.Precision.HIGHEST)


def wheel_positions(car: CarState) -> jnp.ndarray:
    ca, sa = jnp.cos(car.angle), jnp.sin(car.angle)
    R = jnp.array([[ca, -sa], [sa, ca]])
    return car.pos + _rotate(R)
