"""Bézier track curves in jnp (reference envs/box2d/bezier.py).

12 control points → closed smooth curve of 12 segments × numpoints samples,
via cubic Bernstein segments with tangent-angle smoothing (rad=0.2,
edgy=0.2).  All shapes static; binomial coefficients precomputed.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def ccw_sort(points: jnp.ndarray) -> jnp.ndarray:
    """Sort points counter-clockwise around their mean (bezier.py:52-55).

    Note the reference sorts by arctan2(dx, dy) (x first) — preserved.
    """
    d = points - points.mean(axis=0)
    s = jnp.arctan2(d[:, 0], d[:, 1])
    return points[jnp.argsort(s)]


def bezier_curve(control4: jnp.ndarray, num: int) -> jnp.ndarray:
    """Cubic Bézier through (…, 4, 2) control points → (…, num, 2)."""
    t = jnp.linspace(0.0, 1.0, num)
    b = jnp.stack([
        (1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t ** 2 * (1 - t), t ** 3,
    ], -1)  # (num, 4)
    # full f32: a TF32 default-precision pass would round the track
    # geometry (10-bit mantissa) on the GPU
    return jnp.einsum('nk,...kd->...nd', b, control4,
                      precision=jax.lax.Precision.HIGHEST)


def get_bezier_track(a: jnp.ndarray, rad: float = 0.2, edgy: float = 0.2,
                     numpoints: int = 40) -> jnp.ndarray:
    """Closed curve through control points (N, 2) → (N * numpoints, 2).

    Transcribes reference get_bezier_curve + Segment (bezier.py:22-83) with
    static shapes: N segments, each a cubic with intermediate points at
    distance rad·|p2-p1| along smoothed tangent angles.
    """
    p = jnp.arctan(edgy) / jnp.pi + 0.5
    a = ccw_sort(a)
    a_closed = jnp.concatenate([a, a[:1]], axis=0)       # (N+1, 2)
    d = jnp.diff(a_closed, axis=0)                        # (N, 2)
    ang = jnp.arctan2(d[:, 1], d[:, 0])
    ang = jnp.where(ang >= 0, ang, ang + 2 * jnp.pi)
    ang1 = ang
    ang2 = jnp.roll(ang, 1)
    ang = p * ang1 + (1 - p) * ang2 + jnp.where(
        jnp.abs(ang2 - ang1) > jnp.pi, jnp.pi, 0.0)
    ang_closed = jnp.concatenate([ang, ang[:1]])          # (N+1,)

    p1 = a_closed[:-1]                                    # (N, 2)
    p2 = a_closed[1:]
    th1 = ang_closed[:-1]
    th2 = ang_closed[1:]
    dist = jnp.sqrt(((p2 - p1) ** 2).sum(-1, keepdims=True))
    r = rad * dist
    c1 = p1 + r * jnp.stack([jnp.cos(th1), jnp.sin(th1)], -1)
    c2 = p2 + r * jnp.stack([jnp.cos(th2 + jnp.pi), jnp.sin(th2 + jnp.pi)],
                            -1)
    control4 = jnp.stack([p1, c1, c2, p2], axis=1)        # (N, 4, 2)
    curve = bezier_curve(control4, numpoints)             # (N, num, 2)
    return curve.reshape(-1, 2)


def random_control_points(rng, n: int = 12, scale: float = 1.0,
                          mindst: float = None, tries: int = 100):
    """Rejection-sample control points ≥ mindst apart (bezier.py:86-98).

    Fixed trial count with best-so-far selection (jit-friendly).
    """
    import jax
    mindst = mindst or 0.7 / n

    def one(key):
        pts = jax.random.uniform(key, (n, 2))
        s = ccw_sort(pts)
        d = jnp.sqrt((jnp.diff(s, axis=0) ** 2).sum(-1))
        return pts, d.min()

    keys = jax.random.split(rng, tries)
    pts, mins = jax.vmap(one)(keys)
    ok = mins >= mindst
    # first satisfying trial, else the best one
    idx = jnp.where(ok.any(), jnp.argmax(ok), jnp.argmax(mins))
    return pts[idx] * scale
