"""Quaternions + two-keyframe animated transforms.

Counterpart of ``pkg/pbrt/quaternion.go`` and ``AnimatedTransform``
(``pkg/pbrt/transform.go:512-631``).  The reference's transform
decomposition is a TODO, so any non-identity animation nil-derefs
(SURVEY quirk #9); this implements the full decompose (polar-iteration
rotation extraction) + slerp interpolation, vectorised over batches of
interpolation times.

Quaternion layout: f32[..., 4] as (x, y, z, w).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gopbrt_tpu.ops import geom

_HI = jax.lax.Precision.HIGHEST


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_dot(a, b):
    return jnp.sum(a * b, axis=-1)


def quat_normalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def quat_from_matrix(m: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (upper 3x3 of [...,4,4] or [...,3,3]) -> quaternion.

    Branch-free Shepperd's-method variant: compute all four candidate
    construction paths and pick by the largest diagonal combination.
    """
    r = m[..., :3, :3]
    t = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]

    # candidate 0: w-major
    w0 = jnp.sqrt(jnp.maximum(1.0 + t, 1e-12)) / 2.0
    q0 = jnp.stack(
        [
            (r[..., 2, 1] - r[..., 1, 2]) / (4.0 * w0),
            (r[..., 0, 2] - r[..., 2, 0]) / (4.0 * w0),
            (r[..., 1, 0] - r[..., 0, 1]) / (4.0 * w0),
            w0,
        ],
        axis=-1,
    )

    def axis_major(i, j, k):
        s = jnp.sqrt(
            jnp.maximum(1.0 + r[..., i, i] - r[..., j, j] - r[..., k, k], 1e-12)
        )
        q = [None, None, None, None]
        q[i] = s / 2.0
        q[j] = (r[..., j, i] + r[..., i, j]) / (2.0 * s)
        q[k] = (r[..., k, i] + r[..., i, k]) / (2.0 * s)
        q[3] = (r[..., k, j] - r[..., j, k]) / (2.0 * s)
        return jnp.stack(q, axis=-1)

    qx = axis_major(0, 1, 2)
    qy = axis_major(1, 2, 0)
    qz = axis_major(2, 0, 1)

    use_w = t > 0.0
    x_big = (r[..., 0, 0] > r[..., 1, 1]) & (r[..., 0, 0] > r[..., 2, 2])
    y_big = r[..., 1, 1] > r[..., 2, 2]
    q = jnp.where(
        use_w[..., None],
        q0,
        jnp.where(x_big[..., None], qx, jnp.where(y_big[..., None], qy, qz)),
    )
    return quat_normalize(q)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion -> 4x4 rotation (quaternion.go ToTransform)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    m = jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), zero], -1),
            jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), zero], -1),
            jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), zero], -1),
            jnp.stack([zero, zero, zero, one], -1),
        ],
        axis=-2,
    )
    return m


def slerp(t, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Spherical linear interpolation (quaternion.go Slerp)."""
    cos_theta = quat_dot(a, b)
    b = jnp.where(cos_theta[..., None] < 0.0, -b, b)
    cos_theta = jnp.abs(cos_theta)
    near = cos_theta > 0.9995
    # lerp fallback near parallel
    lin = quat_normalize(a + jnp.asarray(t)[..., None] * (b - a))
    theta = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
    thetap = theta * t
    qperp = quat_normalize(b - a * cos_theta[..., None])
    sph = a * jnp.cos(thetap)[..., None] + qperp * jnp.sin(thetap)[..., None]
    return jnp.where(near[..., None], lin, sph)


class AnimatedTransform(NamedTuple):
    """Two-keyframe rigid+scale animation (transform.go:512-631, with the
    decompose TODO actually implemented)."""

    start_m: jnp.ndarray  # f32[4,4]
    end_m: jnp.ndarray  # f32[4,4]
    start_time: jnp.ndarray
    end_time: jnp.ndarray
    # decomposed components
    t0: jnp.ndarray  # f32[3] translations
    t1: jnp.ndarray
    q0: jnp.ndarray  # f32[4] rotations
    q1: jnp.ndarray
    s0: jnp.ndarray  # f32[4,4] scale/shear remainder
    s1: jnp.ndarray
    actually_animated: jnp.ndarray  # bool[]


def decompose(m: jnp.ndarray):
    """M = T R S via polar iteration (the PBRT decompose the reference left
    as a TODO at transform.go:537-539)."""
    t = m[..., :3, 3]
    rot = m * jnp.asarray(
        [[1, 1, 1, 0], [1, 1, 1, 0], [1, 1, 1, 0], [0, 0, 0, 1]], jnp.float32
    )
    rot = rot.at[..., :3, 3].set(0.0)

    def polar_step(r, _):
        r_next = 0.5 * (r + jnp.linalg.inv(jnp.swapaxes(r, -1, -2)))
        return r_next, None

    rot, _ = jax.lax.scan(polar_step, rot, None, length=20)
    q = quat_from_matrix(rot)
    s = jnp.matmul(jnp.linalg.inv(rot), m.at[..., :3, 3].set(0.0),
                   precision=_HI)
    return t, q, s


def animated_transform(start_m, end_m, start_time=0.0, end_time=1.0) -> AnimatedTransform:
    start_m = jnp.asarray(start_m, jnp.float32)
    end_m = jnp.asarray(end_m, jnp.float32)
    t0, q0, s0 = decompose(start_m)
    t1, q1, s1 = decompose(end_m)
    # shortest-path rotation
    q1 = jnp.where(quat_dot(q0, q1) < 0.0, -q1, q1)
    return AnimatedTransform(
        start_m=start_m,
        end_m=end_m,
        start_time=jnp.asarray(start_time, jnp.float32),
        end_time=jnp.asarray(end_time, jnp.float32),
        t0=t0, t1=t1, q0=q0, q1=q1, s0=s0, s1=s1,
        actually_animated=jnp.any(jnp.abs(start_m - end_m) > 1e-7),
    )


def interpolate(at: AnimatedTransform, time) -> jnp.ndarray:
    """Transform at ``time`` (transform.go Interpolate), batched over time."""
    time = jnp.asarray(time, jnp.float32)
    dt = jnp.where(
        at.end_time > at.start_time,
        (jnp.clip(time, at.start_time, at.end_time) - at.start_time)
        / jnp.maximum(at.end_time - at.start_time, 1e-12),
        0.0,
    )
    trans = geom.lerp(dt[..., None], at.t0, at.t1)
    rot = slerp(dt, at.q0, at.q1)
    scale = geom.lerp(dt[..., None, None], at.s0, at.s1)
    m = jnp.matmul(quat_to_matrix(rot), scale,
                   precision=_HI)
    m = m.at[..., :3, 3].add(trans)
    return jnp.where(at.actually_animated, m, at.start_m)
