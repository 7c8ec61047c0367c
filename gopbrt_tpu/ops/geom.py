"""SoA vector / transform / bounds math.

Replaces the reference's scalar vector types and ``Transform`` class
(``pkg/geometry/xyz.go`` — genny-generated XYZ arithmetic; and
``pkg/pbrt/transform.go:148-631``) with pure functions over trailing-dim-3
``jnp`` arrays so every op vectorises over arbitrary ray/primitive batches.

Conventions
  * points / vectors / normals: ``f32[..., 3]``
  * 4x4 matrices: ``f32[..., 4, 4]`` row-major, row 3 = (0,0,0,1)
  * a Transform is the pair ``(m, m_inv)`` — both kept explicit so the
    inverse is exact by construction (reference keeps ``Matrix,
    MatrixInverse``, ``transform.go:148-156``) and autodiff flows through
    both without a runtime Gauss–Jordan solve on the hot path.

Robustness: the reference propagates per-component floating-point error
intervals (γ-bounds, ``transform.go:227-345``; EFloat ``pkg/efloat``).
Interval arithmetic is branchy and hostile to SIMD; here we use PBRT's
closed-form conservative γ error bounds in f32 (see :func:`gamma`) and a
fixed scaled-epsilon ray-offset scheme (:func:`offset_ray_origin`).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

# All einsums here are tiny affine transforms on the hot path — force full
# f32: at default precision a GPU may run f32 products in TF32 (10-bit
# mantissa), which corrupts ray transforms at the 1e-3 level.
_HI = jax.lax.Precision.HIGHEST

# ---------------------------------------------------------------------------
# Constants (counterpart of pkg/math/math.go:7-20, with the MachineEpsilon
# quirk fixed: the reference sets MachineEpsilon to the smallest denormal,
# zeroing all gamma bounds, and compensates with a *1024 fudge in
# OffsetRayOrigin (pkg/pbrt/ray.go:58).  We use the intended f32 value.)
# ---------------------------------------------------------------------------

PI = math.pi
INV_PI = 1.0 / math.pi
INV_2PI = 1.0 / (2.0 * math.pi)
INV_4PI = 1.0 / (4.0 * math.pi)
PI_OVER_2 = math.pi / 2.0
PI_OVER_4 = math.pi / 4.0
SQRT_2 = math.sqrt(2.0)

# f32 machine epsilon / 2 (ulp rounding bound) — intended semantics of
# pkg/math/math.go:17.
MACHINE_EPSILON = float(jnp.finfo(jnp.float32).eps) / 2.0
ONE_MINUS_EPSILON = float(jnp.nextafter(jnp.float32(1.0), jnp.float32(0.0)))
SHADOW_EPSILON = 1e-4  # pkg/math/math.go:19 uses 0.0001
INF = float("inf")
MAX_F32 = float(jnp.finfo(jnp.float32).max)


def gamma(n: int | jnp.ndarray) -> float | jnp.ndarray:
    """PBRT conservative rounding-error bound γ(n) = nε/(1−nε).

    Counterpart of pkg/math/math.go ``Gamma`` with the corrected epsilon.
    """
    ne = n * MACHINE_EPSILON
    return ne / (1 - ne)


# ---------------------------------------------------------------------------
# Vector ops (counterpart of pkg/geometry/xyz.go arithmetic; only the ops the
# renderer needs — everything else is plain jnp arithmetic at call sites).
# ---------------------------------------------------------------------------


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3-vector dot product -> [...]."""
    return jnp.sum(a * b, axis=-1)


def absdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.abs(dot(a, b))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length_sq(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(v * v, axis=-1)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length_sq(v))


def normalize(v: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Normalize; with ``eps`` > 0 guards the zero vector (returns ~0)."""
    n2 = length_sq(v)[..., None]
    return v * jnp.where(n2 > eps, 1.0, 0.0) / jnp.sqrt(jnp.maximum(n2, jnp.maximum(eps, 1e-30)))


def face_forward(n: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Flip n to lie in the hemisphere of v (pkg/geometry FaceForward)."""
    return jnp.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1: jnp.ndarray):
    """Build an orthonormal frame around unit v1 (pkg/pbrt usage in BSDF).

    Branch-free Duff et al. construction — numerically stable for all v1,
    unlike the reference's |x|>|y| branch; vectorises cleanly.
    """
    z = v1[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v1[..., 0] * v1[..., 1] * a
    v2 = jnp.stack(
        [1.0 + sign * v1[..., 0] * v1[..., 0] * a, sign * b, -sign * v1[..., 0]],
        axis=-1,
    )
    v3 = jnp.stack([b, sign + v1[..., 1] * v1[..., 1] * a, -v1[..., 1]], axis=-1)
    return v2, v3


def spherical_direction(sin_theta, cos_theta, phi):
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )


def spherical_direction_xyz(sin_theta, cos_theta, phi, x, y, z):
    """Spherical direction in the frame (x, y, z)."""
    return (
        x * (sin_theta * jnp.cos(phi))[..., None]
        + y * (sin_theta * jnp.sin(phi))[..., None]
        + z * cos_theta[..., None]
    )


def distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return length(b - a)


def lerp(t, a, b):
    """Linear interpolation (pkg/math/math.go Lerp)."""
    return (1.0 - t) * a + t * b


# ---------------------------------------------------------------------------
# 4x4 matrices / transforms
# ---------------------------------------------------------------------------


def identity() -> jnp.ndarray:
    return jnp.eye(4, dtype=jnp.float32)


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Compose 4x4 transforms (a then applied after b, i.e. a @ b).

    Note the reference's Matrix4x4.Mul has a bug in the last row
    (transform.go:66 uses m[3][j]); we implement the correct product.
    """
    return jnp.matmul(a, b, precision=_HI)


def transpose(m: jnp.ndarray) -> jnp.ndarray:
    return jnp.swapaxes(m, -1, -2)


def inverse(m: jnp.ndarray) -> jnp.ndarray:
    """General 4x4 inverse (reference: Gauss–Jordan, transform.go:72-146).

    Used only at scene-build time; hot paths carry (m, m_inv) pairs.
    """
    return jnp.linalg.inv(m)


def translate(delta) -> jnp.ndarray:
    """Translation matrix (transform.go:347-365)."""
    d = jnp.asarray(delta, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(d)


def scale(x, y, z) -> jnp.ndarray:
    """Scale matrix (transform.go ``Scale``)."""
    return jnp.diag(jnp.asarray([x, y, z, 1.0], jnp.float32))


def _rot(c, s, axis: int) -> jnp.ndarray:
    m = jnp.eye(4, dtype=jnp.float32)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    if axis == 1:  # y-axis has the transposed sign layout
        m = m.at[i, i].set(c).at[i, j].set(s).at[j, i].set(-s).at[j, j].set(c)
    else:
        m = m.at[i, i].set(c).at[i, j].set(-s).at[j, i].set(s).at[j, j].set(c)
    return m


def rotate_x(deg) -> jnp.ndarray:
    t = math.radians(deg)
    return _rot(math.cos(t), math.sin(t), 0)


def rotate_y(deg) -> jnp.ndarray:
    t = math.radians(deg)
    return _rot(math.cos(t), math.sin(t), 1)


def rotate_z(deg) -> jnp.ndarray:
    t = math.radians(deg)
    return _rot(math.cos(t), math.sin(t), 2)


def rotate(deg, axis) -> jnp.ndarray:
    """Rotation about an arbitrary axis (transform.go ``Rotate``)."""
    a = jnp.asarray(axis, jnp.float32)
    a = a / jnp.linalg.norm(a)
    t = math.radians(float(deg))
    s, c = math.sin(t), math.cos(t)
    x, y, z = a[0], a[1], a[2]
    m = jnp.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0],
            [x * y * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s, 0],
            [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, c + z * z * (1 - c), 0],
            [0, 0, 0, 1],
        ],
        dtype=jnp.float32,
    )
    return m


def look_at(eye, look, up) -> jnp.ndarray:
    """Camera-to-world matrix (transform.go ``LookAt``)."""
    eye = jnp.asarray(eye, jnp.float32)
    look = jnp.asarray(look, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    direction = normalize(look - eye)
    right = normalize(jnp.cross(normalize(up), direction))
    new_up = jnp.cross(direction, right)
    m = jnp.stack([right, new_up, direction, eye], axis=-1)  # columns
    m = jnp.concatenate([m, jnp.array([[0.0, 0.0, 0.0, 1.0]], jnp.float32)], axis=0)
    return m


def perspective(fov_deg, near, far) -> jnp.ndarray:
    """Perspective projection (transform.go:488-499)."""
    persp = jnp.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, far / (far - near), -far * near / (far - near)],
            [0, 0, 1, 0],
        ],
        dtype=jnp.float32,
    )
    inv_tan = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    return matmul(scale(inv_tan, inv_tan, 1.0), persp)


def orthographic(z_near, z_far) -> jnp.ndarray:
    """Orthographic projection (transform.go:501-502)."""
    return matmul(
        scale(1.0, 1.0, 1.0 / (z_far - z_near)), translate([0.0, 0.0, -z_near])
    )


# --- applying transforms (batched: m [...,4,4] or [4,4], x [...,3]) --------


def apply_point(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Transform points; divides by w (transform.go TransformPoint)."""
    r = jnp.einsum("...ij,...j->...i", m[..., :3, :3], p, precision=_HI) + m[..., :3, 3]
    w = jnp.einsum("...j,...j->...", m[..., 3, :3], p, precision=_HI) + m[..., 3, 3]
    return r / w[..., None]


def apply_point_affine(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Transform points assuming last row (0,0,0,1) — the hot-path case."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], p, precision=_HI) + m[..., :3, 3]


def apply_vector(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], v, precision=_HI)


def apply_normal(m_inv: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Normals transform by the inverse transpose (transform.go TransformNormal)."""
    return jnp.einsum("...ji,...j->...i", m_inv[..., :3, :3], n, precision=_HI)


def apply_point_error(m: jnp.ndarray, p: jnp.ndarray):
    """Transform point and return (p', abs-error bound) per PBRT's γ analysis
    (transform.go:238-265).  Error: γ(3) * |M| |p|-style bound."""
    pt = apply_point_affine(m, p)
    abs_m = jnp.abs(m[..., :3, :3])
    abs_t = jnp.abs(m[..., :3, 3])
    err = gamma(3) * (
        jnp.einsum("...ij,...j->...i", abs_m, jnp.abs(p), precision=_HI) + abs_t
    )
    return pt, err


def swaps_handedness(m: jnp.ndarray) -> jnp.ndarray:
    det = jnp.linalg.det(m[..., :3, :3])
    return det < 0.0


# ---------------------------------------------------------------------------
# Rays (SoA: origins [...,3], dirs [...,3], t_max [...])
# Counterpart of pkg/pbrt/ray.go.
# ---------------------------------------------------------------------------


def ray_at(o: jnp.ndarray, d: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    return o + d * t[..., None]


@jax.custom_jvp
def _nextafter_away(po: jnp.ndarray, offset: jnp.ndarray) -> jnp.ndarray:
    """Round each component of po one ulp away from zero where offset != 0.

    Wrapped in a custom_jvp because jnp.nextafter has no differentiation
    rule; the op is a sub-ulp rounding, so the identity JVP is exact to
    machine precision (keeps geometry-parameter gradients flowing through
    spawn_ray in the path-replay backward pass).
    """
    po_up = jnp.where(po > 0, jnp.nextafter(po, jnp.inf), po)
    po_dn = jnp.where(po < 0, jnp.nextafter(po, -jnp.inf), po)
    return jnp.where(offset > 0, po_up, jnp.where(offset < 0, po_dn, po))


@_nextafter_away.defjvp
def _nextafter_away_jvp(primals, tangents):
    po, offset = primals
    dpo, _ = tangents
    return _nextafter_away(po, offset), dpo


def offset_ray_origin(p: jnp.ndarray, p_err: jnp.ndarray, n: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Robust spawn-point offset along the normal (ray.go:57-74).

    PBRT's exact scheme: offset by d = dot(|n|, p_err) along ±n, then round
    each component away from p.  (The reference multiplies by a 1024 fudge to
    compensate its zeroed MachineEpsilon; unnecessary here.)
    """
    d = dot(jnp.abs(n), p_err)
    offset = d[..., None] * n
    offset = jnp.where(dot(w, n)[..., None] < 0.0, -offset, offset)
    return _nextafter_away(p + offset, offset)


def apply_ray(m: jnp.ndarray, o: jnp.ndarray, d: jnp.ndarray):
    """Transform ray origin+direction; origin offset by error bound along d
    (transform.go TransformRay, with the o-error float fix folded in)."""
    ot, o_err = apply_point_error(m, o)
    dt = apply_vector(m, d)
    # offset origin to conservative side of surface it spawned from
    len_sq = length_sq(dt)
    dt_ok = len_sq > 0
    t_off = jnp.where(dt_ok, dot(jnp.abs(dt), o_err) / jnp.maximum(len_sq, 1e-30), 0.0)
    ot = ot + dt * t_off[..., None]
    return ot, dt


# ---------------------------------------------------------------------------
# Bounds (AABB as (lo [...,3], hi [...,3])) — pkg/pbrt/bounds.go
# ---------------------------------------------------------------------------


def bounds_empty() -> tuple[jnp.ndarray, jnp.ndarray]:
    return (
        jnp.full((3,), MAX_F32, jnp.float32),
        jnp.full((3,), -MAX_F32, jnp.float32),
    )


def bounds_union(lo1, hi1, lo2, hi2):
    return jnp.minimum(lo1, lo2), jnp.maximum(hi1, hi2)


def bounds_union_point(lo, hi, p):
    return jnp.minimum(lo, p), jnp.maximum(hi, p)


def bounds_diagonal(lo, hi):
    return hi - lo


def bounds_surface_area(lo, hi):
    d = hi - lo
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def bounds_centroid(lo, hi):
    return 0.5 * (lo + hi)


def bounds_bounding_sphere(lo, hi):
    c = bounds_centroid(lo, hi)
    r = jnp.where(jnp.all(hi >= lo, axis=-1), distance(c, hi), 0.0)
    return c, r


def bounds_transform(m, lo, hi):
    """Transform an AABB: min/max over the 8 transformed corners
    (transform.go TransformBounds — but vectorised over corners)."""
    corners = jnp.stack(
        [
            jnp.stack(
                [
                    jnp.where(jnp.asarray([i & 1, i & 2, i & 4]) > 0, hi, lo)[k]
                    for k in range(3)
                ],
                axis=-1,
            )
            for i in range(8)
        ],
        axis=0,
    )  # [8,3]
    tc = apply_point_affine(m, corners)
    return jnp.min(tc, axis=0), jnp.max(tc, axis=0)


def bounds_intersect_p(lo, hi, o, d, t_max, inv_d=None):
    """Robust slab test (bounds.go:149-185): returns hit mask.

    Bound inflated by 1+2γ(3) per PBRT to stay conservative under f32.
    Batched over both rays and boxes by broadcasting.
    """
    if inv_d is None:
        inv_d = 1.0 / d
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1) * (1 + 2 * gamma(3))
    tn = jnp.max(t_near, axis=-1)
    tf = jnp.min(t_far, axis=-1)
    return (tn <= tf) & (tf > 0.0) & (tn < t_max)


__all__ = [n for n in dir() if not n.startswith("_")]
