"""Shape intersection kernels over SoA primitive tables.

Replaces the reference's ``Shape`` interface dispatch (``pkg/pbrt/shape.go:9-22``
implemented by ``pkg/pbrt/sphere.go`` and ``pkg/shapes/disk.go``) with
integer-tagged SoA tables and branch-free per-type kernels, plus the
brute-force O(n) aggregate (counterpart of ``pkg/accelerator/simple.go``)
that serves as the correctness oracle for the BVH — mirroring the
reference's own test strategy (bvh_test.go vs simple_test.go fixtures).

Robustness: the reference solves sphere quadratics in EFloat interval
arithmetic (``pkg/pbrt/sphere.go:64-96``, ``pkg/efloat``).  Interval math is
branchy and SIMD-hostile; we instead use the numerically superior vector
formulation of the quadratic (b/2-form with recentred discriminant) plus
PBRT's closed-form γ error bounds, and reproject hit points onto the exact
surface (sphere.go:100-104's refinement) — validated against the brute-force
oracle and adversarial rays in tests/test_intersect.py.

All kernels are two-phase, the standard wavefront ray-casting design:
  phase 1 (hot): t-only tests -> (t, prim_idx) via min-reduction
  phase 2      : full SurfaceInteraction recomputed for the winner only
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gopbrt_tpu.ops import geom
from gopbrt_tpu.ops.geom import (
    PI,
    dot,
    cross,
    normalize,
    length_sq,
    gamma,
)
from gopbrt_tpu.ops.static_info import PrimInfo

# primitive type tags
SPHERE = 0
DISK = 1
TRIANGLE = 2

_BIG = jnp.float32(1e30)


class AnimPrims(NamedTuple):
    """Two-keyframe per-primitive animation over the camera shutter —
    the working TransformedPrimitive + AnimatedTransform
    (``pkg/pbrt/primitive.go:82-129``, ``pkg/pbrt/transform.go:512-631``;
    the reference's decompose is a TODO so any real animation nil-derefs —
    quirk #9).  Decomposed T/R/S keyframes (ops/quaternion.decompose) so
    interpolation is lerp + slerp per lane at ray time."""

    t0: jnp.ndarray  # f32[P,3] translation keyframes
    t1: jnp.ndarray
    q0: jnp.ndarray  # f32[P,4] rotation keyframes (x,y,z,w)
    q1: jnp.ndarray  # (sign-aligned to q0 for shortest-path slerp)
    s0: jnp.ndarray  # f32[P,4,4] scale/shear remainders
    s1: jnp.ndarray
    animated: jnp.ndarray  # bool[P] — False lanes use the static transform


def anim_o2w(anim: AnimPrims, i, time) -> jnp.ndarray:
    """Interpolated object->world of primitive(s) ``i`` at ``time`` in
    [0,1] (AnimatedTransform.Interpolate, transform.go:564-631).  ``i``
    scalar or int32[N]; time broadcastable to i's batch shape."""
    from gopbrt_tpu.ops import quaternion as quat

    dt = jnp.clip(jnp.asarray(time, jnp.float32), 0.0, 1.0)
    t = geom.lerp(dt[..., None], anim.t0[i], anim.t1[i])
    q = quat.slerp(dt, anim.q0[i], anim.q1[i])
    s = geom.lerp(dt[..., None, None], anim.s0[i], anim.s1[i])
    m = jnp.matmul(quat.quat_to_matrix(q), s,
                   precision=jax.lax.Precision.HIGHEST)
    return m.at[..., :3, 3].add(t)


def _prim_xforms_at(prims: "Primitives", i, time):
    """(o2w, w2o) of primitive(s) i at per-lane time; static prims keep
    their build transforms exactly (no interpolation round-trip)."""
    if prims.anim is None or time is None:
        return prims.obj_to_world[i], prims.world_to_obj[i]
    o2w_a = anim_o2w(prims.anim, i, time)
    w2o_a = jnp.linalg.inv(o2w_a)
    is_anim = prims.anim.animated[i]
    while jnp.ndim(is_anim) < o2w_a.ndim:
        is_anim = is_anim[..., None]
    o2w = jnp.where(is_anim, o2w_a, jnp.broadcast_to(prims.obj_to_world[i], o2w_a.shape))
    w2o = jnp.where(is_anim, w2o_a, jnp.broadcast_to(prims.world_to_obj[i], w2o_a.shape))
    return o2w, w2o


class Primitives(NamedTuple):
    """SoA primitive table — the whole scene geometry as flat arrays.

    Counterpart of the reference's []Primitive of GeometricPrimitive /
    TransformedPrimitive objects (pkg/pbrt/primitive.go); object instancing
    (TransformedPrimitive, primitive.go:82-129) is expressed by the
    per-primitive object->world transform pair.

    params layout (f32[P, 9]):
      sphere   [radius, z_min, z_max, phi_max_rad, 0...]      (object space)
      disk     [height, radius, inner_radius, phi_max_rad, 0...]
      triangle [p0x,p0y,p0z, p1x,p1y,p1z, p2x,p2y,p2z]        (world space)
    """

    prim_type: jnp.ndarray  # int32[P]
    obj_to_world: jnp.ndarray  # f32[P,4,4]
    world_to_obj: jnp.ndarray  # f32[P,4,4]
    params: jnp.ndarray  # f32[P,9]
    material_id: jnp.ndarray  # int32[P]
    area_light_id: jnp.ndarray  # int32[P], -1 = not an emitter
    reverse_orientation: jnp.ndarray  # bool[P] (xor'd with handedness swap)
    # static (trace-time) shape-set descriptor; None = assume all types.
    # SceneBuilder.build() fills it so single-type scenes compile only the
    # kernels they need (ops/static_info.py).
    pinfo: PrimInfo = None
    # two-keyframe animation table; None (the common case) compiles all
    # time-interpolation out of the intersectors
    anim: "AnimPrims" = None
    # per-primitive medium interface (MediumAccessor, medium.go:15-25):
    # ids into Scene.media; -1 = vacuum.  None (the common case) compiles
    # all medium-boundary handling out of the integrators.
    medium_inside: jnp.ndarray = None  # int32[P]
    medium_outside: jnp.ndarray = None  # int32[P]

    @property
    def count(self) -> int:
        return self.prim_type.shape[0]

    @property
    def types(self) -> tuple:
        return (SPHERE, DISK, TRIANGLE) if self.pinfo is None else self.pinfo.types


class SurfaceInteraction(NamedTuple):
    """SoA hit record (counterpart of pkg/pbrt/interaction.go:130-148).

    Geometry in world space.  ``valid`` masks misses; all other fields are
    defined (zero/defaults) for missed lanes so downstream math is safe.
    """

    valid: jnp.ndarray  # bool[N]
    t: jnp.ndarray  # f32[N]
    p: jnp.ndarray  # f32[N,3]
    p_err: jnp.ndarray  # f32[N,3]
    n: jnp.ndarray  # f32[N,3]  geometric normal
    ns: jnp.ndarray  # f32[N,3]  shading normal
    uv: jnp.ndarray  # f32[N,2]
    dpdu: jnp.ndarray  # f32[N,3]
    dpdv: jnp.ndarray  # f32[N,3]
    wo: jnp.ndarray  # f32[N,3]
    prim_idx: jnp.ndarray  # int32[N]


# ---------------------------------------------------------------------------
# Per-type t-only tests.  Each takes object-OR-world-space rays per its
# convention and a single primitive's params, vectorised over rays.
# Returns t (f32, _BIG on miss).
# ---------------------------------------------------------------------------


def _quadratic(a, b, c):
    """Stable quadratic roots; returns (has_roots, t0, t1), t0 <= t1.

    f32 rewrite of pkg/efloat/math.go:35-59 using the -0.5*(b+sign(b)*sqrt(D))
    formulation to avoid catastrophic cancellation.
    """
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.where(b < 0.0, -root, root))
    t0 = q / jnp.where(a == 0.0, 1.0, a)
    t1 = c / jnp.where(q == 0.0, 1.0, q)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    return ok & (a != 0.0), lo, hi


def _sphere_roots(oo, od, radius):
    """Roots of |o + t d|² = r² in object space.

    Recentred ("perpendicular foot") formulation: the naive b²-4ac
    discriminant loses ~3 digits in f32 whenever |oo| >> r (distant
    spheres), corrupting every hit at the 1e-3 level.  Evaluating the
    foot-of-perpendicular vector f = oo + t_foot·od keeps all operands at
    O(r) scale, giving ~1e-6 relative t error — the f32-friendly stand-in
    for the reference's EFloat interval solve (pkg/efloat/math.go:35-59).
    """
    a = length_sq(od)
    safe_a = jnp.where(a == 0.0, 1.0, a)
    t_foot = -dot(oo, od) / safe_a
    f = oo + od * t_foot[..., None]
    disc_core = radius * radius - length_sq(f)
    ok = (disc_core >= 0.0) & (a > 0.0)
    delta = jnp.sqrt(jnp.maximum(disc_core, 0.0) / safe_a)
    return ok, t_foot - delta, t_foot + delta


def _sphere_clip_ok(oo, od, t, radius, z_min, z_max, phi_max):
    """Partial-sphere clip test for a candidate root (sphere.go:110-135)."""
    p = oo + od * t[..., None]
    # reproject to the sphere (sphere.go:100-104)
    p = p * (radius / jnp.maximum(geom.length(p), 1e-20))[..., None]
    z = p[..., 2]
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    full = (z_min <= -radius) & (z_max >= radius) & (phi_max >= 2.0 * PI - 1e-6)
    clipped_ok = (z >= z_min) & (z <= z_max) & (phi <= phi_max)
    return full | clipped_ok


def sphere_t(oo, od, t_max, params):
    """Closest valid sphere hit t in object space (with t1 retry,
    sphere.go:85-96,110-135); _BIG on miss.  oo/od: f32[...,3]."""
    radius, z_min, z_max, phi_max = (params[..., 0], params[..., 1], params[..., 2], params[..., 3])
    ok, t0, t1 = _sphere_roots(oo, od, radius)
    t_eps = _sphere_t_eps(oo, od)
    valid0 = ok & (t0 > t_eps) & (t0 < t_max) & _sphere_clip_ok(oo, od, t0, radius, z_min, z_max, phi_max)
    valid1 = ok & (t1 > t_eps) & (t1 < t_max) & _sphere_clip_ok(oo, od, t1, radius, z_min, z_max, phi_max)
    t = jnp.where(valid0, t0, jnp.where(valid1, t1, _BIG))
    return t


def _sphere_t_eps(oo, od):
    """Conservative minimum-t: scaled epsilon replacing EFloat's low-bound
    check (sphere.go:85 ``t0.UpperBound() <= 0``)."""
    return 1e-4 * jnp.sqrt(jnp.maximum(length_sq(oo), 1.0)) / jnp.maximum(
        jnp.sqrt(length_sq(od)), 1e-20
    )


def disk_t(oo, od, t_max, params):
    """Disk plane hit in object space (pkg/shapes/disk.go:64-126)."""
    height, radius, inner_radius, phi_max = (params[..., 0], params[..., 1], params[..., 2], params[..., 3])
    dz = od[..., 2]
    parallel = jnp.abs(dz) < 1e-12
    t = (height - oo[..., 2]) / jnp.where(parallel, 1.0, dz)
    p = oo + od * t[..., None]
    dist2 = p[..., 0] ** 2 + p[..., 1] ** 2
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    valid = (
        (~parallel)
        & (t > 1e-4)
        & (t < t_max)
        & (dist2 <= radius * radius)
        & (dist2 >= inner_radius * inner_radius)
        & (phi <= phi_max)
    )
    return jnp.where(valid, t, _BIG)


def triangle_t(o, d, t_max, params):
    """Möller–Trumbore triangle hit in world space, f32 with conservative
    epsilons (the reference has no triangles; PBRT parity feature).
    Returns t; _BIG on miss."""
    p0 = params[..., 0:3]
    p1 = params[..., 3:6]
    p2 = params[..., 6:9]
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = cross(d, jnp.broadcast_to(e2, d.shape))
    det = dot(jnp.broadcast_to(e1, d.shape), pvec)
    degenerate = jnp.abs(det) < 1e-12
    inv_det = 1.0 / jnp.where(degenerate, 1.0, det)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, jnp.broadcast_to(e1, tvec.shape))
    v = dot(d, qvec) * inv_det
    t = dot(jnp.broadcast_to(e2, d.shape), qvec) * inv_det
    valid = (
        (~degenerate)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 1e-4)
        & (t < t_max)
    )
    return jnp.where(valid, t, _BIG)


# ---------------------------------------------------------------------------
# Phase 1: closest-hit t for one primitive (type-dispatched), batched rays.
# ---------------------------------------------------------------------------


def prim_t(prims: Primitives, i, o, d, t_max, time=None):
    """t of primitive i against world-space rays (o, d); _BIG on miss.

    ``i`` may be traced.  Type dispatch via masked evaluation of the shape
    kernels present in the table — no lax.switch sequencing for a 3-way
    closed set, and it fuses into one elementwise program.

    time: f32[N] ray times in [0,1] for animated scenes (prims.anim set) —
    the transform is interpolated per lane (TransformedPrimitive.Intersect,
    primitive.go:92-101).  Ignored (compiled out) for static scenes.
    """
    types = prims.types
    ptype = prims.prim_type[i]
    params = prims.params[i]
    if SPHERE in types or DISK in types:
        _, w2o = _prim_xforms_at(prims, i, time)
        oo = geom.apply_point_affine(w2o, o)
        od = geom.apply_vector(w2o, d)
    t = jnp.full(o.shape[:-1], _BIG, jnp.float32)
    if SPHERE in types:
        t = jnp.where(ptype == SPHERE, sphere_t(oo, od, t_max, params), t)
    if DISK in types:
        t = jnp.where(ptype == DISK, disk_t(oo, od, t_max, params), t)
    if TRIANGLE in types:
        t = jnp.where(ptype == TRIANGLE, triangle_t(o, d, t_max, params), t)
    return t


def intersect_brute(prims: Primitives, o, d, t_max, time=None):
    """O(n) closest hit over all primitives (pkg/accelerator/simple.go:47-70).

    Returns (hit_mask[N], t[N], prim_idx[N]).  Memory O(N*P) — the oracle
    and small-scene path; large scenes use the BVH (ops/bvh.py).
    """
    P = prims.count

    def per_prim(i):
        return prim_t(prims, i, o, d, t_max, time=time)

    all_t = jax.vmap(per_prim)(jnp.arange(P))  # [P, N]
    best = jnp.argmin(all_t, axis=0)  # [N]
    t = jnp.min(all_t, axis=0)
    hit = t < _BIG
    return hit, jnp.where(hit, t, t_max), best.astype(jnp.int32)


def intersect_p_brute(prims: Primitives, o, d, t_max, time=None):
    """Any-hit / shadow-ray test (simple.go:71-79). Returns bool[N]."""
    P = prims.count
    all_t = jax.vmap(lambda i: prim_t(prims, i, o, d, t_max, time=time))(
        jnp.arange(P)
    )
    return jnp.any(all_t < _BIG, axis=0)


# ---------------------------------------------------------------------------
# Phase 2: full SurfaceInteraction for known (t, prim_idx).
# Counterpart of the geometry blocks of sphere.go:137-187 / disk.go:64-126.
# ---------------------------------------------------------------------------


def _sphere_geometry(oo, od, t, params):
    """Object-space partial derivatives & uv at hit (sphere.go:137-167)."""
    radius, z_min, z_max, phi_max = (params[..., 0], params[..., 1], params[..., 2], params[..., 3])
    p = oo + od * t[..., None]
    p = p * (radius / jnp.maximum(geom.length(p), 1e-20))[..., None]
    # avoid x=y=0 degenerate phi (sphere.go:138-140)
    tiny = (jnp.abs(p[..., 0]) < 1e-10) & (jnp.abs(p[..., 1]) < 1e-10)
    p = p.at[..., 0].set(jnp.where(tiny, 1e-5 * radius, p[..., 0]))
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    theta = jnp.arccos(jnp.clip(p[..., 2] / radius, -1.0, 1.0))
    theta_min = jnp.arccos(jnp.clip(z_min / radius, -1.0, 1.0))
    theta_max = jnp.arccos(jnp.clip(z_max / radius, -1.0, 1.0))
    u = phi / phi_max
    denom = theta_max - theta_min
    safe_denom = jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    v = jnp.where(jnp.abs(denom) > 1e-12, (theta - theta_min) / safe_denom, 0.0)
    z_radius = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    inv_zr = 1.0 / jnp.maximum(z_radius, 1e-20)
    cos_phi = p[..., 0] * inv_zr
    sin_phi = p[..., 1] * inv_zr
    dpdu = jnp.stack(
        [-phi_max * p[..., 1], phi_max * p[..., 0], jnp.zeros_like(phi)], axis=-1
    )
    dpdv = (
        jnp.stack(
            [p[..., 2] * cos_phi, p[..., 2] * sin_phi, -radius * jnp.sin(theta)],
            axis=-1,
        )
        * denom[..., None]
    )
    uv = jnp.stack([u, v], axis=-1)
    p_err = jnp.abs(p) * gamma(5)
    n = normalize(p)
    return p, p_err, n, uv, dpdu, dpdv


def _disk_geometry(oo, od, t, params):
    height, radius, inner_radius, phi_max = (params[..., 0], params[..., 1], params[..., 2], params[..., 3])
    p = oo + od * t[..., None]
    p = p.at[..., 2].set(height)
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    dist = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    u = phi / phi_max
    one_minus = radius - inner_radius
    v = jnp.where(one_minus > 1e-12, (radius - dist) / jnp.maximum(one_minus, 1e-12), 0.0)
    dpdu = jnp.stack([-phi_max * p[..., 1], phi_max * p[..., 0], jnp.zeros_like(phi)], axis=-1)
    dpdv = jnp.stack([p[..., 0], p[..., 1], jnp.zeros_like(phi)], axis=-1) * (
        jnp.where(dist > 1e-12, (inner_radius - radius) / jnp.maximum(dist, 1e-12), 0.0)
    )[..., None]
    n = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), p.shape)
    uv = jnp.stack([u, v], axis=-1)
    p_err = jnp.zeros_like(p)
    return p, p_err, n, uv, dpdu, dpdv


def _triangle_geometry(o, d, t, params):
    p0, p1, p2 = params[..., 0:3], params[..., 3:6], params[..., 6:9]
    p = o + d * t[..., None]
    e1 = p1 - p0
    e2 = p2 - p0
    ng = cross(jnp.broadcast_to(e1, p.shape), jnp.broadcast_to(e2, p.shape))
    n = normalize(ng, eps=1e-30)
    dpdu = jnp.broadcast_to(e1, p.shape)
    dpdv = jnp.broadcast_to(e2, p.shape)
    # barycentric uv
    pvec = cross(d, jnp.broadcast_to(e2, d.shape))
    det = dot(jnp.broadcast_to(e1, d.shape), pvec)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, jnp.broadcast_to(e1, tvec.shape))
    v = dot(d, qvec) * inv_det
    uv = jnp.stack([u, v], axis=-1)
    p_err = gamma(7) * jnp.abs(p)
    return p, p_err, n, uv, dpdu, dpdv


# Row gathers by per-lane primitive id.  Small tables go through a one-hot
# matmul at HIGHEST precision (exact: one nonzero term per output); beyond
# the cutoff, a real gather.  Which is faster on a GPU is not yet measured.
ONE_HOT_GATHER_MAX = 256


def gather_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx] for table f32[P, ...], idx int32[N] -> [N, ...]."""
    p = table.shape[0]
    if p > ONE_HOT_GATHER_MAX or table.dtype not in (jnp.float32, jnp.bfloat16):
        return table[idx]
    flat = table.reshape(p, -1)
    oh = jax.nn.one_hot(idx, p, dtype=table.dtype)
    out = jnp.dot(oh, flat, preferred_element_type=table.dtype,
                  precision=jax.lax.Precision.HIGHEST)
    return out.reshape(idx.shape + table.shape[1:])


def surface_interaction(
    prims: Primitives, hit, t, prim_idx, o, d, time=None
) -> SurfaceInteraction:
    """Phase-2: build the full world-space SurfaceInteraction for winners.

    Counterpart of the object->world transform at sphere.go:172-187 and
    interaction.go's normal orientation rules.  With ``time`` and an
    animated scene, the winner's transform pair is interpolated at the
    ray's time (TransformedPrimitive.Intersect's post-transform,
    primitive.go:103-110).
    """
    types = prims.types
    has_xf = SPHERE in types or DISK in types  # transformed (object-space) shapes
    ptype = prims.prim_type[prim_idx]  # [N] (int gather: cheap, 1 word)
    params = gather_rows(prims.params, prim_idx)  # [N,9]
    rev = prims.reverse_orientation[prim_idx]
    if has_xf:
        if prims.anim is not None and time is not None:
            o2w, w2o = _prim_xforms_at(prims, prim_idx, time)
        else:
            o2w = gather_rows(prims.obj_to_world, prim_idx)
            w2o = gather_rows(prims.world_to_obj, prim_idx)
        oo = geom.apply_point_affine(w2o, o)
        od = geom.apply_vector(w2o, d)

    geos = []  # (lane_mask, (p, p_err, n, uv, dpdu, dpdv)) per present type
    if SPHERE in types:
        geos.append((ptype == SPHERE, _sphere_geometry(oo, od, t, params)))
    if DISK in types:
        geos.append((ptype == DISK, _disk_geometry(oo, od, t, params)))
    if TRIANGLE in types:
        geos.append((ptype == TRIANGLE, _triangle_geometry(o, d, t, params)))

    def sel(vals):
        acc = vals[-1][1]
        for m, v in vals[-2::-1]:
            mm = m
            while mm.ndim < v.ndim:
                mm = mm[..., None]
            acc = jnp.where(mm, v, acc)
        return acc

    p_l, perr_l, n_l, uv, dpdu_l, dpdv_l = (
        sel([(m, g[k]) for m, g in geos]) for k in range(6)
    )

    is_tri = ptype == TRIANGLE
    if has_xf:
        m_tri = is_tri[..., None]
        # triangles are stored world-space: skip the transform
        p_w, perr_w = geom.apply_point_error(o2w, p_l)
        perr_w = perr_w + geom.apply_vector(jnp.abs(o2w), perr_l)
        n_w = normalize(geom.apply_normal(w2o, n_l), eps=1e-30)
        dpdu_w = geom.apply_vector(o2w, dpdu_l)
        dpdv_w = geom.apply_vector(o2w, dpdv_l)
        if TRIANGLE in types:
            p = jnp.where(m_tri, p_l, p_w)
            p_err = jnp.where(m_tri, perr_l, perr_w)
            n = jnp.where(m_tri, n_l, n_w)
            dpdu = jnp.where(m_tri, dpdu_l, dpdu_w)
            dpdv = jnp.where(m_tri, dpdv_l, dpdv_w)
        else:
            p, p_err, n, dpdu, dpdv = p_w, perr_w, n_w, dpdu_w, dpdv_w
        swap = geom.swaps_handedness(o2w)
        flip = jnp.logical_xor(rev, jnp.where(is_tri, False, swap))
    else:  # triangle-only table: world space throughout, no transforms
        p, p_err, n, dpdu, dpdv = p_l, perr_l, n_l, dpdu_l, dpdv_l
        flip = rev
    n = jnp.where(flip[..., None], -n, n)
    ns = n  # no bump mapping / vertex normals yet (reference's Bump is a stub)
    wo = normalize(-d, eps=1e-30)
    return SurfaceInteraction(
        valid=hit,
        t=t,
        p=p,
        p_err=p_err,
        n=n,
        ns=ns,
        uv=uv,
        dpdu=dpdu,
        dpdv=dpdv,
        wo=wo,
        prim_idx=prim_idx,
    )


def spawn_ray(si: SurfaceInteraction, d_new: jnp.ndarray) -> jnp.ndarray:
    """Robust ray origin for a secondary ray leaving the surface
    (interaction.go:68 SpawnRay + ray.go:57 OffsetRayOrigin)."""
    return geom.offset_ray_origin(si.p, si.p_err + 1e-4, si.n, d_new)
