"""Pallas kernel (Triton route): brute-force ray casting over a small
primitive table.

The hot intersection loop of the reference — leaf tests plus the sphere
and disk intersects (``pkg/accelerator/bvh.go:659-765``,
``pkg/pbrt/sphere.go:64-135``, ``pkg/shapes/disk.go:64-159``) — for scenes
small enough that a dense test beats a BVH walk.

Why a kernel: the plain version (``ops/intersect.intersect_brute``) vmaps
the per-primitive test over P and reduces ``[P, N]`` intermediates with
``argmin``/``any``.  Here each program takes ``BLOCK`` rays, loops over
the primitives in order and keeps the running ``(t, idx)`` in registers:
it reads 7 floats and writes 2 per ray.  The any-hit variant stops a
block's loop once every lane is occluded or dead.

Layout: rays stay in their ``[N, 3]`` arrays; each program loads its own
slice with a bounds mask (no padding copy).  The primitive table
(``[P, 22]``: type, 12 world->object entries, 9 params — a few KB) is read
as scalars by every program and stays in L1/L2.

``closest_hit`` / ``any_hit`` pick the kernel when the call is lowered for
CUDA and the plain jnp version everywhere else; ``interpret=True`` (tests
only) runs the kernel body in the Pallas interpreter.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gopbrt_tpu.ops import intersect as isect
from gopbrt_tpu.ops.intersect import Primitives, SPHERE, DISK, TRIANGLE

BLOCK = 256  # rays per program (power of two, as Triton requires)
NUM_WARPS = 4
UNROLL_MAX = 32  # static-unroll the closest-hit primitive loop up to this P
_BIG = 1e30
_COLS = 22  # table row: [type, w2o (12), params (9)]
_DEAD_T = 2e-4  # any-hit: t_max at or below this marks a masked lane


def _prim_test(ptype, m, pr, ox, oy, oz, dx, dy, dz, t_limit,
               types=(SPHERE, DISK, TRIANGLE), full_sph=False, full_disk=False):
    """One primitive vs a block of rays -> candidate t ([B] f32, _BIG miss).

    ptype/m/pr are scalars; rays are [B] vectors.  m: 12 affine
    world->object entries (row-major 3x4); pr: 9 params.  types/full_sph/
    full_disk are STATIC (from Primitives.pinfo): absent shape tests and the
    partial-sphere/disk clip tests compile out.  Same arithmetic as
    ops/intersect.prim_t, written per component.
    """
    if SPHERE in types or DISK in types:
        # world->object transform (triangles live in world space)
        oox = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
        ooy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
        ooz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
        odx = m[0] * dx + m[1] * dy + m[2] * dz
        ody = m[4] * dx + m[5] * dy + m[6] * dz
        odz = m[8] * dx + m[9] * dy + m[10] * dz

    if (SPHERE in types and not full_sph) or (DISK in types and not full_disk):
        # phi <= phi_max without atan2: wedge test against the phi_max ray
        # by the sign of the 2D cross product
        sin_pm = jnp.sin(pr[3])
        cos_pm = jnp.cos(pr[3])
        pm_le_pi = pr[3] <= math.pi

        def in_wedge(x, y):
            cross = x * sin_pm - y * cos_pm
            narrow = (y >= 0.0) & (cross >= 0.0)
            wide = ~((y < 0.0) & (cross < 0.0))
            return jnp.where(pm_le_pi, narrow, wide)

    t_best = None

    if SPHERE in types:
        # sphere (params: radius, zmin, zmax, phimax) — recentred quadratic
        # (perpendicular-foot form; see ops.intersect._sphere_roots)
        radius = pr[0]
        a = odx * odx + ody * ody + odz * odz
        safe_a = jnp.where(a == 0.0, 1.0, a)
        t_foot = -(oox * odx + ooy * ody + ooz * odz) / safe_a
        fx = oox + odx * t_foot
        fy = ooy + ody * t_foot
        fz = ooz + odz * t_foot
        disc_core = radius * radius - (fx * fx + fy * fy + fz * fz)
        ok = (disc_core >= 0.0) & (a > 0.0)
        delta = jnp.sqrt(jnp.maximum(disc_core, 0.0) / safe_a)
        lo = t_foot - delta
        hi = t_foot + delta
        olen = jnp.sqrt(jnp.maximum(oox * oox + ooy * ooy + ooz * ooz, 1.0))
        dlen = jnp.sqrt(jnp.maximum(a, 1e-20))
        t_eps = 1e-4 * olen / dlen

        if full_sph:
            def clip_ok(t):
                return True
        else:
            full = (pr[1] <= -radius) & (pr[2] >= radius) & (
                pr[3] >= 2.0 * math.pi - 1e-6
            )

            def clip_ok(t):
                px = oox + odx * t
                py = ooy + ody * t
                pz = ooz + odz * t
                norm = jnp.sqrt(jnp.maximum(px * px + py * py + pz * pz, 1e-20))
                s = radius / norm
                pz = pz * s
                part = (pz >= pr[1]) & (pz <= pr[2]) & in_wedge(px * s, py * s)
                return full | part

        v0 = ok & (lo > t_eps) & (lo < t_limit) & clip_ok(lo)
        v1 = ok & (hi > t_eps) & (hi < t_limit) & clip_ok(hi)
        t_best = jnp.where(v0, lo, jnp.where(v1, hi, _BIG))

    if DISK in types:
        # disk (params: height, radius, inner, phimax)
        parallel = jnp.abs(odz) < 1e-12
        t_pl = (pr[0] - ooz) / jnp.where(parallel, 1.0, odz)
        pxd = oox + odx * t_pl
        pyd = ooy + ody * t_pl
        d2 = pxd * pxd + pyd * pyd
        vd = (
            (~parallel)
            & (t_pl > 1e-4)
            & (t_pl < t_limit)
            & (d2 <= pr[1] * pr[1])
        )
        if not full_disk:
            fd = pr[3] >= 2.0 * math.pi - 1e-6
            vd = vd & (d2 >= pr[2] * pr[2]) & (fd | in_wedge(pxd, pyd))
        t_dsk = jnp.where(vd, t_pl, _BIG)
        t_best = t_dsk if t_best is None else jnp.where(ptype == DISK, t_dsk, t_best)

    if TRIANGLE in types:
        # triangle (params: 3 world-space vertices), Moller-Trumbore
        e1x, e1y, e1z = pr[3] - pr[0], pr[4] - pr[1], pr[5] - pr[2]
        e2x, e2y, e2z = pr[6] - pr[0], pr[7] - pr[1], pr[8] - pr[2]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        degen = jnp.abs(det) < 1e-12
        inv_det = 1.0 / jnp.where(degen, 1.0, det)
        tvx, tvy, tvz = ox - pr[0], oy - pr[1], oz - pr[2]
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        vt = (
            (~degen)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (tt > 1e-4)
            & (tt < t_limit)
        )
        t_tri = jnp.where(vt, tt, _BIG)
        t_best = t_tri if t_best is None else jnp.where(ptype == TRIANGLE, t_tri, t_best)

    return t_best


def _load_rays(n, o_ref, d_ref, tmax_ref):
    """This program's slice of rays; lanes past n read as dead (t_max -1)."""
    start = pl.program_id(0) * BLOCK
    mask = start + jnp.arange(BLOCK) < n
    rows = pl.ds(start, BLOCK)

    def col(ref, k, other):
        return plgpu.load(ref.at[rows, k], mask=mask, other=other)

    rays = (col(o_ref, 0, 0.0), col(o_ref, 1, 0.0), col(o_ref, 2, 0.0),
            col(d_ref, 0, 0.0), col(d_ref, 1, 0.0), col(d_ref, 2, 1.0))
    tmax = plgpu.load(tmax_ref.at[rows], mask=mask, other=-1.0)
    return rows, mask, rays, tmax


def _row(tab_ref, p):
    """(type, w2o[12], params[9]) scalars of primitive p."""
    ptype = tab_ref[p, 0].astype(jnp.int32)
    m = [tab_ref[p, 1 + k] for k in range(12)]
    pr = [tab_ref[p, 13 + k] for k in range(9)]
    return ptype, m, pr


def _closest_kernel(n, n_prims, shapes, tab_ref, o_ref, d_ref, tmax_ref,
                    t_ref, idx_ref):
    rows, mask, rays, t_best = _load_rays(n, o_ref, d_ref, tmax_ref)
    idx_best = jnp.full((BLOCK,), -1, jnp.int32)

    def step(p, t_best, idx_best):
        ptype, m, pr = _row(tab_ref, p)
        tp = _prim_test(ptype, m, pr, *rays, t_best, *shapes)
        # strict < in prim order: a tie keeps the lower index, as argmin does
        better = tp < t_best
        return jnp.where(better, tp, t_best), jnp.where(better, p, idx_best)

    if n_prims <= UNROLL_MAX:
        for p in range(n_prims):
            t_best, idx_best = step(p, t_best, idx_best)
    else:
        t_best, idx_best = jax.lax.fori_loop(
            0, n_prims, lambda p, c: step(p, *c), (t_best, idx_best)
        )
    plgpu.store(t_ref.at[rows], t_best, mask=mask)
    plgpu.store(idx_ref.at[rows], idx_best, mask=mask)


def _any_kernel(n, n_prims, shapes, tab_ref, o_ref, d_ref, tmax_ref, occ_ref):
    """TRUE any-hit (VisibilityTester.Unoccluded, light.go:46-48): no winner
    reduction, and the primitive loop exits once every lane of the block is
    resolved (occluded, or dead: t_max <= 2e-4 marks the masked shadow rays
    the integrators emit for non-contributing lanes)."""
    rows, mask, rays, tmax = _load_rays(n, o_ref, d_ref, tmax_ref)
    dead = (tmax <= _DEAD_T).astype(jnp.int32)

    def cond(carry):
        p, occ = carry
        return (p < n_prims) & (jnp.min(occ | dead) == 0)

    def body(carry):
        p, occ = carry
        ptype, m, pr = _row(tab_ref, p)
        tp = _prim_test(ptype, m, pr, *rays, tmax, *shapes)
        return p + 1, occ | (tp < tmax).astype(jnp.int32)

    _, occ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros((BLOCK,), jnp.int32))
    )
    plgpu.store(occ_ref.at[rows], occ, mask=mask)


def _table(prims: Primitives) -> jnp.ndarray:
    """[P, 22] f32 rows: type, world->object rows 0..2, params."""
    return jnp.concatenate(
        [
            prims.prim_type.astype(jnp.float32)[:, None],
            prims.world_to_obj[:, :3, :].reshape(prims.count, 12),
            prims.params,
        ],
        axis=1,
    )


def _shapes(prims: Primitives):
    pinfo = prims.pinfo
    return (
        prims.types,
        pinfo.all_full_spheres if pinfo is not None else False,
        pinfo.all_full_disks if pinfo is not None else False,
    )


def _call(kernel, prims, o, d, t_max, out_shape, interpret):
    n = o.shape[0]
    return pl.pallas_call(
        functools.partial(kernel, n, prims.count, _shapes(prims)),
        grid=(pl.cdiv(n, BLOCK),),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(_table(prims), o, d, t_max)


@functools.partial(jax.jit, static_argnames=("interpret",))
def intersect_brute_pallas(prims: Primitives, o, d, t_max, interpret=False):
    """Kernel form of ops.intersect.intersect_brute (static scenes):
    (hit[N], t[N], prim_idx[N])."""
    n = o.shape[0]
    t, idx = _call(
        _closest_kernel, prims, o, d, t_max,
        (jax.ShapeDtypeStruct((n,), jnp.float32),
         jax.ShapeDtypeStruct((n,), jnp.int32)),
        interpret,
    )
    hit = idx >= 0
    return hit, jnp.where(hit, t, t_max), jnp.maximum(idx, 0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def intersect_p_brute_pallas(prims: Primitives, o, d, t_max, interpret=False):
    """Kernel form of ops.intersect.intersect_p_brute: occluded bool[N]."""
    n = o.shape[0]
    occ = _call(
        _any_kernel, prims, o, d, t_max,
        jax.ShapeDtypeStruct((n,), jnp.int32), interpret,
    )
    return occ > 0


def _detached(prims, o, d, t_max):
    return jax.tree.map(jax.lax.stop_gradient, (prims, o, d, t_max))


def closest_hit(prims: Primitives, o, d, t_max):
    """Closest hit over every primitive (static scenes): the kernel when
    lowered for CUDA, ``intersect_brute`` elsewhere.  Detached from
    autodiff, like every intersection search in the integrators."""
    return jax.lax.platform_dependent(
        *_detached(prims, o, d, t_max),
        cuda=intersect_brute_pallas, default=isect.intersect_brute,
    )


def any_hit(prims: Primitives, o, d, t_max):
    """Shadow-ray occlusion over every primitive (static scenes): the
    kernel when lowered for CUDA, ``intersect_p_brute`` elsewhere."""
    return jax.lax.platform_dependent(
        *_detached(prims, o, d, t_max),
        cuda=intersect_p_brute_pallas, default=isect.intersect_p_brute,
    )
