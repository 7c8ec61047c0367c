"""Wavefront integrators: path tracing + direct lighting under ``jit``.

This is the re-design of the reference's per-ray recursive integrators —
``pkg/integrator/path.go:32-157`` (Path.Li) and
``pkg/integrator/directlighting.go`` — and the NEE/MIS estimator
``EstimateDirect`` (``pkg/pbrt/integrator.go:79-195``) as a *wavefront*:
the whole ray batch advances through the bounce loop together as flat SoA
arrays with an alive mask.  Per-ray recursion becomes a
``lax.fori_loop`` over a static max depth; Russian roulette kills lanes by
masking.  This is the standard megakernel->wavefront transformation for
SIMD ray tracing, and the natural fit for XLA's static-shape model.

Differentiability: the radiance estimate is differentiable w.r.t. scene
parameters (material/texture/light tables).  Discrete sampling decisions —
light pick, lobe pick, RR acceptance, BVH hit selection — are detached
(``stop_gradient``), the standard detached-sampling estimator; the f/pdf
throughput factors and emitted radiance keep gradients.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gopbrt_tpu.ops import bsdf as bsdf_ops
from gopbrt_tpu.ops import geom
from gopbrt_tpu.ops import intersect as isect
from gopbrt_tpu.ops import lights as light_ops
from gopbrt_tpu.ops import pallas_intersect as brute_kernel
from gopbrt_tpu.ops import rng
from gopbrt_tpu.ops import sampling
from gopbrt_tpu.ops import texture as tex_ops
from gopbrt_tpu.ops.geom import dot, normalize
from gopbrt_tpu.models.scene import Scene

# sampling-dimension layout: defined in ops/rng.py; re-exported here for
# the existing call sites.
from gopbrt_tpu.ops.rng import (  # noqa: F401  (re-exports)
    DIM_CAMERA,
    DIMS_PER_BOUNCE,
    DIM_BOUNCE_BASE,
    D_LIGHT_PICK,
    D_LIGHT_UV,
    D_BSDF_UV,
    D_BSDF_LOBE,
    D_RR,
    D_SSS,
    D_MEDIUM,
    D_PHASE,
)


class PathConfig(NamedTuple):
    """Static integrator configuration (NewPath, path.go:10-17)."""

    max_depth: int = 5
    rr_threshold: float = 1.0
    rr_start_depth: int = 3  # RR after 3 bounces (path.go:143-153)
    nee: bool = True  # next-event estimation on
    mis: bool = True  # MIS with BSDF samples hitting lights
    # wavefront compaction: after each bounce, sort alive lanes to the
    # front and process only ceil(alive/chunk) chunks of the next bounce.
    # Off by default: it trades a gather/scatter of ~100 B/lane of state
    # for the dead-lane work it skips, and its dynamic-trip-count loops
    # are not reverse-mode differentiable.
    compaction: bool = False
    chunk_size: int = 1 << 18  # lanes per compacted chunk
    # full-width bounce loop with early exit once every lane is dead
    # (while_loop — forward-only; autodiff uses the static fori_loop)
    early_exit: bool = False
    # max consecutive null-material boundary crossings handled per bounce
    # (path.go:72-78 passthrough, expressed as a static segment walk);
    # only compiled in for scenes that contain a null material
    null_passes: int = 2


# below this primitive count the dense test over every primitive beats a
# BVH walk (ops/pallas_intersect on CUDA, ops/intersect elsewhere)
BRUTE_FORCE_CUTOFF = 64


def _scene_intersect(scene: Scene, o, d, t_max, time=None):
    """Closest hit -> (hit, t, prim_idx); BVH when attached, else brute.

    Intersection search is a discrete decision — detached from autodiff
    (detached-sampling estimator); shading re-derives hit geometry
    differentiably from (t, prim_idx) in surface_interaction.

    time: per-lane shutter times [0,1] — only consulted when the scene has
    animated primitives (prims.anim); static scenes compile it out.
    """
    anim = scene.prims.anim is not None and time is not None
    if scene.bvh is not None and scene.prims.count > BRUTE_FORCE_CUTOFF:
        from gopbrt_tpu.ops import bvh as bvh_mod

        return bvh_mod.bvh_intersect(
            scene.bvh, scene.prims, o, d, t_max, time=time if anim else None
        )
    if anim:
        return isect.intersect_brute(scene.prims, o, d, t_max, time=time)
    return brute_kernel.closest_hit(scene.prims, o, d, t_max)


def _scene_intersect_p(scene: Scene, o, d, t_max, time=None):
    anim = scene.prims.anim is not None and time is not None
    if scene.bvh is not None and scene.prims.count > BRUTE_FORCE_CUTOFF:
        from gopbrt_tpu.ops import bvh as bvh_mod

        return bvh_mod.bvh_intersect_p(
            scene.bvh, scene.prims, o, d, t_max, time=time if anim else None
        )
    if anim:
        return isect.intersect_p_brute(scene.prims, o, d, t_max, time=time)
    return brute_kernel.any_hit(scene.prims, o, d, t_max)


def _voxel_flat(scene: Scene, p):
    """Flat voxel index of world point p in the spatial light grid."""
    g = scene.light_grid
    v = jnp.floor((p - g.lo) * g.inv_extent * g.dims.astype(jnp.float32))
    v = jnp.clip(v.astype(jnp.int32), 0, g.dims - 1)
    return (v[..., 0] * g.dims[1] + v[..., 1]) * g.dims[2] + v[..., 2]


def _light_pick(scene: Scene, p, u):
    """Pick a light for NEE at shading point p: spatial voxel distribution
    when built (CreateLightSampleDistribution — the Spatial strategy the
    reference returns nil for, lightdistribution.go:11-19), else the global
    uniform/power Distribution1D."""
    if scene.light_grid is not None:
        flat = _voxel_flat(scene, p)
        func = isect.gather_rows(scene.light_grid.func, flat)
        cdf = isect.gather_rows(scene.light_grid.cdf, flat)
        fint = scene.light_grid.func_int[flat]
        return sampling.sample_discrete_rows(func, cdf, fint, u)
    return sampling.sample_discrete(
        scene.light_func, scene.light_cdf, scene.light_func_int, u
    )


def _light_pick_pmf(scene: Scene, p, light_idx):
    """pmf that _light_pick at p would choose light_idx (MIS denominator)."""
    if scene.light_grid is not None:
        flat = _voxel_flat(scene, p)
        func = isect.gather_rows(scene.light_grid.func, flat)
        fint = scene.light_grid.func_int[flat]
        return sampling.pmf_rows(func, fint, light_idx)
    n_lights = max(scene.n_lights, 1)
    return jnp.where(
        scene.light_func_int > 0,
        scene.light_func[light_idx]
        / jnp.maximum(scene.light_func_int * n_lights, 1e-20),
        1.0 / n_lights,
    )


def _apply_bump(scene: Scene, si: isect.SurfaceInteraction, mid):
    """Perturb the shading normal by a bump texture (the intended
    Material.Bump semantics — the reference computes the offset eval point
    then discards it, material.go:18-34).  Finite-difference height along
    dpdu/dpdv; detached offsets keep the estimator consistent."""
    mats = scene.materials
    if mats.bump_tex is None:
        return si
    bt = mats.bump_tex[mid]
    bscale = mats.bump_scale[mid]
    has = bt >= 0
    tex_id = jnp.maximum(bt, 0)
    du = jnp.float32(5e-3)

    def height(p, uv):
        rgb = tex_ops.eval_spectrum(scene.textures, tex_id, p, uv)
        return jnp.mean(rgb, axis=-1)

    h0 = height(si.p, si.uv)
    off_u = jnp.stack([jnp.full_like(h0, du), jnp.zeros_like(h0)], axis=-1)
    off_v = jnp.stack([jnp.zeros_like(h0), jnp.full_like(h0, du)], axis=-1)
    hu = height(si.p + si.dpdu * du, si.uv + off_u)
    hv = height(si.p + si.dpdv * du, si.uv + off_v)
    dhdu = (hu - h0) / du * bscale
    dhdv = (hv - h0) / du * bscale
    ns_b = jnp.cross(si.dpdu + dhdu[..., None] * si.ns,
                     si.dpdv + dhdv[..., None] * si.ns)
    ns_b = normalize(ns_b, eps=1e-20)
    # keep orientation consistent with the original shading normal
    ns_b = jnp.where(dot(ns_b, si.ns)[..., None] < 0.0, -ns_b, ns_b)
    ns = jnp.where(has[..., None], ns_b, si.ns)
    return si._replace(ns=ns)


def _material_at(
    scene: Scene, si: isect.SurfaceInteraction, fw=None
) -> bsdf_ops.MaterialParams:
    """Gather + texture-evaluate material params at hits — the wavefront
    counterpart of ComputeScatteringFunctions (interaction.go:217-223 ->
    matte.go:21-37 etc.).

    All float fields are packed into one [M, 12] matrix so the per-lane
    lookup is a single row gather (ops/intersect.gather_rows).
    """
    mid = scene.prims.material_id[si.prim_idx]
    mats = scene.materials
    packed = jnp.concatenate(
        [
            mats.kd,
            mats.kr,
            mats.kt,
            mats.sigma[:, None],
            mats.eta[:, None],
            mats.roughness[:, None],
        ],
        axis=1,
    )  # [M, 12]
    rows = isect.gather_rows(packed, mid)
    kd_const = rows[..., 0:3]
    kd_tex = mats.kd_tex[mid]
    kd_sampled = tex_ops.eval_spectrum(scene.textures, kd_tex, si.p, si.uv, fw=fw)
    kd = jnp.where((kd_tex >= 0)[..., None], kd_sampled, kd_const)
    return bsdf_ops.MaterialParams(
        mat_type=mats.mat_type[mid],
        kd=kd,
        sigma=rows[..., 9],
        kr=rows[..., 3:6],
        kt=rows[..., 6:9],
        eta=rows[..., 10],
        roughness=rows[..., 11],
        info=mats.info,
        sss_cbar=None if mats.sss_cbar is None else mats.sss_cbar[mid],
    )


def _where_si(mask, a: isect.SurfaceInteraction, b: isect.SurfaceInteraction):
    """Lane-select between two SurfaceInteraction pytrees."""

    def w(x, y):
        m = mask
        while m.ndim < x.ndim:
            m = m[..., None]
        return jnp.where(m, x, y)

    return isect.SurfaceInteraction(*(w(x, y) for x, y in zip(a, b)))


def _subsurface_transport(
    scene: Scene, si, mp, beta, alive, seed, pixel, sample, dim_base, time=None
):
    """BSSRDF transport at subsurface entry hits — the working version of
    the reference's dead hook (path.go:120-141): S = (1-Fr(θo))·Sp·Sw.

    Wavefront scheme (PBRT v3 SeparableBSSRDF::Sample_S re-expressed
    branch-free):
      1. entry Fresnel: with prob Fr the lane becomes a mirror vertex
         (choice prob cancels the Fresnel weight); with prob 1-Fr it
         transmits (cancelling S's (1-Fr(θo)) factor),
      2. probe: sample axis (ns/ss/ts at .5/.25/.25), color channel, Burley
         radius and azimuth; intersect the probe chord against the scene,
      3. accept exits on the same material; beta *= Sp(r)/pdf_Sp (axis- and
         channel-MIS pdf); the lane's interaction is *spliced* to the exit
         point whose BSDF is the Sw lobe (ops/bsdf.SUBSURFACE),
      4. failed probes die (small documented energy loss instead of
         resampling — keeps the loop single-pass).

    KNOWN APPROXIMATION (first-hit probe): PBRT's Sample_Sp enumerates
    every intersection along the probe chord and picks one uniformly
    (weighting Sp by the count) so the realized exit density matches
    Pdf_Sp exactly.  This wavefront version keeps only the FIRST chord
    intersection, which biases the estimator beyond the energy loss of
    step 4: exit points on the far side of folds are unreachable, yet
    pdf_sp still assigns them density from all three projection axes.
    The bias is small for convex/thin geometry (single-sheet chords, the
    common case for SSS) and is accepted to keep the transport
    single-launch; a bounded K-segment probe chain is the upgrade path.

    Returns (si, mp, beta, alive) with subsurface lanes rewritten.
    """
    from gopbrt_tpu.ops import bssrdf as sss_ops

    sss = alive & (mp.mat_type == bsdf_ops.SUBSURFACE)

    u_fr = rng.sample_1d(seed, pixel, sample, dim_base + D_SSS)
    fr = bsdf_ops.fr_dielectric(dot(si.wo, si.ns), 1.0, mp.eta)
    reflect = sss & (u_fr < fr)
    transmit = sss & ~reflect
    # reflect lanes: Fresnel-weighted delta reflection == unit mirror after
    # the choice-probability cancellation
    mp = mp._replace(
        mat_type=jnp.where(reflect, bsdf_ops.MIRROR, mp.mat_type),
        kr=jnp.where(reflect[..., None], 1.0, mp.kr),
    )

    # probe disk sample in the entry frame
    ss_f, ts_f, ns_f = _shading_frame(si)
    u_axis = rng.sample_1d(seed, pixel, sample, dim_base + D_SSS + 1)
    u_chr = rng.sample_1d(seed, pixel, sample, dim_base + D_SSS + 2)
    u_phi = rng.sample_1d(seed, pixel, sample, dim_base + D_SSS + 3)
    vx, vy, vz, _ = sss_ops.sample_axis_frame(u_axis, ss_f, ts_f, ns_f)
    ch = jnp.minimum((u_chr * 3.0).astype(jnp.int32), 2)
    u_r = u_chr * 3.0 - ch.astype(jnp.float32)

    mid = scene.prims.material_id[si.prim_idx]
    d_rgb = isect.gather_rows(scene.materials.sss_d, mid)  # [N,3]
    d_ch = jnp.take_along_axis(d_rgb, ch[..., None], axis=-1)[..., 0]
    r = sss_ops.burley_sample_r(u_r, d_ch)
    r_max = sss_ops.burley_sample_r(jnp.full_like(u_r, 0.999), d_ch)
    ok_r = r < r_max
    chord = 2.0 * jnp.sqrt(jnp.maximum(r_max * r_max - r * r, 1e-12))
    phi = 2.0 * geom.PI * u_phi
    base = si.p + r[..., None] * (
        jnp.cos(phi)[..., None] * vx + jnp.sin(phi)[..., None] * vy
    )
    p0 = base + (0.5 * chord)[..., None] * vz
    probe_d = -vz
    # dead lanes carry a zero-length probe (cheap in lockstep traversal)
    t_probe = jnp.where(transmit & ok_r, chord, 1e-5)
    hit_p, t_p, prim_p = _scene_intersect(scene, p0, probe_d, t_probe, time=time)
    t_p = jax.lax.stop_gradient(t_p)
    prim_p = jax.lax.stop_gradient(prim_p)
    same_mat = scene.prims.material_id[prim_p] == mid
    ok = transmit & ok_r & hit_p & same_mat
    si_exit = isect.surface_interaction(
        scene.prims, ok, t_p, prim_p, p0, probe_d, time=time
    )
    # the exit lobe Sw lives on the outward hemisphere: orient the frame by
    # the geometric normal and make wo degenerate-safe (+n)
    si_exit = si_exit._replace(ns=si_exit.n, wo=si_exit.n)

    # Sp(actual r) / pdf_Sp, channel-averaged profile with axis/channel MIS
    r_act = jnp.sqrt(geom.length_sq(si_exit.p - si.p))
    pdf = sss_ops.pdf_sp(si.p, ss_f, ts_f, ns_f, si_exit.p, si_exit.n, d_rgb)
    w_sp = sss_ops.sp(mp.kd, r_act, d_rgb) / jnp.maximum(pdf, 1e-12)[..., None]
    beta = jnp.where(ok[..., None], beta * w_sp, beta)
    alive = alive & ~(transmit & ~ok)
    si = _where_si(ok, si_exit, si)
    return si, mp, beta, alive


def _shading_frame(si: isect.SurfaceInteraction):
    """Orthonormal shading frame (ss, ts, ns) — BSDF constructor
    (reflection.go:120-145), with a branch-free fallback for degenerate
    dpdu."""
    ns = si.ns
    ss = si.dpdu - ns * dot(ns, si.dpdu)[..., None]
    bad = geom.length_sq(ss) < 1e-12
    fb_s, _ = geom.coordinate_system(ns)
    ss = normalize(jnp.where(bad[..., None], fb_s, ss), eps=1e-30)
    ts = jnp.cross(ns, ss)
    return ss, ts, ns


def _to_local(ss, ts, ns, v):
    return jnp.stack([dot(v, ss), dot(v, ts), dot(v, ns)], axis=-1)


def _to_world(ss, ts, ns, v):
    return (
        ss * v[..., 0:1] + ts * v[..., 1:2] + ns * v[..., 2:3]
    )


def _estimate_direct(
    scene: Scene, si, mp, ss, ts, ns, active, seed, pixel, sample, dim_base,
    medium_scatter=None, time=None, fixed_light=None, phase_g=None,
    medium_ids=None, null_passes=0,
):
    """One-light NEE with MIS — UniformSampleOneLight + EstimateDirect
    (integrator.go:48-77, 79-195) over the wavefront.

    fixed_light: int light index for the sample-all-lights strategy
    (UniformSampleAllLights, integrator.go:23-46) — the caller sums this
    over the light table and no pick pmf is applied.

    Returns rgb[N] direct-lighting contribution (already divided by the
    light-pick pmf).  The BSDF-sampling MIS branch for area lights is
    handled in the main loop when a scattered ray hits an emitter
    (hit-is-light MIS weighting), which is the wavefront-friendly split:
    both estimators are still combined with the power heuristic.

    medium_scatter: bool[N] lanes whose vertex is a medium in-scatter
    event — their "BSDF" is the HG phase function (handleMedia branch of
    EstimateDirect, integrator.go:110-117; si.wo points back along the
    ray).  When scene.medium is set, every shadow ray is also attenuated
    by Beer-Lambert transmittance (VisibilityTester.Tr, light.go:50-73).
    """
    n_lights = scene.n_lights
    if n_lights == 0:
        return jnp.zeros(si.p.shape, jnp.float32)

    if fixed_light is None:
        u_pick = rng.sample_1d(seed, pixel, sample, dim_base + D_LIGHT_PICK)
        light_idx, pick_pmf = _light_pick(
            scene, jax.lax.stop_gradient(si.p), u_pick
        )
        light_idx = jax.lax.stop_gradient(light_idx)
        uv_dim = dim_base + D_LIGHT_UV
    else:
        # sample-all-lights strategy (UniformSampleAllLights,
        # integrator.go:23-46): the caller loops the light table; no pick
        # pmf, and each light draws from a disjoint dimension region
        light_idx = jnp.full(si.p.shape[:-1], fixed_light, jnp.int32)
        pick_pmf = jnp.ones(si.p.shape[:-1], jnp.float32)
        uv_dim = rng.DIM_ALL_LIGHT_BASE + dim_base * 64 + 2 * fixed_light

    u_light = rng.sample_2d(seed, pixel, sample, uv_dim)
    ls = light_ops.sample_li(
        scene.lights, light_idx, si.p, u_light, scene.world_radius
    )

    # BSDF f(wo, wi) * |cos(wi, ns)|
    wo_l = _to_local(ss, ts, ns, si.wo)
    wi_l = _to_local(ss, ts, ns, ls.wi)
    f = bsdf_ops.bsdf_f(mp, wo_l, wi_l) * geom.absdot(ls.wi, ns)[..., None]
    b_pdf = bsdf_ops.bsdf_pdf(mp, wo_l, wi_l)
    if medium_scatter is not None:
        from gopbrt_tpu.ops import media as media_ops

        # phase function in place of f·cos; pdf equals the phase value
        # (HG importance-samples itself exactly).  phase_g: per-lane HG
        # asymmetry when the scene uses bounded media
        g_here = phase_g if phase_g is not None else scene.medium.g
        ph = media_ops.hg_phase(dot(si.wo, ls.wi), g_here)
        f = jnp.where(medium_scatter[..., None], ph[..., None], f)
        b_pdf = jnp.where(medium_scatter, ph, b_pdf)

    contributes = (
        active
        & (ls.pdf > 0.0)
        & (jnp.max(ls.li, axis=-1) > 0.0)
        & (jnp.max(f, axis=-1) > 0.0)
    )

    # shadow ray (VisibilityTester.Unoccluded, light.go:46-48): offset both
    # endpoints; t_max slightly short of the light (interaction.go:85,98)
    o_sh = isect.spawn_ray(si, ls.wi)
    if medium_scatter is not None:
        # medium vertices have no surface to offset from
        o_sh = jnp.where(medium_scatter[..., None], si.p, o_sh)
    t_sh = ls.dist * (1.0 - geom.SHADOW_EPSILON) - 1e-3
    # non-contributing lanes get zero-length shadow rays (block-level skip
    # in the cluster intersector; no radiometric effect — their result is
    # masked out below)
    t_sh = jnp.where(contributes, jnp.maximum(t_sh, 1e-4), jnp.float32(1e-4))
    if null_passes > 0:
        # boundary-walking transmittance (Scene.IntersectTr, scene.go:58-77):
        # closest hits instead of any-hit; null boundaries are stepped
        # through (switching the medium and accumulating each segment's Tr);
        # any non-null hit occludes
        occluded, tr_walk = _intersect_tr(
            scene, o_sh, ls.wi, t_sh, medium_ids, contributes, null_passes,
            time=time,
        )
    else:
        occluded = _scene_intersect_p(scene, o_sh, ls.wi, t_sh, time=time)
        tr_walk = None
    vis = contributes & ~occluded

    # delta lights: unweighted; area lights: power heuristic
    # (integrator.go:87-130)
    weight = jnp.where(
        ls.is_delta, 1.0, sampling.power_heuristic(1, ls.pdf, 1, b_pdf)
    )
    contrib = (
        f
        * ls.li
        * (weight / jnp.maximum(ls.pdf, 1e-20) / jnp.maximum(pick_pmf, 1e-20))[
            ..., None
        ]
    )
    if tr_walk is not None:
        contrib = contrib * tr_walk
    elif medium_ids is not None:
        from gopbrt_tpu.ops import media as media_ops

        # bounded media without null boundaries: the shadow segment stays in
        # the vertex's medium (any boundary surface would occlude anyway)
        sig_t, _, _ = media_ops.table_lookup(scene.media, medium_ids)
        contrib = contrib * jnp.exp(-sig_t * jnp.maximum(ls.dist, 0.0)[..., None])
    elif scene.medium is not None:
        from gopbrt_tpu.ops import media as media_ops

        # VisibilityTester.Tr: Beer-Lambert along the unoccluded shadow ray
        contrib = contrib * media_ops.transmittance(scene.medium, ls.dist)
    return jnp.where(vis[..., None], contrib, 0.0)


def _intersect_tr(scene: Scene, o, d, dist, medium0, active, null_passes,
                  time=None):
    """Walk a shadow ray across up to ``null_passes`` null-material
    boundaries, accumulating per-segment Beer-Lambert transmittance in the
    lane's CURRENT medium — Scene.IntersectTr (scene.go:58-77) over the
    wavefront.  Returns (occluded bool[N], Tr f32[N,3])."""
    from gopbrt_tpu.ops import media as media_ops

    n = o.shape[0]
    tr = jnp.ones((n, 3), jnp.float32)
    occl = jnp.zeros((n,), bool)
    o_w = o
    mid_w = medium0 if medium0 is not None else jnp.full((n,), -1, jnp.int32)
    rem = dist
    walk = active
    for _ in range(null_passes + 1):
        t_lim = jnp.where(walk, jnp.maximum(rem, 1e-4), jnp.float32(1e-4))
        hit_k, t_k, prim_k = _scene_intersect(scene, o_w, d, t_lim, time=time)
        hit_k = hit_k & walk
        t_k = jax.lax.stop_gradient(t_k)
        seg = jnp.where(hit_k, t_k, jnp.maximum(rem, 0.0))
        if scene.media is not None:
            sig_t, _, _ = media_ops.table_lookup(scene.media, mid_w)
            tr = jnp.where(
                walk[..., None], tr * jnp.exp(-sig_t * seg[..., None]), tr
            )
        mat_k = scene.prims.material_id[prim_k]
        is_null = hit_k & (scene.materials.mat_type[mat_k] == bsdf_ops.NULLMAT)
        occl = occl | (hit_k & ~is_null)
        # step through the boundary: advance origin, shrink range, switch
        # medium per the interface
        si_b = isect.surface_interaction(
            scene.prims, is_null, t_k, prim_k, o_w, d, time=time
        )
        o_next = geom.offset_ray_origin(si_b.p, si_b.p_err + 1e-4, si_b.n, d)
        o_w = jnp.where(is_null[..., None], o_next, o_w)
        rem = jnp.where(is_null, rem - t_k, rem)
        if scene.prims.medium_inside is not None:
            going_in = dot(d, si_b.n) < 0.0
            iv = jnp.where(
                going_in,
                scene.prims.medium_inside[prim_k],
                scene.prims.medium_outside[prim_k],
            )
            mid_w = jnp.where(is_null & (iv > -2), iv, mid_w)
        walk = is_null & (rem > 1e-4)
    # lanes still walking after the pass budget: treat the remainder as
    # occluded (conservative truncation, mirrors cfg.null_passes)
    occl = occl | walk
    return occl, tr


class PathState(NamedTuple):
    """The wavefront: per-lane path state (SoA), the loop carry.

    pixel/sample ride along so compacted chunks keep their RNG streams."""

    o: jnp.ndarray  # f32[N,3] current ray origin
    d: jnp.ndarray  # f32[N,3] current ray direction
    beta: jnp.ndarray  # f32[N,3] path throughput
    L: jnp.ndarray  # f32[N,3] accumulated radiance
    eta_scale: jnp.ndarray  # f32[N] refraction radiance scaling (path.go:105)
    alive: jnp.ndarray  # bool[N]
    specular: jnp.ndarray  # bool[N] last bounce was specular
    prev_bsdf_pdf: jnp.ndarray  # f32[N] pdf of the ray's BSDF sample (MIS)
    pixel: jnp.ndarray  # uint32[N] pixel counter (RNG stream key)
    sample: jnp.ndarray  # uint32[N] sample counter (RNG stream key)
    time: jnp.ndarray  # f32[N] shutter time (camera.go GetCameraSample's
    #   CameraSample.Time -> Ray.Time; drives animated-transform interp)
    cone_w: jnp.ndarray  # f32[N] ray-cone footprint width at the origin —
    #   the wavefront ComputeDifferentials (interaction.go:225-297): grows
    #   by cone_spread*t per segment; drives texture filtering
    medium: jnp.ndarray = None  # int32[N] current medium id into
    #   Scene.media (-1 vacuum) — the per-ray Medium pointer
    #   (pkg/pbrt/ray.go's Ray.Medium analogue); constant -1 and compiled
    #   out for scenes without bounded media


def _bounce_once(
    scene: Scene, cfg: PathConfig, seed, bounce_idx, st: PathState,
    cone_spread=None,
) -> PathState:
    """One path-tracing bounce over a wavefront (full-width or a compacted
    chunk).  bounce_idx may be traced (compacted while_loop) or static."""
    n = st.o.shape[0]
    pixel, sample = st.pixel, st.sample
    dim_base = DIM_BOUNCE_BASE + bounce_idx * DIMS_PER_BOUNCE

    med = scene.medium
    use_tab = scene.media is not None  # bounded media (MediaTable)
    has_null = (
        scene.materials.info is not None
        and bsdf_ops.NULLMAT in scene.materials.info.mat_types
    )
    has_iface = scene.prims.medium_inside is not None
    any_medium = med is not None or use_tab
    # null-material boundaries don't consume a path bounce (path.go:72-78):
    # the closest hit becomes a short SEGMENT WALK — up to cfg.null_passes
    # consecutive null crossings advance the ray (switching its medium per
    # the interface) before the bounce proper.  Scenes without null
    # materials compile a single segment (today's exact code + RNG streams).
    n_seg = 1 + (cfg.null_passes if has_null else 0)

    o_cur, d_ray = st.o, st.d
    mid_cur = st.medium
    walking = st.alive
    beta_in = st.beta
    f32 = jnp.float32
    hit = jnp.zeros((n,), bool)         # finished on a real surface
    scatter_acc = jnp.zeros((n,), bool)  # finished at a medium vertex
    t = jnp.full((n,), f32(1e30))
    prim_idx = jnp.zeros((n,), jnp.int32)
    o_eff = st.o                         # origin of the finishing segment
    p_med = st.o
    for k in range(n_seg):
        t_lim = jnp.where(walking, f32(1e30), f32(1e-4))
        hit_k, t_k, prim_k = _scene_intersect(
            scene, o_cur, d_ray, t_lim, time=st.time
        )
        hit_k = hit_k & walking
        t_k = jax.lax.stop_gradient(t_k)
        prim_k = jax.lax.stop_gradient(prim_k)

        # per-segment medium sampling (HomogeneousMedium.Sample semantics,
        # single-channel pick + spectral MIS over channels); per-lane
        # coefficients when bounded media are present, vacuum lanes get
        # sigma == 0 and flow through at weight 1
        if any_medium:
            from gopbrt_tpu.ops import media as media_ops

            if use_tab:
                sig_t, sig_s_l, _ = media_ops.table_lookup(scene.media, mid_cur)
            else:
                sig_t = jnp.broadcast_to(med.sigma_t, (n, 3))
                sig_s_l = jnp.broadcast_to(med.sigma_s, (n, 3))
            if k == 0:
                mdim = dim_base + D_MEDIUM
            else:  # later segments draw from a disjoint dimension region
                mdim = rng.DIM_ALL_LIGHT_BASE // 2 + dim_base * 64 + 2 * k
            u_mc = rng.sample_2d(seed, pixel, sample, mdim)
            ch = jnp.minimum((u_mc[..., 0] * 3.0).astype(jnp.int32), 2)
            st_ch = jnp.take_along_axis(sig_t, ch[..., None], axis=-1)[..., 0]
            t_m = -jnp.log(jnp.maximum(1.0 - u_mc[..., 1], 1e-7)) / jnp.maximum(
                st_ch, 1e-20
            )
            t_m = jax.lax.stop_gradient(t_m)
            seg = jnp.where(hit_k, t_k, f32(1e8))
            scat_k = walking & (t_m < seg)
            t_used = jnp.minimum(t_m, seg)
            tr = jnp.exp(-sig_t * t_used[..., None])
            pdf_scat = jnp.mean(sig_t * tr, axis=-1)
            pdf_surf = jnp.mean(tr, axis=-1)
            w_med = jnp.where(
                scat_k[..., None],
                tr * sig_s_l / jnp.maximum(pdf_scat, 1e-20)[..., None],
                tr / jnp.maximum(pdf_surf, 1e-20)[..., None],
            )
            beta_in = jnp.where(walking[..., None], beta_in * w_med, beta_in)
            p_med = jnp.where(
                scat_k[..., None], o_cur + d_ray * t_m[..., None], p_med
            )
        else:
            scat_k = jnp.zeros((n,), bool)

        # null-boundary classification + passthrough
        if has_null:
            mat_k = scene.prims.material_id[prim_k]
            is_null_k = (
                hit_k & ~scat_k
                & (scene.materials.mat_type[mat_k] == bsdf_ops.NULLMAT)
            )
        else:
            is_null_k = jnp.zeros((n,), bool)
        finish_k = walking & ~is_null_k
        hit = jnp.where(finish_k, hit_k & ~scat_k, hit)
        scatter_acc = jnp.where(finish_k, scat_k, scatter_acc)
        t = jnp.where(finish_k, t_k, t)
        prim_idx = jnp.where(finish_k, prim_k, prim_idx)
        o_eff = jnp.where(finish_k[..., None], o_cur, o_eff)

        if has_null and k + 1 < n_seg:
            # advance through the boundary: spawn just past the surface and
            # switch the lane's medium per the interface (medium.go:15-25)
            si_b = isect.surface_interaction(
                scene.prims, is_null_k, t_k, prim_k, o_cur, d_ray,
                time=st.time,
            )
            o_next = geom.offset_ray_origin(
                si_b.p, si_b.p_err + 1e-4, si_b.n, d_ray
            )
            o_cur = jnp.where(is_null_k[..., None], o_next, o_cur)
            if has_iface:
                going_in = geom.dot(d_ray, si_b.n) < 0.0
                iv = jnp.where(
                    going_in,
                    scene.prims.medium_inside[prim_k],
                    scene.prims.medium_outside[prim_k],
                )
                # -2 = "no transition" sentinel: keep the current medium
                mid_cur = jnp.where(is_null_k & (iv > -2), iv, mid_cur)
        walking = walking & is_null_k
        if not has_null:
            break

    scatter = scatter_acc if any_medium else None
    si = isect.surface_interaction(
        scene.prims, hit, t, prim_idx, o_eff, d_ray, time=st.time
    )
    # per-lane phase asymmetry + medium ids for NEE shadow transmittance
    if use_tab:
        from gopbrt_tpu.ops import media as media_ops

        _, _, phase_g = media_ops.table_lookup(scene.media, mid_cur)
    else:
        phase_g = None

    # emitted radiance at hit (path.go:48-63): only when the previous
    # bounce was specular/camera (else NEE already counted it, MIS'd
    # below when cfg.mis)
    le, hit_light = light_ops.le_emitted(
        scene.lights, scene.prims.area_light_id, prim_idx, si.n, si.wo
    )
    is_emitter_hit = hit & (hit_light >= 0)
    if scatter is not None:
        is_emitter_hit = is_emitter_hit & ~scatter
    if cfg.mis and scene.n_lights > 0:
        # MIS weight for BSDF-sampled rays that found an emitter
        # (EstimateDirect's second branch, integrator.go:133-192)
        l_pdf = light_ops.pdf_li(
            scene.lights, jnp.maximum(hit_light, 0), st.o, st.d
        )
        # times the pick pmf of that light under the light distribution
        # as seen from the *previous* vertex (the ray origin)
        pick_pmf = _light_pick_pmf(scene, st.o, jnp.maximum(hit_light, 0))
        w_bsdf = jnp.where(
            st.specular,
            1.0,
            sampling.power_heuristic(1, st.prev_bsdf_pdf, 1, l_pdf * pick_pmf),
        )
    else:
        w_bsdf = jnp.where(st.specular, 1.0, 0.0)
    L = st.L + jnp.where(
        is_emitter_hit[..., None], beta_in * le * w_bsdf[..., None], 0.0
    )

    # escaped rays: no infinite-area lights in the closed set yet ->
    # nothing added (the reference likewise has no infinite light).
    # Medium scatter events keep their lane alive even without a hit.
    alive = st.alive & (hit if scatter is None else (hit | scatter))

    si = _apply_bump(scene, si, scene.prims.material_id[si.prim_idx])
    if cone_spread is not None:
        # ray-cone texture footprint at the hit (curvature-free growth);
        # projected onto the surface the footprint stretches by 1/cos of
        # the incidence angle (ComputeDifferentials' plane projection,
        # interaction.go:241-262) — fold it in, capped at grazing
        fw_hit = st.cone_w + cone_spread * jnp.abs(t)
        fw_surf = fw_hit * jax.lax.rsqrt(
            jnp.maximum(geom.absdot(si.n, si.wo), 0.05)
        )
    else:
        fw_hit = None
        fw_surf = None
    mp = _material_at(scene, si, fw=fw_surf)
    if scatter is not None:
        # splice medium vertices into the wavefront: position at the
        # scatter point, frame facing back along the ray (MediumInteraction,
        # interaction.go:299-307); neutralize the junk material gather so
        # no surface lobe logic (specular flags, eta) fires on them
        back = -st.d
        si_med = si._replace(
            p=p_med,
            p_err=jnp.zeros_like(si.p_err),
            n=back,
            ns=back,
            wo=back,
            dpdu=jnp.zeros_like(si.dpdu),
            dpdv=jnp.zeros_like(si.dpdv),
        )
        si = _where_si(scatter, si_med, si)
        mp = mp._replace(
            mat_type=jnp.where(scatter, bsdf_ops.MATTE, mp.mat_type)
        )
    beta0 = beta_in
    if scene.materials.sss_d is not None:
        # BSSRDF transport (compiled out for scenes without subsurface
        # materials): may splice si to the exit point and scale beta
        si, mp, beta0, alive = _subsurface_transport(
            scene, si, mp, beta0, alive, seed, pixel, sample, dim_base,
            time=st.time,
        )
    ss, ts, ns = _shading_frame(si)

    if cfg.nee:
        L = L + beta0 * _estimate_direct(
            scene, si, mp, ss, ts, ns, alive, seed, pixel, sample, dim_base,
            medium_scatter=scatter, time=st.time, phase_g=phase_g,
            medium_ids=(mid_cur if use_tab else None),
            null_passes=(cfg.null_passes if has_null else 0),
        )

    # BSDF sampling (path.go:91-101)
    u_b = rng.sample_2d(seed, pixel, sample, dim_base + D_BSDF_UV)
    u_lobe = rng.sample_1d(seed, pixel, sample, dim_base + D_BSDF_LOBE)
    wo_l = _to_local(ss, ts, ns, si.wo)
    bs = bsdf_ops.bsdf_sample(mp, wo_l, u_b, u_lobe)
    wi_w = _to_world(ss, ts, ns, bs.wi)
    wi_w = jax.lax.stop_gradient(wi_w)  # detached sampling
    cos_term = geom.absdot(wi_w, ns)
    ok = (bs.pdf > 1e-9) & (jnp.max(jnp.abs(bs.f), axis=-1) > 0.0)
    beta = beta0 * jnp.where(
        ok[..., None],
        bs.f
        * (cos_term / jnp.maximum(jax.lax.stop_gradient(bs.pdf), 1e-20))[..., None],
        0.0,
    )
    next_pdf = bs.pdf
    next_specular = bs.is_specular
    if scatter is not None:
        # medium lanes continue along an HG-sampled direction
        # (PhaseFunction.SampleP, interaction.go:319-331): f == pdf, so the
        # throughput factor is exactly 1
        from gopbrt_tpu.ops import media as media_ops

        u_ph = rng.sample_2d(seed, pixel, sample, dim_base + D_PHASE)
        wi_m, ph_pdf = media_ops.sample_phase(
            si.wo, u_ph, phase_g if use_tab else med.g
        )
        wi_m = jax.lax.stop_gradient(wi_m)
        wi_w = jnp.where(scatter[..., None], wi_m, wi_w)
        ok = ok | scatter
        beta = jnp.where(scatter[..., None], beta0, beta)
        next_pdf = jnp.where(scatter, ph_pdf, next_pdf)
        next_specular = next_specular & ~scatter
    eta_scale = st.eta_scale * bs.eta_scale
    alive = alive & ok & (jnp.max(beta, axis=-1) > 0.0)

    o_new = isect.spawn_ray(si, wi_w)
    if scatter is not None:
        o_new = jnp.where(scatter[..., None], si.p, o_new)

    # medium switch on refractive boundary crossings (MediumInterface on a
    # glass shell: SpecularTransmission carries the ray into the interior
    # medium); scatter vertices and reflections keep their medium
    if has_iface and use_tab:
        crossed = alive & bs.is_transmission
        if scatter is not None:
            crossed = crossed & ~scatter
        going_in = geom.dot(wi_w, si.n) < 0.0
        iv = jnp.where(
            going_in,
            scene.prims.medium_inside[si.prim_idx],
            scene.prims.medium_outside[si.prim_idx],
        )
        mid_cur = jnp.where(crossed & (iv > -2), iv, mid_cur)

    # Russian roulette (path.go:143-153)
    rr_beta_max = jnp.max(beta * eta_scale[..., None], axis=-1)
    q = jnp.maximum(0.05, 1.0 - rr_beta_max)
    u_rr = rng.sample_1d(seed, pixel, sample, dim_base + D_RR)
    do_rr = (bounce_idx >= cfg.rr_start_depth) & (rr_beta_max < cfg.rr_threshold)
    killed = do_rr & (u_rr < q)
    survived_scale = jnp.where(do_rr & ~killed, 1.0 / (1.0 - q), 1.0)
    survived_scale = jax.lax.stop_gradient(survived_scale)
    beta = beta * survived_scale[..., None]
    alive = alive & ~killed

    return PathState(
        o=o_new,
        d=wi_w,
        beta=beta,
        L=L,
        eta_scale=eta_scale,
        alive=alive,
        specular=next_specular,
        prev_bsdf_pdf=jax.lax.stop_gradient(next_pdf),
        pixel=pixel,
        sample=sample,
        time=st.time,
        cone_w=(st.cone_w if cone_spread is None else fw_hit),
        medium=mid_cur,
    )


def _where_state(mask, a: PathState, b: PathState) -> PathState:
    def w(x, y):
        m = mask
        while m.ndim < x.ndim:
            m = m[..., None]
        return jnp.where(m, x, y)

    return PathState(*(w(x, y) for x, y in zip(a, b)))


def _li_compacted(
    scene: Scene, state: PathState, seed, cfg: PathConfig, cone_spread=None
):
    """Compacted bounce loop: alive lanes are argsort-compacted to the
    front each bounce and processed in ceil(alive/C) chunks of static size
    C — dead-lane work drops with the wavefront (RR kills >95% of lanes by
    bounce 4 on typical scenes; full-width masking would still pay for
    them), at the price of a gather and a scatter of the ~100 B/lane
    state per chunk.

    The loop is a while_loop (exits when every lane is dead) over a
    fori_loop with a *traced* trip count — fine forward, not reverse-mode
    differentiable; use cfg.compaction=False for gradients.
    """
    n = state.o.shape[0]
    c = min(cfg.chunk_size, n)

    def gather(st: PathState, idx) -> PathState:
        return PathState(*(x[idx] for x in st))

    def scatter(st: PathState, idx, sub: PathState) -> PathState:
        return PathState(
            *(
                x.at[idx].set(y, unique_indices=True, mode="drop")
                for x, y in zip(st, sub)
            )
        )

    n_pad = -(-n // c) * c

    def bounce_body(carry):
        bounce_idx, st = carry
        # alive-first stable order; pad with out-of-bounds indices so the
        # last chunk's gathers clamp (masked) and scatters drop
        order = jnp.argsort(~st.alive, stable=True).astype(jnp.int32)
        if n_pad > n:
            order = jnp.concatenate(
                [order, jnp.full((n_pad - n,), n, jnp.int32)]
            )
        m = jnp.sum(st.alive.astype(jnp.int32))
        n_chunks = jnp.maximum((m + (c - 1)) // c, 1)

        def chunk_body(i, st):
            idx = jax.lax.dynamic_slice(order, (i * c,), (c,))
            sub = gather(st, idx)
            active = (i * c + jnp.arange(c, dtype=jnp.int32)) < m
            sub_in = sub._replace(alive=sub.alive & active)
            sub_out = _bounce_once(
                scene, cfg, seed, bounce_idx, sub_in, cone_spread
            )
            # inactive slots write back their original values (no-ops)
            sub_out = _where_state(active, sub_out, sub)
            return scatter(st, idx, sub_out)

        st = jax.lax.fori_loop(0, n_chunks, chunk_body, st)
        return bounce_idx + 1, st

    def cond(carry):
        bounce_idx, st = carry
        return (bounce_idx < cfg.max_depth) & jnp.any(st.alive)

    _, state = jax.lax.while_loop(cond, bounce_body, (jnp.int32(0), state))
    return state


def li(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    pixel: jnp.ndarray,
    sample: jnp.ndarray,
    seed,
    cfg: PathConfig = PathConfig(),
    time=None,
    cone=None,
) -> jnp.ndarray:
    """Wavefront Path.Li (path.go:32-157): radiance for rays (o, d)[N].

    pixel/sample: uint32 counters feeding the stateless sampler.
    time: optional f32[N] shutter times (animated scenes).
    Fixes reference quirk #4: directly-visible emitters DO contribute
    (the reference increments `bounces` before its emission check,
    path.go:41-48, losing camera-visible lights).
    cone: optional (width0, spread) ray-cone scalars (camera.pixel_spread)
    enabling filtered texture lookups; None point-samples textures.
    """
    n = o.shape[0]
    f32 = jnp.float32
    state = PathState(
        o=o,
        d=d,
        beta=jnp.ones((n, 3), f32),
        L=jnp.zeros((n, 3), f32),
        eta_scale=jnp.ones((n,), f32),
        alive=jnp.ones((n,), bool),
        specular=jnp.ones((n,), bool),  # camera rays count as "specular prev"
        prev_bsdf_pdf=jnp.zeros((n,), f32),
        pixel=jnp.broadcast_to(pixel.astype(jnp.uint32), (n,)),
        sample=jnp.broadcast_to(sample.astype(jnp.uint32), (n,)),
        time=(jnp.zeros((n,), f32) if time is None
              else jnp.broadcast_to(jnp.asarray(time, f32), (n,))),
        cone_w=jnp.broadcast_to(
            jnp.asarray(0.0 if cone is None else cone[0], f32), (n,)
        ),
        medium=jnp.full(
            (n,),
            scene.camera_medium if scene.media is not None else -1,
            jnp.int32,
        ),
    )
    cone_spread = None if cone is None else cone[1]

    if cfg.compaction:
        state = _li_compacted(scene, state, seed, cfg, cone_spread=cone_spread)
    elif cfg.early_exit:
        # full-width bounces, but stop as soon as every lane is dead
        # (forward-only: dynamic trip count)
        def cond(carry):
            i, st = carry
            return (i < cfg.max_depth) & jnp.any(st.alive)

        def body(carry):
            i, st = carry
            return i + 1, _bounce_once(scene, cfg, seed, i, st, cone_spread)

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    else:
        state = jax.lax.fori_loop(
            0,
            cfg.max_depth,
            lambda i, st: _bounce_once(scene, cfg, seed, i, st, cone_spread),
            state,
        )

    # NaN/Inf sanitization (renderWorker, integrator.go:256-262 — but we
    # replace with zero rather than sentinel gray)
    L = state.L
    bad = ~jnp.all(jnp.isfinite(L), axis=-1)
    return jnp.where(bad[..., None], 0.0, jnp.maximum(L, 0.0))


def li_direct(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    pixel: jnp.ndarray,
    sample: jnp.ndarray,
    seed,
    max_depth: int = 5,
    time=None,
    cone=None,
    light_strategy: str = "one",
) -> jnp.ndarray:
    """Direct-lighting integrator (directlighting.go:62-101): per-vertex NEE
    plus recursion through *specular* surfaces only.

    light_strategy: "one" = UniformSampleOneLight (integrator.go:48-77);
    "all" = UniformSampleAll — every light sampled at every vertex with no
    pick pmf (directlighting.go:10-15,84-95 + integrator.go:23-46).

    EstimateDirect's BSDF-sampling MIS branch (integrator.go:133-192) is
    realized wavefront-style: diffuse vertices scatter ONE more segment
    whose only job is the emitter-hit check with the power-heuristic
    complement, then die — combined, the two branches estimate the same
    integral as the reference's in-vertex two-branch EstimateDirect.
    """
    n = o.shape[0]
    f32 = jnp.float32
    state = PathState(
        o=o, d=d,
        beta=jnp.ones((n, 3), f32), L=jnp.zeros((n, 3), f32),
        eta_scale=jnp.ones((n,), f32), alive=jnp.ones((n,), bool),
        specular=jnp.ones((n,), bool), prev_bsdf_pdf=jnp.zeros((n,), f32),
        pixel=jnp.broadcast_to(pixel.astype(jnp.uint32), (n,)),
        sample=jnp.broadcast_to(sample.astype(jnp.uint32), (n,)),
        time=(jnp.zeros((n,), f32) if time is None
              else jnp.broadcast_to(jnp.asarray(time, f32), (n,))),
        cone_w=jnp.broadcast_to(
            jnp.asarray(0.0 if cone is None else cone[0], f32), (n,)
        ),
        medium=jnp.full((n,), -1, jnp.int32),
    )
    cone_spread = None if cone is None else cone[1]

    def emitted_mis(st, hit, t, prim_idx, si):
        """Emitted radiance at a hit, MIS-weighted: specular-prev lanes get
        weight 1 (path.go:48-63); diffuse-prev lanes are the EstimateDirect
        BSDF branch and get the power-heuristic complement."""
        le, hit_light = light_ops.le_emitted(
            scene.lights, scene.prims.area_light_id, prim_idx, si.n, si.wo
        )
        if scene.n_lights > 0:
            l_pdf = light_ops.pdf_li(
                scene.lights, jnp.maximum(hit_light, 0), st.o, st.d
            )
            if light_strategy == "all":
                pick_pmf = jnp.ones_like(l_pdf)  # every light always sampled
            else:
                pick_pmf = _light_pick_pmf(scene, st.o, jnp.maximum(hit_light, 0))
            w = jnp.where(
                st.specular,
                1.0,
                sampling.power_heuristic(1, st.prev_bsdf_pdf, 1, l_pdf * pick_pmf),
            )
        else:
            w = jnp.where(st.specular, 1.0, 0.0)
        return jnp.where(
            (hit & (hit_light >= 0))[..., None], st.beta * le * w[..., None], 0.0
        )

    def nee(si, mp, ss, ts, ns, active, dim_base, st):
        if light_strategy == "all":
            out = jnp.zeros(si.p.shape, f32)
            for li_ in range(scene.n_lights):
                out = out + _estimate_direct(
                    scene, si, mp, ss, ts, ns, active, seed, pixel, sample,
                    dim_base, time=st.time, fixed_light=li_,
                )
            return out
        return _estimate_direct(
            scene, si, mp, ss, ts, ns, active, seed, pixel, sample, dim_base,
            time=st.time,
        )

    def bounce(bounce_idx, st):
        dim_base = DIM_BOUNCE_BASE + bounce_idx * DIMS_PER_BOUNCE
        t_max = jnp.where(st.alive, f32(1e30), f32(1e-4))
        hit, t, prim_idx = _scene_intersect(scene, st.o, st.d, t_max, time=st.time)
        hit = hit & st.alive
        si = isect.surface_interaction(
            scene.prims, hit, t, prim_idx, st.o, st.d, time=st.time
        )
        if scene.medium is not None:
            # absorption-only medium handling: Beer-Lambert Tr on every
            # camera/specular segment (matching the shadow-ray Tr applied in
            # _estimate_direct), but NO in-scatter vertices — by definition
            # the direct-lighting integrator ignores multiple scattering
            # (ADVICE r2 #2: previously only shadow rays were attenuated)
            from gopbrt_tpu.ops import media as media_ops

            tr_seg = media_ops.transmittance(scene.medium, jnp.where(hit, t, 0.0))
            st = st._replace(beta=st.beta * tr_seg)
        L = st.L + emitted_mis(st, hit, t, prim_idx, si)
        # diffuse-continuation lanes existed only for the emitter check
        alive = st.alive & hit & st.specular
        si = _apply_bump(scene, si, scene.prims.material_id[si.prim_idx])
        if cone_spread is not None:
            fw_hit = st.cone_w + cone_spread * jnp.abs(t)
            fw_surf = fw_hit * jax.lax.rsqrt(
                jnp.maximum(geom.absdot(si.n, si.wo), 0.05)
            )
        else:
            fw_hit = fw_surf = None
        mp = _material_at(scene, si, fw=fw_surf)
        beta0 = st.beta
        if scene.materials.sss_d is not None:
            si, mp, beta0, alive = _subsurface_transport(
                scene, si, mp, beta0, alive, seed, pixel, sample, dim_base,
                time=st.time,
            )
        ss, ts, ns = _shading_frame(si)
        L = L + beta0 * nee(si, mp, ss, ts, ns, alive, dim_base, st)
        # scatter: specular lanes recurse (directlighting.go:97-101);
        # diffuse lanes get ONE MIS segment (see emitted_mis)
        u_b = rng.sample_2d(seed, pixel, sample, dim_base + D_BSDF_UV)
        u_lobe = rng.sample_1d(seed, pixel, sample, dim_base + D_BSDF_LOBE)
        wo_l = _to_local(ss, ts, ns, si.wo)
        bs = bsdf_ops.bsdf_sample(mp, wo_l, u_b, u_lobe)
        wi_w = _to_world(ss, ts, ns, bs.wi)
        cos_term = geom.absdot(wi_w, ns)
        ok = (bs.pdf > 1e-9) & (jnp.max(jnp.abs(bs.f), axis=-1) > 0.0)
        beta = beta0 * jnp.where(
            ok[..., None], bs.f * (cos_term / jnp.maximum(bs.pdf, 1e-20))[..., None], 0.0
        )
        return PathState(
            o=isect.spawn_ray(si, wi_w), d=wi_w, beta=beta, L=L,
            eta_scale=st.eta_scale, alive=alive & ok,
            specular=bs.is_specular, prev_bsdf_pdf=bs.pdf,
            pixel=st.pixel, sample=st.sample, time=st.time,
            cone_w=(st.cone_w if cone_spread is None else fw_hit),
            medium=st.medium,
        )

    state = jax.lax.fori_loop(0, max_depth, bounce, state)
    # final emission-only pass: lanes whose last vertex scattered (diffuse
    # MIS segment, or a specular chain cut by max_depth hitting an emitter)
    t_max = jnp.where(state.alive, f32(1e30), f32(1e-4))
    hit_f, t_f, prim_f = _scene_intersect(
        scene, state.o, state.d, t_max, time=state.time
    )
    hit_f = hit_f & state.alive
    si_f = isect.surface_interaction(
        scene.prims, hit_f, t_f, prim_f, state.o, state.d, time=state.time
    )
    if scene.medium is not None:
        from gopbrt_tpu.ops import media as media_ops

        tr_seg = media_ops.transmittance(
            scene.medium, jnp.where(hit_f, t_f, 0.0)
        )
        state = state._replace(beta=state.beta * tr_seg)
    L = state.L + emitted_mis(state, hit_f, t_f, prim_f, si_f)
    bad = ~jnp.all(jnp.isfinite(L), axis=-1)
    return jnp.where(bad[..., None], 0.0, jnp.maximum(L, 0.0))
