"""Light sampling over SoA light tables.

Replaces the reference's Light interface tree — Point (``pkg/lights/point.go``),
Distant (``pkg/lights/distant.go``), DiffuseArea (``pkg/lights/diffuse.go``) +
the shape sampling routines they delegate to (``pkg/pbrt/sphere.go:270-363``,
``pkg/pbrt/shape.go:29-64``) — with tagged SoA tables and batch kernels:

  sample_li   counterpart of Light.SampleLi (light.go:18-29)
  pdf_li      counterpart of Light.PdfLi — solid-angle pdf for MIS
  le_emitted  counterpart of AreaLighter.L (diffuse.go:36-41)
  power       counterpart of Light.Power, drives the power light distribution

Delta lights (point, distant) report is_delta so the integrator skips MIS
weighting, mirroring LightFlag delta handling (light.go:5-16,
integrator.go:87-130).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from gopbrt_tpu.ops import geom
from gopbrt_tpu.ops.geom import PI, dot, normalize, length, length_sq
from gopbrt_tpu.ops.sampling import (
    concentric_sample_disk,
    uniform_sample_sphere,
    uniform_cone_pdf,
)
from gopbrt_tpu.ops import intersect as isect_ops

LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_AREA = 2

# area-light shape kinds (mirror intersect tags)
SHAPE_SPHERE = 0
SHAPE_DISK = 1


class Lights(NamedTuple):
    """SoA light table.

    p: point position / distant *incoming* direction w_light (normalized,
       pointing from the scene toward the light, distant.go:40-44).
    o2w/params/shape_kind: area-light geometry (copied from the backing
       primitive so sampling needs no indirection).
    prim_idx: backing primitive of an area light (-1 for delta lights);
       the inverse mapping prims.area_light_id gives hit-emitter lookup.
    """

    light_type: jnp.ndarray  # int32[L]
    p: jnp.ndarray  # f32[L,3]
    intensity: jnp.ndarray  # f32[L,3]  I (point), L (distant/area)
    two_sided: jnp.ndarray  # bool[L]
    prim_idx: jnp.ndarray  # int32[L]
    shape_kind: jnp.ndarray  # int32[L]
    o2w: jnp.ndarray  # f32[L,4,4]
    w2o: jnp.ndarray  # f32[L,4,4] precomputed inverse (never invert
    #   per-lane at render time: a batched linalg.inv over the wavefront
    #   costs more than the whole shading pass)
    params: jnp.ndarray  # f32[L,9]

    @property
    def count(self) -> int:
        return self.light_type.shape[0]


class LiSample(NamedTuple):
    wi: jnp.ndarray  # f32[N,3] toward the light
    li: jnp.ndarray  # f32[N,3] incident radiance (zero if unsampleable)
    pdf: jnp.ndarray  # f32[N]  solid-angle pdf (1 for delta lights)
    dist: jnp.ndarray  # f32[N]  shadow-ray length (to sampled point)
    p_light: jnp.ndarray  # f32[N,3] sampled point (invalid for distant)
    is_delta: jnp.ndarray  # bool[N]


def _area_sphere_geom(o2w, params):
    """World center / radius of a sphere area light (uniform-scale xform)."""
    center = o2w[..., :3, 3]
    scale = length(o2w[..., :3, 0])
    return center, params[..., 0] * scale


def _sample_sphere_li(o2w, params, ref_p, u2):
    """Solid-angle sphere sampling (sphere.go:287-344 SampleAtInteraction).

    Outside: uniform cone toward the sphere; inside: uniform over the
    surface with area->solid-angle pdf conversion.
    """
    center, radius = _area_sphere_geom(o2w, params)
    to_c = center - ref_p
    dc2 = length_sq(to_c)
    dc = jnp.sqrt(dc2)
    outside = dc > radius * 1.00001

    # --- outside branch: cone sampling
    inv_dc = 1.0 / jnp.maximum(dc, 1e-12)
    wc = to_c * inv_dc[..., None]
    wcx, wcy = geom.coordinate_system(wc)
    sin2_tmax = jnp.clip(radius * radius / jnp.maximum(dc2, 1e-20), 0.0, 1.0)
    cos_tmax = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_tmax))
    cos_t = (1.0 - u2[..., 0]) + u2[..., 0] * cos_tmax
    sin2_t = jnp.maximum(0.0, 1.0 - cos_t * cos_t)
    ds = dc * cos_t - jnp.sqrt(
        jnp.maximum(0.0, radius * radius - dc2 * sin2_t)
    )
    cos_a = (dc2 + radius * radius - ds * ds) / jnp.maximum(
        2.0 * dc * radius, 1e-12
    )
    sin_a = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_a * cos_a))
    phi = 2.0 * PI * u2[..., 1]
    n_obj = geom.spherical_direction_xyz(sin_a, cos_a, phi, -wcx, -wcy, -wc)
    p_out = center + radius[..., None] * n_obj
    wi_out = normalize(p_out - ref_p, eps=1e-20)
    pdf_out = uniform_cone_pdf(jnp.minimum(cos_tmax, 1.0 - 1e-7))
    n_out = n_obj

    # --- inside branch: uniform area sampling + conversion
    dir_s = uniform_sample_sphere(u2)
    p_in = center + radius[..., None] * dir_s
    wi_v = p_in - ref_p
    d2 = length_sq(wi_v)
    wi_in = normalize(wi_v, eps=1e-20)
    n_in = dir_s
    area = 4.0 * PI * radius * radius
    cos_l = jnp.abs(dot(n_in, -wi_in))
    pdf_in = d2 / jnp.maximum(cos_l * area, 1e-12)

    wi = jnp.where(outside[..., None], wi_out, wi_in)
    p_l = jnp.where(outside[..., None], p_out, p_in)
    n_l = jnp.where(outside[..., None], n_out, n_in)
    pdf = jnp.where(outside, pdf_out, pdf_in)
    dist = length(p_l - ref_p)
    return wi, p_l, n_l, pdf, dist


def _sample_disk_li(o2w, w2o, params, ref_p, u2):
    """Area-sample a disk emitter (disk.go:160-170 Sample) + solid-angle
    conversion (shape.go:49-64 SampleAtInteraction semantics)."""
    height, radius = params[..., 0], params[..., 1]
    pd = concentric_sample_disk(u2) * radius[..., None]
    p_obj = jnp.stack([pd[..., 0], pd[..., 1], height], axis=-1)
    p_l = geom.apply_point_affine(o2w, p_obj)
    # normal: +z transformed (ignoring reverse orientation at light level)
    n_l = normalize(
        geom.apply_normal(w2o, jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1.0], jnp.float32), p_obj.shape)),
        eps=1e-20,
    )
    wi_v = p_l - ref_p
    d2 = length_sq(wi_v)
    wi = normalize(wi_v, eps=1e-20)
    scale = length(o2w[..., :3, 0])
    inner = params[..., 2]
    phi_max = params[..., 3]
    area = phi_max * 0.5 * (radius * radius - inner * inner) * scale * scale
    cos_l = jnp.abs(dot(n_l, -wi))
    pdf = d2 / jnp.maximum(cos_l * area, 1e-12)
    pdf = jnp.where(cos_l < 1e-7, 0.0, pdf)
    return wi, p_l, n_l, pdf, jnp.sqrt(d2)


def sample_li(
    lights: Lights, idx, ref_p, u2, world_radius
) -> LiSample:
    """Sample incident radiance from light ``idx`` (per-lane) at ref_p.

    Counterpart of Light.SampleLi for Point (point.go:44-49), Distant
    (distant.go:40-44), DiffuseArea (diffuse.go:47-59).
    """
    from gopbrt_tpu.ops.intersect import gather_rows

    lt = lights.light_type[idx]
    lp = gather_rows(lights.p, idx)
    intensity = gather_rows(lights.intensity, idx)
    two_sided = lights.two_sided[idx]
    o2w = gather_rows(lights.o2w, idx)
    w2o = gather_rows(lights.w2o, idx)
    params = gather_rows(lights.params, idx)
    shape_kind = lights.shape_kind[idx]

    # point light: Li = I / d^2
    to_l = lp - ref_p
    d2 = length_sq(to_l)
    wi_pt = normalize(to_l, eps=1e-20)
    li_pt = intensity / jnp.maximum(d2, 1e-12)[..., None]
    dist_pt = jnp.sqrt(d2)

    # distant light: Li = L, from "outside the world"
    wi_di = jnp.broadcast_to(lp, ref_p.shape)
    li_di = jnp.broadcast_to(intensity, ref_p.shape)
    dist_di = jnp.broadcast_to(2.0 * world_radius, d2.shape)

    # area light
    wi_s, pl_s, nl_s, pdf_s, dist_s = _sample_sphere_li(o2w, params, ref_p, u2)
    wi_d, pl_d, nl_d, pdf_d, dist_d = _sample_disk_li(o2w, w2o, params, ref_p, u2)
    is_disk = (shape_kind == SHAPE_DISK)
    wi_ar = jnp.where(is_disk[..., None], wi_d, wi_s)
    pl_ar = jnp.where(is_disk[..., None], pl_d, pl_s)
    nl_ar = jnp.where(is_disk[..., None], nl_d, nl_s)
    pdf_ar = jnp.where(is_disk, pdf_d, pdf_s)
    dist_ar = jnp.where(is_disk, dist_d, dist_s)
    # one/two-sided emission (diffuse.go:36-41)
    facing = dot(nl_ar, -wi_ar) > 0.0
    li_ar = jnp.where(
        (two_sided | facing)[..., None], intensity, 0.0
    )
    li_ar = jnp.where((pdf_ar > 0.0)[..., None], li_ar, 0.0)

    is_pt = lt == LIGHT_POINT
    is_di = lt == LIGHT_DISTANT
    wi = jnp.where(
        is_pt[..., None], wi_pt, jnp.where(is_di[..., None], wi_di, wi_ar)
    )
    li = jnp.where(
        is_pt[..., None], li_pt, jnp.where(is_di[..., None], li_di, li_ar)
    )
    pdf = jnp.where(is_pt | is_di, 1.0, pdf_ar)
    dist = jnp.where(is_pt, dist_pt, jnp.where(is_di, dist_di, dist_ar))
    p_light = jnp.where(
        is_pt[..., None], lp, jnp.where(is_di[..., None], ref_p + wi_di * dist_di[..., None], pl_ar)
    )
    return LiSample(
        wi=wi, li=li, pdf=pdf, dist=dist, p_light=p_light, is_delta=is_pt | is_di
    )


def pdf_li(lights: Lights, idx, ref_p, wi) -> jnp.ndarray:
    """Solid-angle pdf that sample_li(idx) would generate wi from ref_p —
    the MIS weight denominator for the BSDF-sampling branch
    (EstimateDirect, integrator.go:133-192; sphere PdfWi sphere.go:346-363).

    Delta lights return 0 (they can never be hit by a BSDF ray).
    """
    from gopbrt_tpu.ops.intersect import gather_rows

    lt = lights.light_type[idx]
    o2w = gather_rows(lights.o2w, idx)
    w2o = gather_rows(lights.w2o, idx)
    params = gather_rows(lights.params, idx)
    shape_kind = lights.shape_kind[idx]

    center, radius = _area_sphere_geom(o2w, params)
    to_c = center - ref_p
    dc2 = length_sq(to_c)
    outside = dc2 > radius * radius * 1.00002
    sin2_tmax = jnp.clip(radius * radius / jnp.maximum(dc2, 1e-20), 0.0, 1.0)
    cos_tmax = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_tmax))
    # within the cone?
    cos_w = dot(normalize(to_c, eps=1e-20), wi)
    in_cone = cos_w >= cos_tmax - 1e-6
    pdf_sphere = jnp.where(
        outside & in_cone, uniform_cone_pdf(jnp.minimum(cos_tmax, 1.0 - 1e-7)), 0.0
    )
    # inside the sphere: uniform-area sampling converted to solid angle
    # along wi (Shape.PdfWi, shape.go:29-47).  A ray from inside always
    # hits; solve |oc + t wi|^2 = r^2 for the forward root analytically.
    oc = ref_p - center
    b_half = dot(oc, wi)
    disc_in = jnp.maximum(radius * radius - (length_sq(oc) - b_half * b_half), 0.0)
    t_hit = -b_half + jnp.sqrt(disc_in)
    n_hit = normalize(oc + wi * t_hit[..., None], eps=1e-20)
    cos_hit = jnp.abs(dot(n_hit, wi))
    area_sph = 4.0 * PI * radius * radius
    pdf_inside = (t_hit * t_hit) / jnp.maximum(cos_hit * area_sph, 1e-12)
    pdf_sphere = jnp.where(outside, pdf_sphere, pdf_inside)

    # disk emitter: intersect the disk plane along wi, convert area pdf
    oo = geom.apply_point_affine(w2o, ref_p)
    od = geom.apply_vector(w2o, wi)
    height, radius_d, inner, phi_max = (
        params[..., 0],
        params[..., 1],
        params[..., 2],
        params[..., 3],
    )
    dz = od[..., 2]
    t_plane = (height - oo[..., 2]) / jnp.where(jnp.abs(dz) < 1e-12, 1e-12, dz)
    p_obj = oo + od * t_plane[..., None]
    r2 = p_obj[..., 0] ** 2 + p_obj[..., 1] ** 2
    on_disk = (
        (t_plane > 1e-4) & (r2 <= radius_d * radius_d) & (r2 >= inner * inner)
    )
    scale = length(o2w[..., :3, 0])
    area = phi_max * 0.5 * (radius_d * radius_d - inner * inner) * scale * scale
    p_w = geom.apply_point_affine(o2w, p_obj)
    n_w = normalize(
        geom.apply_normal(w2o, jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1.0], jnp.float32), p_obj.shape)),
        eps=1e-20,
    )
    d2_w = length_sq(p_w - ref_p)
    cos_l = jnp.abs(dot(n_w, -wi))
    pdf_disk = jnp.where(
        on_disk & (cos_l > 1e-7), d2_w / jnp.maximum(cos_l * area, 1e-12), 0.0
    )

    pdf_area = jnp.where(shape_kind == SHAPE_DISK, pdf_disk, pdf_sphere)
    return jnp.where(lt == LIGHT_AREA, pdf_area, 0.0)


def le_emitted(lights: Lights, prims_area_light_id, prim_idx, n, wo):
    """Emitted radiance when a BSDF ray hits an emissive primitive
    (AreaLight L, diffuse.go:36-41).  Returns rgb[N]; zero for non-emitters.
    """
    lid = prims_area_light_id[prim_idx]
    is_emitter = lid >= 0
    safe = jnp.maximum(lid, 0)
    L = lights.intensity[safe]
    two_sided = lights.two_sided[safe]
    facing = dot(n, wo) > 0.0
    out = jnp.where((two_sided | facing)[..., None], L, 0.0)
    return jnp.where(is_emitter[..., None], out, 0.0), lid


class LeSample(NamedTuple):
    """An emitted ray sampled from a light (Light.SampleLe)."""

    o: jnp.ndarray  # f32[N,3] ray origin on/at the light
    d: jnp.ndarray  # f32[N,3] emission direction
    n_light: jnp.ndarray  # f32[N,3] light normal at origin (d for deltas)
    le: jnp.ndarray  # f32[N,3] emitted radiance / intensity
    pdf_pos: jnp.ndarray  # f32[N] area pdf of the origin
    pdf_dir: jnp.ndarray  # f32[N] solid-angle pdf of the direction


def sample_le(
    lights: Lights, idx, u1, u2, world_center, world_radius
) -> LeSample:
    """Sample an emitted ray from light ``idx`` — Light.SampleLe for Point
    (uniform sphere, point.go:63-66), Distant (disk outside the world,
    distant.go:58-68), DiffuseArea (shape sample + cosine hemisphere,
    diffuse.go:65-92).  Feeds light tracing / photon-style algorithms and
    the adjoint tests; u1 picks the position, u2 the direction.
    """
    from gopbrt_tpu.ops.intersect import gather_rows

    lt = lights.light_type[idx]
    lp = gather_rows(lights.p, idx)
    intensity = gather_rows(lights.intensity, idx)
    two_sided = lights.two_sided[idx]
    o2w = gather_rows(lights.o2w, idx)
    w2o = gather_rows(lights.w2o, idx)
    params = gather_rows(lights.params, idx)
    shape_kind = lights.shape_kind[idx]

    # --- point: origin at p, uniform-sphere direction
    d_pt = uniform_sample_sphere(u2)
    o_pt = jnp.broadcast_to(lp, d_pt.shape)
    pdf_pos_pt = jnp.ones(d_pt.shape[:-1], jnp.float32)
    pdf_dir_pt = jnp.full(d_pt.shape[:-1], 1.0 / (4.0 * PI), jnp.float32)

    # --- distant: concentric disk on the world-bounding sphere, shooting
    # along -w_light (lp points *toward* the light)
    w = normalize(lp, eps=1e-20)
    v1, v2 = geom.coordinate_system(w)
    cd = concentric_sample_disk(u1)
    p_disk = (
        world_center
        + world_radius * (cd[..., 0:1] * v1 + cd[..., 1:2] * v2)
    )
    o_di = p_disk + world_radius * w
    d_di = -w
    pdf_pos_di = 1.0 / (PI * world_radius * world_radius)
    pdf_pos_di = jnp.broadcast_to(pdf_pos_di, pdf_pos_pt.shape)
    pdf_dir_di = jnp.ones_like(pdf_pos_pt)

    # --- area: shape point (uniform by area) + cosine hemisphere about n
    # sphere surface point
    center, radius = _area_sphere_geom(o2w, params)
    n_sph = uniform_sample_sphere(u1)
    p_sph = center + radius[..., None] * n_sph
    area_sph = 4.0 * PI * radius * radius
    # disk surface point
    height, radius_d = params[..., 0], params[..., 1]
    inner, phi_max = params[..., 2], params[..., 3]
    pd = concentric_sample_disk(u1) * radius_d[..., None]
    p_obj = jnp.stack([pd[..., 0], pd[..., 1], height], axis=-1)
    p_dsk = geom.apply_point_affine(o2w, p_obj)
    n_dsk = normalize(
        geom.apply_normal(
            w2o,
            jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), p_obj.shape),
        ),
        eps=1e-20,
    )
    scale = length(o2w[..., :3, 0])
    area_dsk = phi_max * 0.5 * (radius_d * radius_d - inner * inner) * scale * scale

    is_disk = shape_kind == SHAPE_DISK
    p_ar = jnp.where(is_disk[..., None], p_dsk, p_sph)
    n_ar = jnp.where(is_disk[..., None], n_dsk, n_sph)
    area = jnp.where(is_disk, area_dsk, area_sph)
    # cosine hemisphere about n (diffuse.go:72-88); two-sided flips by u2.x
    u2x = u2[..., 0]
    flip = two_sided & (u2x > 0.5)
    u2_remap = jnp.stack(
        [
            jnp.where(two_sided, jnp.minimum(
                jnp.where(flip, 2.0 * (u2x - 0.5), 2.0 * u2x), 0.99999994
            ), u2x),
            u2[..., 1],
        ],
        axis=-1,
    )
    from gopbrt_tpu.ops.sampling import cosine_sample_hemisphere

    w_local = cosine_sample_hemisphere(u2_remap)
    n_eff = jnp.where(flip[..., None], -n_ar, n_ar)
    t1, t2 = geom.coordinate_system(n_eff)
    d_ar = (
        t1 * w_local[..., 0:1] + t2 * w_local[..., 1:2] + n_eff * w_local[..., 2:3]
    )
    pdf_pos_ar = 1.0 / jnp.maximum(area, 1e-20)
    cos_d = jnp.abs(w_local[..., 2])
    pdf_dir_ar = cos_d / PI * jnp.where(two_sided, 0.5, 1.0)

    is_pt = lt == LIGHT_POINT
    is_di = lt == LIGHT_DISTANT
    o = jnp.where(is_pt[..., None], o_pt, jnp.where(is_di[..., None], o_di, p_ar))
    d = jnp.where(is_pt[..., None], d_pt, jnp.where(is_di[..., None], d_di, d_ar))
    n_l = jnp.where(is_pt[..., None] | is_di[..., None], d, n_eff)
    pdf_pos = jnp.where(
        is_pt, pdf_pos_pt, jnp.where(is_di, pdf_pos_di, pdf_pos_ar)
    )
    pdf_dir = jnp.where(
        is_pt, pdf_dir_pt, jnp.where(is_di, pdf_dir_di, pdf_dir_ar)
    )
    le = jnp.broadcast_to(intensity, o.shape)
    # offset area-light origins off the surface along the emission side
    o = jnp.where((is_pt | is_di)[..., None], o, o + n_eff * 1e-4)
    return LeSample(o=o, d=d, n_light=n_l, le=le, pdf_pos=pdf_pos, pdf_dir=pdf_dir)


def power(lights: Lights, world_radius) -> jnp.ndarray:
    """Scalar power per light for the power distribution
    (lightdistribution.go:46-68, with its append bug fixed; point.go:51-53).
    """
    lt = lights.light_type
    inten = jnp.mean(lights.intensity, axis=-1)  # luminance stand-in
    center, radius = _area_sphere_geom(lights.o2w, lights.params)
    scale = length(lights.o2w[..., :3, 0])
    r_d = lights.params[..., 1] * scale
    inner = lights.params[..., 2] * scale
    area_sphere = 4.0 * PI * radius * radius
    area_disk = lights.params[..., 3] * 0.5 * (r_d * r_d - inner * inner)
    area = jnp.where(lights.shape_kind == SHAPE_DISK, area_disk, area_sphere)
    sided = jnp.where(lights.two_sided, 2.0, 1.0)
    p_point = 4.0 * PI * inten
    p_distant = PI * world_radius * world_radius * inten
    p_area = inten * area * PI * sided
    return jnp.where(
        lt == LIGHT_POINT,
        p_point,
        jnp.where(lt == LIGHT_DISTANT, p_distant, p_area),
    )
