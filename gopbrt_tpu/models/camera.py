"""Cameras: batched primary-ray generation.

Replaces the reference's ProjectiveCamera / PerspectiveCamera classes
(``pkg/pbrt/camera.go:106-242``) with a parameter pytree + a vectorised
ray-generation function.  The raster->screen->camera->world transform chain
is precomputed host-side exactly as NewProjectiveCamera does
(camera.go:106-124); per-ray work is two affine transforms.

Also provides the orthographic camera (the reference declares the
projection matrix, transform.go:501-502, but never built the camera class).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from gopbrt_tpu.ops import geom
from gopbrt_tpu.ops.geom import normalize
from gopbrt_tpu.ops.sampling import concentric_sample_disk

CAM_PERSPECTIVE = 0
CAM_ORTHOGRAPHIC = 1


class Camera(NamedTuple):
    kind: jnp.ndarray  # int32[] CAM_*
    raster_to_camera: jnp.ndarray  # f32[4,4]
    camera_to_world: jnp.ndarray  # f32[4,4]
    lens_radius: jnp.ndarray  # f32[]
    focal_distance: jnp.ndarray  # f32[]
    shutter_open: jnp.ndarray  # f32[]
    shutter_close: jnp.ndarray  # f32[]


def _screen_to_raster(width, height, screen_window):
    (x0, y0), (x1, y1) = screen_window
    m = geom.scale(float(width), float(height), 1.0)
    m = geom.matmul(m, geom.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0))
    m = geom.matmul(m, geom.translate([-x0, -y1, 0.0]))
    return m


def perspective_camera(
    camera_to_world,
    width: int,
    height: int,
    fov_deg: float = 90.0,
    screen_window=None,
    lens_radius: float = 0.0,
    focal_distance: float = 1e6,
    shutter_open: float = 0.0,
    shutter_close: float = 1.0,
) -> Camera:
    """NewPerspectiveCamera (camera.go:135-166).

    screen_window defaults to the aspect-corrected [-1,1] window (PBRT
    proper).  The reference demo passes [0,1]^2 (server.go:138,159) — pass
    it explicitly for golden parity.
    """
    if screen_window is None:
        aspect = width / height
        if aspect > 1:
            screen_window = ((-aspect, -1.0), (aspect, 1.0))
        else:
            screen_window = ((-1.0, -1.0 / aspect), (1.0, 1.0 / aspect))
    cam_to_screen = geom.perspective(fov_deg, 1e-2, 1000.0)
    s2r = _screen_to_raster(width, height, screen_window)
    r2s = geom.inverse(s2r)
    r2c = geom.matmul(geom.inverse(cam_to_screen), r2s)
    return Camera(
        kind=jnp.asarray(CAM_PERSPECTIVE, jnp.int32),
        raster_to_camera=jnp.asarray(r2c, jnp.float32),
        camera_to_world=jnp.asarray(camera_to_world, jnp.float32),
        lens_radius=jnp.asarray(lens_radius, jnp.float32),
        focal_distance=jnp.asarray(focal_distance, jnp.float32),
        shutter_open=jnp.asarray(shutter_open, jnp.float32),
        shutter_close=jnp.asarray(shutter_close, jnp.float32),
    )


def orthographic_camera(
    camera_to_world, width: int, height: int, screen_window=None,
    lens_radius: float = 0.0, focal_distance: float = 1e6,
) -> Camera:
    if screen_window is None:
        aspect = width / height
        screen_window = ((-aspect, -1.0), (aspect, 1.0)) if aspect > 1 else (
            (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect))
    cam_to_screen = geom.orthographic(0.0, 1.0)
    s2r = _screen_to_raster(width, height, screen_window)
    r2c = geom.matmul(geom.inverse(cam_to_screen), geom.inverse(s2r))
    return Camera(
        kind=jnp.asarray(CAM_ORTHOGRAPHIC, jnp.int32),
        raster_to_camera=jnp.asarray(r2c, jnp.float32),
        camera_to_world=jnp.asarray(camera_to_world, jnp.float32),
        lens_radius=jnp.asarray(lens_radius, jnp.float32),
        focal_distance=jnp.asarray(focal_distance, jnp.float32),
        shutter_open=jnp.asarray(0.0, jnp.float32),
        shutter_close=jnp.asarray(1.0, jnp.float32),
    )


def generate_rays(cam: Camera, p_film: jnp.ndarray, u_lens: jnp.ndarray):
    """Batched GenerateRay (camera.go:167-190): p_film[N,2] raster coords,
    u_lens[N,2] lens samples.  Returns world-space (o[N,3], d[N,3]).

    Ray differentials (GenerateRayDifferential, camera.go:192-242) are not
    materialised: texture filtering works from pixel-footprint estimates
    instead (wavefront renderers don't carry per-ray differentials).
    """
    n = p_film.shape[0]
    p_raster = jnp.concatenate([p_film, jnp.zeros((n, 1), jnp.float32)], axis=-1)
    p_cam = geom.apply_point(cam.raster_to_camera, p_raster)

    is_persp = cam.kind == CAM_PERSPECTIVE
    o_persp = jnp.zeros((n, 3), jnp.float32)
    d_persp = normalize(p_cam)
    o_ortho = p_cam
    d_ortho = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n, 3))
    o = jnp.where(is_persp, o_persp, o_ortho)
    d = jnp.where(is_persp, d_persp, d_ortho)

    # thin-lens depth of field (camera.go:173-186)
    def with_lens(o, d):
        p_lens = concentric_sample_disk(u_lens) * cam.lens_radius
        ft = cam.focal_distance / jnp.maximum(d[:, 2], 1e-8)
        p_focus = o + d * ft[:, None]
        o2 = jnp.concatenate([p_lens, jnp.zeros((n, 1), jnp.float32)], axis=-1)
        return o2, normalize(p_focus - o2)

    o_l, d_l = with_lens(o, d)
    use_lens = cam.lens_radius > 0.0
    o = jnp.where(use_lens, o_l, o)
    d = jnp.where(use_lens, d_l, d)

    o_w = geom.apply_point_affine(cam.camera_to_world, o)
    d_w = geom.apply_vector(cam.camera_to_world, d)
    return o_w, normalize(d_w)


def pixel_spread(cam: Camera):
    """Ray-cone parameters of one pixel: (width0, spread) such that the
    world-space footprint of a camera ray at hit distance t is
    ``width0 + spread * t``.

    This is the wavefront replacement for per-ray differentials
    (GenerateRayDifferential + ComputeDifferentials,
    ``pkg/pbrt/camera.go:192-242`` / ``pkg/pbrt/interaction.go:225-297``):
    instead of carrying dpdx/dpdy point pairs per lane, carry one cone
    width that grows linearly along the ray — exact for the isotropic
    footprint of a pinhole pixel, and cheap enough to ride the path state.
    """
    r2c = cam.raster_to_camera
    p0 = geom.apply_point(r2c, jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32))[0]
    p1 = geom.apply_point(r2c, jnp.asarray([[1.0, 1.0, 0.0]], jnp.float32))[0]
    dx = (p1 - p0) * jnp.asarray([1.0, 1.0, 0.0], jnp.float32)
    pix = jnp.sqrt(jnp.maximum(geom.length_sq(dx), 1e-30)) * (1.0 / jnp.sqrt(2.0))
    is_persp = cam.kind == CAM_PERSPECTIVE
    # perspective: angular size of a pixel on the image plane;
    # orthographic: constant footprint, no growth
    ang = pix / jnp.sqrt(jnp.maximum(geom.length_sq(p0), 1e-30))
    width0 = jnp.where(is_persp, 0.0, pix)
    spread = jnp.where(is_persp, ang, 0.0)
    return width0, spread


def look_at_camera(eye, target, up, **kw) -> Camera:
    """Convenience: LookAt + perspective (server.go:152-159 pattern)."""
    return perspective_camera(geom.look_at(eye, target, up), **kw)


# ---------------------------------------------------------------------------
# Light-tracing adjoints: We / PdfWe / SampleWi (camera.go:244-324).
# These treat the camera as a sensor with importance We, enabling particle
# tracing / BDPT-style algorithms.  Perspective only (the reference likewise
# implements them on PerspectiveCamera).
# ---------------------------------------------------------------------------


PI = math.pi


def _camera_frame(cam: Camera):
    c2w = cam.camera_to_world
    pos = c2w[:3, 3]
    forward = normalize(c2w[:3, 2][None, :])[0]  # camera +z in world
    return pos, forward


def _film_area(cam: Camera, width: int, height: int):
    """Area of the film's image rectangle at z=1 (camera.go:244-262:
    pMin/pMax = RasterToCamera of the raster corners, divided by z)."""
    r2c = cam.raster_to_camera
    p_min = geom.apply_point(r2c, jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32))[0]
    p_max = geom.apply_point(
        r2c, jnp.asarray([[float(width), float(height), 0.0]], jnp.float32)
    )[0]
    p_min = p_min / p_min[2]
    p_max = p_max / p_max[2]
    return jnp.abs((p_max[0] - p_min[0]) * (p_max[1] - p_min[1]))


def we(cam: Camera, width: int, height: int, o, d):
    """Importance carried by camera ray (o, d)[N] (PerspectiveCamera.We):
    1 / (A * lensArea * cos^4 theta) when the ray originates on the lens and
    points at the film rectangle; 0 otherwise.  Returns (we[N], raster[N,2]).
    """
    pos, forward = _camera_frame(cam)
    cos_t = geom.dot(d, jnp.broadcast_to(forward, d.shape))
    # project to the focus (or z=1) plane, map back to raster
    w2c = geom.inverse(cam.camera_to_world)
    focus = jnp.where(cam.lens_radius > 0.0, cam.focal_distance, 1.0)
    safe_cos = jnp.where(cos_t <= 0.0, 1.0, cos_t)
    p_focus_w = o + d * (focus / safe_cos)[..., None]
    p_focus_c = geom.apply_point_affine(w2c, p_focus_w)
    # camera_to_raster is projective; apply_point performs the w-divide
    c2r = geom.inverse(cam.raster_to_camera)
    p_rast = geom.apply_point(c2r, p_focus_c)
    in_x = (p_rast[..., 0] >= 0.0) & (p_rast[..., 0] < width)
    in_y = (p_rast[..., 1] >= 0.0) & (p_rast[..., 1] < height)
    valid = (cos_t > 0.0) & in_x & in_y
    lens_area = jnp.where(
        cam.lens_radius > 0.0, PI * cam.lens_radius ** 2, 1.0
    )
    a = _film_area(cam, width, height)
    cos2 = safe_cos * safe_cos
    w_val = 1.0 / (a * lens_area * cos2 * cos2)
    return jnp.where(valid, w_val, 0.0), p_rast[..., :2]


def pdf_we(cam: Camera, width: int, height: int, o, d):
    """(pdf_pos, pdf_dir) of the camera sampling ray (o,d) —
    PerspectiveCamera.PdfWe: pdf_pos = 1/lensArea, pdf_dir = 1/(A cos^3)."""
    w_val, _ = we(cam, width, height, o, d)
    _, forward = _camera_frame(cam)
    cos_t = geom.dot(d, jnp.broadcast_to(forward, d.shape))
    valid = w_val > 0.0
    lens_area = jnp.where(cam.lens_radius > 0.0, PI * cam.lens_radius ** 2, 1.0)
    a = _film_area(cam, width, height)
    safe_cos = jnp.where(valid, cos_t, 1.0)
    pdf_pos = jnp.where(valid, 1.0 / lens_area, 0.0)
    pdf_dir = jnp.where(valid, 1.0 / (a * safe_cos ** 3), 0.0)
    return pdf_pos, pdf_dir


def sample_wi(cam: Camera, width: int, height: int, ref_p, u_lens):
    """Sample a direction from ref_p[N,3] to the camera lens
    (PerspectiveCamera.SampleWi): returns (wi[N,3], we[N,3->scalar], pdf[N],
    p_lens_world[N,3], raster[N,2])."""
    p_lens = concentric_sample_disk(u_lens) * cam.lens_radius
    p_lens_c = jnp.concatenate(
        [p_lens, jnp.zeros(p_lens.shape[:-1] + (1,), jnp.float32)], axis=-1
    )
    p_lens_w = geom.apply_point_affine(
        cam.camera_to_world, p_lens_c
    )
    to_cam = p_lens_w - ref_p
    dist = jnp.sqrt(jnp.maximum(geom.length_sq(to_cam), 1e-20))
    wi = to_cam / dist[..., None]
    _, forward = _camera_frame(cam)
    # lens normal is the camera forward axis
    cos_l = geom.dot(-wi, jnp.broadcast_to(forward, wi.shape))
    lens_area = jnp.where(cam.lens_radius > 0.0, PI * cam.lens_radius ** 2, 1.0)
    pdf = (dist * dist) / jnp.maximum(cos_l * lens_area, 1e-20)
    w_val, p_rast = we(cam, width, height, p_lens_w, -wi)
    pdf = jnp.where(cos_l > 1e-7, pdf, 0.0)
    return wi, w_val, pdf, p_lens_w, p_rast
