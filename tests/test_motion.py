"""Animated transforms + shutter time, end-to-end.

The reference's AnimatedTransform nil-derefs on any real animation (its
decompose is a TODO, transform.go:537-539 — quirk #9); this build implements
it.  Oracle: a motion-blurred render must equal the time-average of static
renders across the shutter (the defining property of motion blur), since
the shutter time is uniform in [0,1].
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gopbrt_tpu.models import camera as cam_mod
from gopbrt_tpu.models import integrators as I
from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.scene import SceneBuilder
from gopbrt_tpu.ops import geom

W, H = 48, 32
SETTINGS = render_mod.RenderSettings(
    width=W, height=H, spp=32, max_depth=1, integrator="path",
    samples_per_pass=8,
)
CAM = cam_mod.perspective_camera(
    geom.look_at([0.0, 0.0, 6.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    W, H, fov_deg=30.0,
)
X0, X1, R = -1.0, 1.0, 0.5


def _sphere_scene(x=None, animated=False):
    b = SceneBuilder()
    mat = b.matte(kd=(0.8, 0.8, 0.8))
    pid = b.sphere(np.asarray(geom.translate([X0 if animated else x, 0.0, 0.0])), R, mat)
    if animated:
        b.animate(pid, np.asarray(geom.translate([X1, 0.0, 0.0])))
    # frontal distant light -> brightness tracks coverage
    b.distant_light(direction=(0.0, 0.0, 1.0), radiance=(3.0, 3.0, 3.0))
    return b.build(accelerator="none")


def test_static_prims_have_no_anim_table():
    assert _sphere_scene(x=0.0).prims.anim is None
    sc = _sphere_scene(animated=True)
    assert sc.prims.anim is not None
    assert bool(sc.prims.anim.animated[0])
    # the time-interpolating intersector: the kernel path is static-only
    assert sc.bvh is None and sc.prims.count <= I.BRUTE_FORCE_CUTOFF


def _srgb_decode(v):
    v = np.asarray(v, np.float64)
    return np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


def test_motion_blur_equals_time_average_of_static_renders():
    # compare in LINEAR radiance: averaging must happen before the sRGB
    # encode (radiance is what the shutter integrates)
    img_anim = _srgb_decode(
        render_mod.render(_sphere_scene(animated=True), CAM, SETTINGS)
    )
    ks = 16
    acc = np.zeros((H, W, 3), np.float64)
    for k in range(ks):
        x = X0 + (X1 - X0) * (k + 0.5) / ks
        acc += _srgb_decode(render_mod.render(_sphere_scene(x=x), CAM, SETTINGS))
    img_avg = acc / ks
    # column profiles: blur plateau + extent must match the shutter
    # average; tolerance covers MC noise + 16-position quadrature
    col_anim = img_anim.mean(axis=(0, 2))
    col_avg = img_avg.mean(axis=(0, 2))
    np.testing.assert_allclose(col_anim, col_avg, atol=0.012)
    # analytic blur extent: lit columns span ~(X1-X0+2R)/(2R) times the
    # static width (threshold relative to the plateau; the travel-end tails
    # fade with vanishing shutter coverage)
    static_mid = _srgb_decode(render_mod.render(_sphere_scene(x=0.0), CAM, SETTINGS))
    col_static = static_mid.mean(axis=(0, 2))
    w_static = (col_static > 0.05 * col_static.max()).sum()
    w_anim = (col_anim > 0.05 * col_anim.max()).sum()
    expected_ratio = (X1 - X0 + 2 * R) / (2 * R)
    assert w_anim > 0 and w_static > 0
    np.testing.assert_allclose(w_anim / w_static, expected_ratio, rtol=0.25)


def test_animated_bvh_bounds_cover_shutter():
    """A >4-prim animated scene builds a BVH whose bounds cover the whole
    motion (union over sampled shutter times) — the moving sphere must be
    hit at t=1 even though its t=0 box is elsewhere."""
    b = SceneBuilder()
    mat = b.matte(kd=(0.8, 0.8, 0.8))
    pid = b.sphere(np.asarray(geom.translate([X0, 0.0, 0.0])), R, mat)
    b.animate(pid, np.asarray(geom.translate([X1, 0.0, 0.0])))
    for i in range(5):  # filler prims so the BVH actually builds
        b.sphere(np.asarray(geom.translate([0.0, -20.0 - 4 * i, 0.0])), 1.0, mat)
    b.distant_light(direction=(0.0, 0.0, 1.0), radiance=(3.0, 3.0, 3.0))
    scene = b.build(accelerator="bvh")
    assert scene.bvh is not None

    from gopbrt_tpu.ops import bvh as bvh_mod

    # rays aimed at the END position, at ray time 1.0
    o = jnp.asarray([[X1, 0.0, 5.0], [X0, 0.0, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 2, jnp.float32)
    t_max = jnp.full((2,), 1e30, jnp.float32)
    hit, t, idx = bvh_mod.bvh_intersect(
        scene.bvh, scene.prims, o, d, t_max, time=jnp.asarray([1.0, 1.0])
    )
    assert bool(hit[0]) and int(idx[0]) == pid  # sphere found at end pose
    assert not bool(hit[1])  # nothing at the start pose at t=1
