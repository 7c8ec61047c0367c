"""The bounce loop's variants against the default full-width loop.

``PathConfig.early_exit`` (stop once every lane is dead) and
``PathConfig.compaction`` (sort alive lanes to the front, process only the
occupied chunks) change the order of execution, never the per-lane math or
its RNG streams, so their radiance equals the default loop's.  The scenes
cover the shading paths a bounce can take: the demo (matte, checker,
sphere lamp), a Cornell box with a mirror, smooth glass under area lights
and rough glass.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gopbrt_tpu.models import camera as cam_mod
from gopbrt_tpu.models import gallery
from gopbrt_tpu.models import integrators as I
from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.demo import build_demo_camera, build_demo_scene
from gopbrt_tpu.models.scene import SceneBuilder
from gopbrt_tpu.ops import geom

W, H, DEPTH = 24, 16, 6


def _rough_glass():
    """Checker floor, rough-glass sphere, matte ball, sphere lamp."""
    b = SceneBuilder()
    checker = b.checkerboard_texture(
        (0.8, 0.8, 0.8), (0.2, 0.2, 0.2),
        vs=(0.7, 0.0, 0.0), vt=(0.0, 0.0, 0.7), mapping="planar",
    )
    floor = b.matte(kd=(1.0, 1.0, 1.0), kd_tex=checker)
    b.disk(np.asarray(geom.rotate_x(-90.0)), 60.0, floor)
    rough = b.glass(kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5,
                    roughness=0.15)
    b.sphere(np.asarray(geom.translate([0.0, 1.2, 0.0])), 1.2, rough)
    matte = b.matte(kd=(0.7, 0.3, 0.2))
    b.sphere(np.asarray(geom.translate([2.4, 0.8, -1.4])), 0.8, matte)
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    lamp = b.sphere(np.asarray(geom.translate([-2.5, 4.0, 2.0])), 0.5, dark)
    b.area_light(lamp, radiance=(30.0, 28.0, 24.0), two_sided=False)
    cam = cam_mod.perspective_camera(
        geom.look_at([0.0, 2.4, 6.5], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]),
        W, H, fov_deg=45.0,
    )
    return b.build(accelerator="none"), cam


SCENES = {
    "demo": lambda: (build_demo_scene(accelerator="none"),
                     build_demo_camera(W, H)),
    "cornell_mirror": lambda: gallery.config2(W, H)[:2],
    "glass": lambda: gallery.config4(W, H)[:2],
    "rough_glass": _rough_glass,
}

VARIANTS = {
    "early_exit": dict(early_exit=True),
    # a chunk size that does not divide W*H: the last chunk is padded
    "compaction": dict(compaction=True, chunk_size=100),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_variant_equals_default_loop(scene_name, variant):
    scene, cam = SCENES[scene_name]()
    n = W * H
    settings = render_mod.RenderSettings(width=W, height=H, spp=1,
                                         max_depth=DEPTH)
    pix = jnp.arange(n, dtype=jnp.uint32)
    smp = jnp.zeros((n,), jnp.uint32)
    seed = jnp.uint32(5)
    p_film, u_lens = render_mod.camera_samples(settings, pix, smp, seed)
    o, d = cam_mod.generate_rays(cam, p_film, u_lens)

    base = I.PathConfig(max_depth=DEPTH)
    ref = np.asarray(I.li(scene, o, d, pix, smp, seed, base))
    got = np.asarray(I.li(scene, o, d, pix, smp, seed,
                          base._replace(**VARIANTS[variant])))
    assert np.isfinite(got).all()
    assert ref.max() > 0.0  # the paths carry light
    np.testing.assert_allclose(got, ref, atol=1e-5)
