"""Texture footprint / checker anti-aliasing (ComputeDifferentials role).

The reference declares the checkerboard's ClosedForm AA method but never
implements it (checkerboard.go:8-13,38-39), and its ComputeDifferentials
(interaction.go:225-297) feeds nothing.  Here a ray-cone footprint
(camera.pixel_spread -> PathState.cone_w) drives the closed-form box
filter in ops/texture.eval_spectrum.  Oracle: a low-spp filtered render of
a grazing checker must be closer to the heavily supersampled point-sampled
truth than the low-spp point-sampled render is.
"""

import numpy as np

from gopbrt_tpu.models import camera as cam_mod
from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.scene import SceneBuilder
from gopbrt_tpu.ops import geom

W, H = 64, 36


def checker_scene():
    b = SceneBuilder()
    checker = b.checkerboard_texture(
        (0.9, 0.9, 0.9), (0.1, 0.1, 0.1),
        vs=(2.0, 0.0, 0.0), vt=(0.0, 0.0, 2.0), mapping="planar",
    )
    floor = b.matte(kd=(1.0, 1.0, 1.0), kd_tex=checker)
    b.disk(np.asarray(geom.rotate_x(-90.0)), 500.0, floor)
    b.distant_light(direction=(0.2, 1.0, 0.1), radiance=(2.0, 2.0, 2.0))
    return b.build(accelerator="none")


CAM = cam_mod.perspective_camera(
    geom.look_at([0.0, 1.0, 8.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    W, H, fov_deg=50.0,
)


def _render(scene, spp, aa):
    settings = render_mod.RenderSettings(
        width=W, height=H, spp=spp, max_depth=1, integrator="path",
        samples_per_pass=min(spp, 16), texture_aa=aa,
    )
    return np.asarray(render_mod.render(scene, CAM, settings))


def test_filtered_beats_supersampled_pointwise():
    scene = checker_scene()
    truth = _render(scene, spp=256, aa=False)  # supersampled ground truth
    aa_low = _render(scene, spp=4, aa=True)
    ps_low = _render(scene, spp=4, aa=False)
    # evaluate on the distant (grazing) third of the floor where the
    # checker frequency exceeds the pixel grid
    band = slice(H // 2, 2 * H // 3)
    e_aa = np.abs(aa_low[band] - truth[band]).mean()
    e_ps = np.abs(ps_low[band] - truth[band]).mean()
    assert e_aa < 0.7 * e_ps, (e_aa, e_ps)
    assert e_aa < 0.04


def test_near_field_unchanged_by_aa():
    """Close-up checks are far larger than a pixel footprint: filtering must
    not visibly alter them (filter width << check size)."""
    scene = checker_scene()
    a = _render(scene, spp=64, aa=True)
    b = _render(scene, spp=64, aa=False)
    near = slice(5 * H // 6, H)  # closest rows
    assert np.abs(a[near] - b[near]).mean() < 0.015
