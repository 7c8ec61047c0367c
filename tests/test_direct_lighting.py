"""Direct-lighting integrator: MIS completeness + light strategies.

Covers the round-4 additions (VERDICT r3 task 9 + missing-branch fix):
  * EstimateDirect's BSDF-sampling MIS branch (integrator.go:133-192) is
    now realized for diffuse vertices via a one-segment continuation —
    verified per-lane against a path integrator restricted to direct
    transport;
  * ``light_strategy="all"`` (UniformSampleAll, directlighting.go:10-15 +
    integrator.go:23-46): every light sampled per vertex, no pick pmf —
    agrees with "one" in expectation and reduces variance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gopbrt_tpu.models import camera as cam_mod
from gopbrt_tpu.models import integrators
from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.scene import SceneBuilder
from gopbrt_tpu.ops import geom


def _receiver_scene(n_lights=1):
    """Diffuse floor + dark-matte emitter sphere(s): the only transport is
    direct lighting of the floor, so a depth-2 path == direct lighting."""
    b = SceneBuilder()
    floor = b.matte(kd=(0.6, 0.5, 0.4))
    b.disk(np.asarray(geom.rotate_x(-90.0)), 30.0, floor)
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    for i in range(n_lights):
        x = -2.0 + 4.0 * i / max(n_lights - 1, 1)
        lamp = b.sphere(np.asarray(geom.translate([x, 3.0, 0.0])), 0.5, dark)
        b.area_light(lamp, radiance=(8.0 / n_lights,) * 3, two_sided=False)
    return b.build(accelerator="none")


def _rays(scene, n, seed):
    cam = cam_mod.perspective_camera(
        geom.look_at([0.0, 2.5, 6.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0]),
        64, 36, fov_deg=50.0,
    )
    settings = render_mod.RenderSettings(width=64, height=36, spp=1)
    pixel = jnp.arange(n, dtype=jnp.uint32)
    sample = jnp.zeros((n,), jnp.uint32)
    p_film, u_lens = render_mod.camera_samples(
        settings, pixel, sample, jnp.uint32(seed)
    )
    o, d = cam_mod.generate_rays(cam, p_film, u_lens)
    return o, d, pixel, sample


def test_direct_equals_direct_only_path_per_lane():
    """With no indirect transport in the scene, li_direct == li(path,
    depth 2) per lane: both run the same NEE at the first vertex and the
    same one-segment BSDF-MIS complement on the same RNG streams."""
    scene = _receiver_scene()
    n = 64 * 36
    o, d, pixel, sample = _rays(scene, n, 3)
    seed = jnp.uint32(3)
    cfg = integrators.PathConfig(max_depth=2, rr_threshold=1.0)
    ref = np.asarray(
        integrators.li(scene, o, d, pixel, sample, seed, cfg)
    )
    got = np.asarray(
        integrators.li_direct(scene, o, d, pixel, sample, seed, max_depth=2)
    )
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_all_lights_matches_one_light_in_expectation():
    scene = _receiver_scene(n_lights=3)
    n = 64 * 36
    means = {}
    for strategy in ("one", "all"):
        acc = 0.0
        for s in range(8):
            o, d, pixel, sample = _rays(scene, n, 3)
            L = integrators.li_direct(
                scene, o, d, pixel, jnp.full((n,), s, jnp.uint32),
                jnp.uint32(3), max_depth=1, light_strategy=strategy,
            )
            acc = acc + np.asarray(L).mean()
        means[strategy] = acc / 8
    assert abs(means["all"] - means["one"]) < 0.05 * max(means["one"], 1e-9), (
        f"one={means['one']:.5f} all={means['all']:.5f}"
    )


def test_all_lights_reduces_variance():
    """With 3 lights, sampling all of them per vertex must cut per-sample
    variance vs picking one (the point of UniformSampleAll)."""
    scene = _receiver_scene(n_lights=3)
    n = 64 * 36
    var = {}
    for strategy in ("one", "all"):
        samples = []
        for s in range(6):
            o, d, pixel, sample = _rays(scene, n, 3)
            L = integrators.li_direct(
                scene, o, d, pixel, jnp.full((n,), s, jnp.uint32),
                jnp.uint32(3), max_depth=1, light_strategy=strategy,
            )
            samples.append(np.asarray(L).mean(axis=-1))
        stack = np.stack(samples)  # [S, N]
        var[strategy] = float(np.mean(np.var(stack, axis=0)))
    assert var["all"] < 0.6 * var["one"], (
        f"var one={var['one']:.6f} all={var['all']:.6f}"
    )
