"""Bounded media + null-material boundaries (VERDICT r3 task 6).

The working MediumInterface system: per-primitive (inside, outside) medium
ids (medium.go:15-25), null-material passthrough that doesn't consume a
path bounce (path.go:72-78), and boundary-walking shadow transmittance
(Scene.IntersectTr, scene.go:58-77).  Every test pins the physics to an
analytic/quadrature expectation or to an exactly-equivalent unbounded
configuration.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from gopbrt_tpu.models import integrators
from gopbrt_tpu.models.scene import SceneBuilder


def _trace(scene, n=30000, depth=1, o=(0.0, 0.0, 5.0), d=(0.0, 0.0, -1.0),
           seed=7):
    o = jnp.broadcast_to(jnp.asarray(o, jnp.float32), (n, 3))
    d = jnp.broadcast_to(jnp.asarray(d, jnp.float32), (n, 3))
    pix = jnp.arange(n, dtype=jnp.uint32)
    L = integrators.li(
        scene, o, d, pix, jnp.uint32(0), jnp.uint32(seed),
        integrators.PathConfig(max_depth=depth),
    )
    return np.asarray(L)


class TestCameraMediumEquivalence:
    def test_unbounded_table_medium_equals_global_medium_per_lane(self):
        """A media-table fog with the camera inside and no boundaries must
        reproduce the global set_medium fog EXACTLY (same RNG streams)."""
        def build(bounded):
            b = SceneBuilder()
            m = b.matte(kd=(1.0, 1.0, 1.0))
            b.disk(np.eye(4), radius=50.0, material=m)
            b.point_light((0.0, 0.0, 3.0), (9 * math.pi,) * 3)
            if bounded:
                mid = b.add_medium((0.1,) * 3, (0.05,) * 3, g=0.3)
                b.set_camera_medium(mid)
            else:
                b.set_medium((0.1,) * 3, (0.05,) * 3, g=0.3)
            return b.build(accelerator="none")

        La = _trace(build(False), n=4096, depth=3)
        Lb = _trace(build(True), n=4096, depth=3)
        np.testing.assert_allclose(La, Lb, rtol=1e-5, atol=1e-6)


class TestNullBoundary:
    def test_null_sphere_without_medium_is_invisible(self):
        """A null-material sphere with no medium interface must not change
        the image at all: primary rays pass through (path.go:72-78) and
        shadow rays walk through (IntersectTr)."""
        def build(with_null):
            b = SceneBuilder()
            m = b.matte(kd=(0.7, 0.6, 0.5))
            b.disk(np.eye(4), radius=50.0, material=m)
            b.point_light((0.5, 1.0, 3.0), (20.0,) * 3)
            if with_null:
                nm = b.null_material()
                sph = np.eye(4)
                sph[2, 3] = 2.0  # between camera (z=5) and disk (z=0)
                b.sphere(sph, 1.0, nm)
            return b.build(accelerator="none")

        La = _trace(build(False), n=4096, depth=2)
        Lb = _trace(build(True), n=4096, depth=2)
        np.testing.assert_allclose(La, Lb, rtol=1e-5, atol=1e-6)

    def test_fog_ball_single_scatter_matches_quadrature(self):
        """A null sphere bounding isotropic fog, lit by a point light: the
        single-scattered radiance along a ray through the ball must match
        the line-integral quadrature with the fog confined to the chord —
        exercises passthrough, per-lane medium switching, AND the
        boundary-walking shadow transmittance."""
        sigma_a, sigma_s = 0.1, 0.3
        st = sigma_a + sigma_s
        R = 1.0
        light_p = np.array([0.0, 3.0, 0.0])
        intensity = 40.0

        b = SceneBuilder()
        fog = b.add_medium((sigma_a,) * 3, (sigma_s,) * 3, g=0.0)
        nm = b.null_material()
        ball = b.sphere(np.eye(4), R, nm)
        b.set_medium_interface(ball, inside=fog, outside=-1)
        b.point_light(tuple(light_p), (intensity,) * 3)
        scene = b.build(accelerator="none")

        got = _trace(scene, n=200000, depth=1,
                     o=(0.0, 0.0, 5.0), d=(0.0, 0.0, -1.0)).mean(axis=0)

        # quadrature: scatter points on the chord z in [-R, R] (ray hits the
        # ball at z=+R from z=+5); attenuation only inside the ball
        z = np.linspace(R, -R, 20000)
        s_in = R - z  # distance travelled inside the fog
        p = np.stack([np.zeros_like(z), np.zeros_like(z), z], axis=-1)
        to_l = light_p - p
        r = np.linalg.norm(to_l, axis=-1)
        w = to_l / r[:, None]
        # fog path length of the shadow ray: exit of |p + t w| = R
        b_half = np.sum(p * w, axis=-1)
        c = np.sum(p * p, axis=-1) - R * R
        t_exit = -b_half + np.sqrt(np.maximum(b_half * b_half - c, 0.0))
        integrand = (
            np.exp(-st * s_in) * sigma_s * (1.0 / (4 * math.pi))
            * intensity * np.exp(-st * t_exit) / r**2
        )
        expected = np.trapezoid(integrand, s_in)
        np.testing.assert_allclose(got, expected, rtol=0.06)


class TestRefractiveInterface:
    def test_glass_shell_interior_absorption(self):
        """An eta=1 'glass' sphere (always transmits straight through) with
        an absorbing interior medium: brightness of the surface behind drops
        by exp(-sigma_t*(chord + shadow path)) — the specular-transmission
        medium switch."""
        def build(sig):
            b = SceneBuilder()
            m = b.matte(kd=(1.0, 1.0, 1.0))
            b.disk(np.eye(4), radius=50.0, material=m)
            # light on the camera side so the shadow ray doesn't cross the
            # ball: only the camera chord is attenuated
            b.point_light((4.0, 0.5, 4.0), (16 * math.pi,) * 3)
            if sig is not None:
                glass = b.glass(eta=1.0 + 1e-6)
                interior = b.add_medium((sig,) * 3)
                ball = b.sphere(
                    np.asarray([[1, 0, 0, 0], [0, 1, 0, 0],
                                [0, 0, 1, 2.0], [0, 0, 0, 1]], np.float32),
                    1.0, glass,
                )
                b.set_medium_interface(ball, inside=interior, outside=-1)
            return b.build(accelerator="none")

        sigma = 0.4
        clear = _trace(build(None), n=20000, depth=4,
                       o=(0.0, 0.0, 5.0)).mean(axis=0)
        absorbed = _trace(build(sigma), n=60000, depth=4,
                          o=(0.0, 0.0, 5.0)).mean(axis=0)
        # camera ray passes the 2-unit chord of the ball (centered z=2,
        # camera at z=5 aiming -z): attenuation exp(-sigma*2R)
        expected = math.exp(-sigma * 2.0)
        np.testing.assert_allclose(absorbed / clear, expected, rtol=0.08)
