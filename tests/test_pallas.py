"""The Triton intersection kernel (ops/pallas_intersect.py) against the jnp
brute-force oracle, and the choice between them.

The kernel bodies run in the Pallas interpreter here; the same comparison
runs compiled on the GPU in chip_smoke.py.  Which version a call runs is
decided when it is lowered, so the CUDA lowering is checked here too.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gopbrt_tpu.ops import intersect, pallas_intersect
from tests.test_bvh import random_sphere_scene, random_rays
from tests.test_intersect import make_prims, sphere_entry


def compare(prims, o, d, t_max):
    bh, bt, bi = map(np.asarray, intersect.intersect_brute(prims, o, d, t_max))
    ph, pt, pi = map(
        np.asarray,
        pallas_intersect.intersect_brute_pallas(prims, o, d, t_max, interpret=True),
    )
    np.testing.assert_array_equal(bh, ph)
    both = bh & ph
    np.testing.assert_allclose(bt[both], pt[both], rtol=2e-3)
    clear = np.abs(bt[both] - pt[both]) <= 1e-6 * np.maximum(bt[both], 1.0)
    np.testing.assert_array_equal(bi[both][clear], pi[both][clear])


class TestPallasOracle:
    def test_random_spheres(self):
        prims = random_sphere_scene(30, seed=4)
        o, d = random_rays(512, seed=40)
        compare(prims, o, d, jnp.full((512,), 1e30))

    def test_partial_shapes_wedges(self):
        prims = make_prims(
            [
                (intersect.SPHERE, np.asarray(np.eye(4), np.float32),
                 [1.0, 0.0, 1.0, 2 * math.pi], 0),
                (intersect.SPHERE, np.asarray(np.eye(4) + 0, np.float32),
                 [1.0, -1.0, 1.0, math.pi / 2], 0),
                (intersect.DISK, np.eye(4, dtype=np.float32),
                 [0.0, 2.0, 0.5, 1.5 * math.pi], 0),
            ]
        )
        o, d = random_rays(2048, seed=9, spread=5.0)
        compare(prims, o, d, jnp.full((2048,), 1e30))

    def test_triangles_and_mixed(self):
        prims = make_prims(
            [
                sphere_entry([0.0, 0.0, -2.0], 0.5),
                (intersect.DISK, np.eye(4, dtype=np.float32),
                 [-5.0, 10.0, 0.0, 2 * math.pi], 1),
                (intersect.TRIANGLE, np.eye(4, dtype=np.float32),
                 [-1, -1, -8, 1, -1, -8, 0, 1, -8], 2),
            ]
        )
        o, d = random_rays(1024, seed=11, spread=8.0)
        compare(prims, o, d, jnp.full((1024,), 1e30))

    def test_tmax_and_padding(self):
        # a ray count that is not a multiple of BLOCK: the last program's
        # loads and stores are masked
        prims = random_sphere_scene(10, seed=5)
        o, d = random_rays(777, seed=13)
        compare(prims, o, d, jnp.full((777,), 30.0))

    def test_any_hit(self):
        prims = random_sphere_scene(20, seed=6)
        o, d = random_rays(512, seed=14)
        t_max = jnp.full((512,), 1e30)
        bp = np.asarray(intersect.intersect_p_brute(prims, o, d, t_max))
        pp = np.asarray(
            pallas_intersect.intersect_p_brute_pallas(
                prims, o, d, t_max, interpret=True
            )
        )
        np.testing.assert_array_equal(bp, pp)

    def test_any_hit_early_exit_loop(self):
        """Masked (dead) shadow lanes with tiny t_max must read unoccluded
        and must not stall the loop's exit condition."""
        prims = random_sphere_scene(48, seed=7)
        o, d = random_rays(640, seed=15)
        t_max = np.full((640,), 1e30, np.float32)
        dead = np.arange(640) % 3 == 0
        t_max[dead] = 1e-4  # the integrators' masked-lane marker
        t_max = jnp.asarray(t_max)
        bp = np.asarray(intersect.intersect_p_brute(prims, o, d, t_max))
        pp = np.asarray(
            pallas_intersect.intersect_p_brute_pallas(
                prims, o, d, t_max, interpret=True
            )
        )
        assert not pp[dead].any()
        np.testing.assert_array_equal(bp[~dead], pp[~dead])

    def test_any_hit_respects_tmax(self):
        """A hit beyond t_max must not occlude (shadow semantics)."""
        prims = random_sphere_scene(40, seed=8)
        o, d = random_rays(512, seed=16)
        t_inf = jnp.full((512,), 1e30)
        bh, bt, _ = intersect.intersect_brute(prims, o, d, t_inf)
        bh, bt = np.asarray(bh), np.asarray(bt)
        t_half = jnp.asarray(np.where(bh, bt * 0.5, 1e30).astype(np.float32))
        pp = np.asarray(
            pallas_intersect.intersect_p_brute_pallas(
                prims, o, d, t_half, interpret=True
            )
        )
        # rays whose only hits lie beyond t_max: cannot be occluded unless a
        # second, nearer surface exists inside the shortened range
        oracle = np.asarray(intersect.intersect_p_brute(prims, o, d, t_half))
        np.testing.assert_array_equal(oracle, pp)


# ---------------------------------------------------------------------------
# kernel vs oracle over the shapes and lane states the integrators produce
# ---------------------------------------------------------------------------


def _aimed_rays(n, seed, targets, spread=6.0):
    """Rays from a shell around the origin aimed near ``targets`` (so most
    of them hit something)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = spread * o / np.linalg.norm(o, axis=-1, keepdims=True)
    aim = np.asarray(targets, np.float64)[rng.integers(0, len(targets), n)]
    aim = aim + rng.normal(scale=0.4, size=(n, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _partial():
    prims = make_prims([
        sphere_entry([0.0, 0.0, 0.0], 1.0, z_min=-0.5, z_max=0.7,
                     phi_max=1.25 * math.pi),
        sphere_entry([2.5, 0.0, 0.0], 0.8, phi_max=0.6 * math.pi),
        (intersect.DISK, np.asarray(np.eye(4), np.float32),
         [-1.5, 2.0, 0.6, 0.75 * math.pi], 0),
        (intersect.DISK, np.asarray(np.eye(4), np.float32),
         [1.5, 1.0, 0.0, 2 * math.pi], 0),
    ])
    return prims, [(0, 0, 0), (2.5, 0, 0), (0, 0, -1.5), (0, 0, 1.5)]


def _triangles():
    prims = make_prims([
        (intersect.TRIANGLE, np.eye(4, dtype=np.float32),
         [-1, -1, 0, 1, -1, 0, 0, 1, 0], 0),
        (intersect.TRIANGLE, np.eye(4, dtype=np.float32),
         [-1, -1, -1, 1, -1, -1, 0, 1, -1.5], 0),
        (intersect.TRIANGLE, np.eye(4, dtype=np.float32),
         [0, -2, 1, 2, 0, 1, 0, 2, 1], 0),
    ])
    return prims, [(0, 0, 0), (0, 0, -1.2), (0.5, 0, 1)]


def _many():
    """P above UNROLL_MAX: the looped (not unrolled) kernel body."""
    n = pallas_intersect.UNROLL_MAX + 9
    rng = np.random.default_rng(3)
    centers = rng.uniform(-3, 3, (n, 3))
    prims = make_prims([sphere_entry(c, rng.uniform(0.2, 0.6)) for c in centers])
    return prims, [tuple(c) for c in centers]


def _ties():
    """Identical spheres: every hit is an equal-t tie, won by the lowest
    index as argmin does."""
    prims = make_prims([sphere_entry([0.3, 0.0, 0.0], 1.0)] * 3
                       + [sphere_entry([0.0, 0.0, 4.0], 0.5)])
    return prims, [(0.3, 0, 0), (0, 0, 4)]


CASES = {"partial": _partial, "triangles": _triangles, "many": _many,
         "ties": _ties, "dead_lanes": _partial}


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(case, kind):
    prims, targets = CASES[case]()
    n = 1000  # not a multiple of BLOCK
    o, d = _aimed_rays(n, seed=len(case), targets=targets)
    t_max = np.full((n,), 1e30, np.float32)
    if case == "dead_lanes":
        t_max[::3] = 1e-4  # the integrators' masked-lane marker
    t_max = jnp.asarray(t_max)
    if kind == "closest":
        bh, bt, bi = map(np.asarray, intersect.intersect_brute(prims, o, d, t_max))
        kh, kt, ki = map(np.asarray, pallas_intersect.intersect_brute_pallas(
            prims, o, d, t_max, interpret=True))
        assert bh.mean() > 0.2  # the rays do hit
        np.testing.assert_array_equal(kh, bh)
        np.testing.assert_allclose(kt, bt, rtol=1e-5)
        np.testing.assert_array_equal(ki[bh], bi[bh])
        if case == "ties":
            assert set(np.unique(ki[bh])) <= {0, 3}
        if case == "dead_lanes":
            assert not kh[::3].any()
    else:
        bp = np.asarray(intersect.intersect_p_brute(prims, o, d, t_max))
        kp = np.asarray(pallas_intersect.intersect_p_brute_pallas(
            prims, o, d, t_max, interpret=True))
        assert bp.mean() > 0.2
        np.testing.assert_array_equal(kp, bp)


# ---------------------------------------------------------------------------
# which version runs: decided when the call is lowered
# ---------------------------------------------------------------------------


def _lowered(fn, platform, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("fn", ["closest_hit", "any_hit"])
def test_platform_picks_kernel(fn):
    prims = random_sphere_scene(40, seed=1)
    o, d = random_rays(300, seed=2)
    args = (prims, o, d, jnp.full((300,), 1e30))
    f = getattr(pallas_intersect, fn)
    assert "triton" in _lowered(f, "cuda", *args)
    assert "triton" not in _lowered(f, "cpu", *args)
    # off CUDA the call is the plain version, bit for bit
    plain = (intersect.intersect_brute if fn == "closest_hit"
             else intersect.intersect_p_brute)
    for a, b in zip(jax.tree.leaves(f(*args)), jax.tree.leaves(plain(*args))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_grad_through_a_pass_that_calls_the_kernel():
    """Reverse mode through a render pass on the kernel path: the search is
    detached, so the gradient lowers for CUDA (no kernel JVP is needed) and
    is finite and nonzero on the CPU."""
    from gopbrt_tpu.models import film as film_mod
    from gopbrt_tpu.models import render as render_mod
    from gopbrt_tpu.models.demo import build_demo_camera, build_demo_scene

    scene = build_demo_scene(accelerator="none")
    w, h = 16, 9
    cam = build_demo_camera(w, h)
    settings = render_mod.RenderSettings(width=w, height=h, spp=1, max_depth=2)

    def loss(intensity):
        sc = scene._replace(lights=scene.lights._replace(intensity=intensity))
        film = render_mod.render_pass(
            sc, cam, film_mod.new_film(w, h), settings, jnp.uint32(0))
        return jnp.sum(film.rgb)

    grad = jax.grad(loss)
    assert "triton" in _lowered(grad, "cuda", scene.lights.intensity)
    g = np.asarray(grad(scene.lights.intensity))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
