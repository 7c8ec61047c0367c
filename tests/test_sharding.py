"""Multi-device SPMD tests on the 8-virtual-CPU mesh.

The key contract: sharded rendering equals single-device rendering (the
counter-based sampler makes streams independent of the mesh shape), and
the distributed gradient step runs with real data/sample shardings.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from gopbrt_tpu.models import camera as cam_mod
from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.scene import SceneBuilder
from gopbrt_tpu.ops import geom
from gopbrt_tpu.parallel import shard as shard_mod


def tiny_scene():
    b = SceneBuilder()
    mat = b.matte(kd=(0.7, 0.4, 0.2))
    b.sphere(np.asarray(geom.translate([0.0, 1.0, 0.0])), 1.0, mat)
    floor = b.matte(kd=(0.5, 0.5, 0.5))
    b.disk(np.asarray(geom.rotate_x(-90.0)), 50.0, floor)
    b.point_light(p=(3.0, 8.0, 3.0), intensity=(80.0, 80.0, 80.0))
    return b.build(accelerator="none")


CAM = cam_mod.perspective_camera(
    geom.look_at([0.0, 2.0, 6.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]),
    16, 16, fov_deg=45.0,
)
SETTINGS = render_mod.RenderSettings(
    width=16, height=16, spp=2, max_depth=2, samples_per_pass=1,
    compaction=False,  # shared by the gradient tests: static bounce loop
)


@pytest.fixture(scope="module")
def scene():
    return tiny_scene()


class TestShardedRender:
    @pytest.mark.parametrize("band_film", [True, False])
    def test_matches_single_device(self, scene, band_film):
        assert len(jax.devices()) >= 8
        single = np.asarray(render_mod.render(scene, CAM, SETTINGS))
        mesh = shard_mod.make_mesh(data=4, sample=2)
        multi = np.asarray(
            shard_mod.render_sharded(mesh, scene, CAM, SETTINGS, band_film=band_film)
        )
        # counter-based sampling -> identical streams; psum order may differ.
        # band_film additionally exercises the halo ppermute: filter taps
        # crossing band boundaries must land exactly as in the single-device
        # full-film splat.
        np.testing.assert_allclose(single, multi, atol=2e-5)

    def test_data_only_mesh(self, scene):
        mesh = shard_mod.make_mesh(data=8, sample=1)
        img = np.asarray(shard_mod.render_sharded(mesh, scene, CAM, SETTINGS))
        assert np.isfinite(img).all() and img.max() > 0.1

    @pytest.mark.parametrize("band_film", [True, False])
    def test_nondivisible_pixel_count(self, scene, band_film):
        # 15x15 = 225 px not divisible by 8 -> padding rows/lanes dropped
        cam = cam_mod.perspective_camera(
            geom.look_at([0.0, 2.0, 6.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]),
            15, 15, fov_deg=45.0,
        )
        settings = SETTINGS._replace(width=15, height=15)
        mesh = shard_mod.make_mesh(data=8, sample=1)
        multi = np.asarray(
            shard_mod.render_sharded(mesh, scene, cam, settings, band_film=band_film)
        )
        single = np.asarray(render_mod.render(scene, cam, settings))
        np.testing.assert_allclose(single, multi, atol=2e-5)

    def test_band_film_is_actually_sharded(self, scene):
        """The film must live row-sharded across the data axis (the round-2
        review flagged full-film replication per device)."""
        mesh = shard_mod.make_mesh(data=8, sample=1)
        film = shard_mod.new_band_film(mesh, SETTINGS)
        assert film.rgb.sharding.spec == jax.sharding.PartitionSpec("data")
        # each device holds only its band: 1/8 of the rows
        shard_shape = film.rgb.sharding.shard_shape(film.rgb.shape)
        assert shard_shape[0] == film.rgb.shape[0] // 8


class TestShardedGradient:
    def test_pmean_grad_equals_single_device(self, scene):
        """The distributed gradient must equal jax.grad on one device."""
        from functools import partial

        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        from gopbrt_tpu.models import film as film_mod

        n_pix = 256
        mesh = shard_mod.make_mesh(data=4, sample=2)

        def sd_loss(kd):
            sc = scene._replace(materials=scene.materials._replace(kd=kd))
            f = film_mod.new_film(16, 16)
            pix = jnp.arange(n_pix, dtype=jnp.uint32)
            for s in range(2):
                f = render_mod.render_wave(
                    sc, CAM, f, SETTINGS, pix, jnp.full((n_pix,), s, jnp.uint32)
                )
            img = f.rgb / jnp.maximum(f.weight[..., None], 1e-8)
            return jnp.mean(img**2)

        g_ref = jax.grad(sd_loss)(scene.materials.kd)

        @partial(
            shard_map, mesh=mesh, in_specs=(P(), P("data")), out_specs=P(),
            check_vma=False,
        )
        def sharded(kd, pix):
            s_idx = jax.lax.axis_index("sample")

            def loss(kd):
                sc = scene._replace(materials=scene.materials._replace(kd=kd))
                f = film_mod.new_film(16, 16)
                f = render_mod.render_wave(
                    sc, CAM, f, SETTINGS, pix,
                    jnp.broadcast_to(s_idx.astype(jnp.uint32), pix.shape),
                )
                rgb = jax.lax.psum(f.rgb, ("data", "sample"))
                w = jax.lax.psum(f.weight, ("data", "sample"))
                return jnp.mean((rgb / jnp.maximum(w[..., None], 1e-8)) ** 2)

            return jax.lax.pmean(jax.grad(loss)(kd), ("data", "sample"))

        g_multi = jax.jit(sharded)(
            scene.materials.kd, jnp.arange(n_pix, dtype=jnp.uint32)
        )
        np.testing.assert_allclose(
            np.asarray(g_multi), np.asarray(g_ref), rtol=1e-4, atol=1e-7
        )


class TestTrainStep:
    def test_distributed_gradient_step_runs_and_descends(self, scene):
        mesh = shard_mod.make_mesh(data=4, sample=2)
        params = {"kd": scene.materials.kd}

        def param_to_scene(p):
            return scene._replace(materials=scene.materials._replace(kd=p["kd"]))

        opt = optax.adam(5e-2)
        step = shard_mod.make_train_step(mesh, CAM, SETTINGS, param_to_scene, opt)
        target = jnp.zeros((16, 16, 3), jnp.float32)  # drive toward black
        state = opt.init(params)
        p1, state, l1 = step(params, state, target)
        losses = [float(l1)]
        for _ in range(4):
            p1, state, l = step(p1, state, target)
            losses.append(float(l))
        assert all(np.isfinite(losses))
        assert losses[-1] < losses[0]  # descending toward black target
        # albedo moved down
        assert float(jnp.mean(p1["kd"])) < float(jnp.mean(params["kd"]))
