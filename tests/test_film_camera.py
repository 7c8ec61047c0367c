"""Film splat + camera ray-gen tests (pkg/pbrt/film.go, camera.go)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gopbrt_tpu.models import camera as cam_mod
from gopbrt_tpu.models import film as film_mod
from gopbrt_tpu.ops import filters, geom


class TestFilm:
    def test_box_single_pixel_center(self):
        f = film_mod.new_film(8, 8)
        p = jnp.asarray([[3.5, 2.5]], jnp.float32)  # center of pixel (3,2)
        L = jnp.asarray([[1.0, 2.0, 3.0]], jnp.float32)
        f = film_mod.add_samples(f, p, L, filters.box_filter(0.5))
        img = np.asarray(f.rgb)
        w = np.asarray(f.weight)
        assert w[2, 3] == pytest.approx(1.0)
        assert w.sum() == pytest.approx(1.0)
        np.testing.assert_allclose(img[2, 3], [1, 2, 3])

    def test_box_radius1_spreads(self):
        # reference demo's box radius (1,1): support covers 2x2 pixels for
        # an off-center sample (film.go:211-248 rasterization)
        f = film_mod.new_film(8, 8)
        p = jnp.asarray([[3.0, 3.0]], jnp.float32)  # pixel corner
        L = jnp.asarray([[1.0, 1.0, 1.0]], jnp.float32)
        f = film_mod.add_samples(f, p, L, filters.box_filter(1.0))
        w = np.asarray(f.weight)
        assert (w > 0).sum() == 4
        assert w.sum() == pytest.approx(4.0)  # box weight 1 each

    def test_develop_normalizes(self):
        f = film_mod.new_film(4, 4)
        p = jnp.asarray([[1.5, 1.5], [1.5, 1.5]], jnp.float32)
        L = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], jnp.float32)
        f = film_mod.add_samples(f, p, L, filters.box_filter(0.5))
        img = np.asarray(film_mod.develop(f, gamma=False))
        np.testing.assert_allclose(img[1, 1], [0.5, 0.5, 0.0], atol=1e-6)

    def test_out_of_bounds_dropped(self):
        f = film_mod.new_film(4, 4)
        p = jnp.asarray([[-5.0, 2.0], [2.0, 7.0], [3.9, 3.9]], jnp.float32)
        L = jnp.ones((3, 3), jnp.float32)
        f = film_mod.add_samples(f, p, L, filters.box_filter(0.5))
        assert np.asarray(f.weight).sum() == pytest.approx(1.0)

    def test_splat_is_differentiable(self):
        def loss(L):
            f = film_mod.new_film(4, 4)
            p = jnp.asarray([[1.5, 1.5]], jnp.float32)
            f = film_mod.add_samples(f, p, L, filters.box_filter(0.5))
            return jnp.sum(f.rgb)

        g = jax.grad(loss)(jnp.ones((1, 3), jnp.float32))
        np.testing.assert_allclose(np.asarray(g), 1.0)

    def test_gaussian_weights_decay(self):
        f = film_mod.new_film(9, 9)
        p = jnp.asarray([[4.5, 4.5]], jnp.float32)
        L = jnp.ones((1, 3), jnp.float32)
        f = film_mod.add_samples(f, p, L, filters.gaussian_filter(2.0))
        w = np.asarray(f.weight)
        assert w[4, 4] > w[4, 5] > 0
        # the gaussian is shifted to reach exactly 0 at the radius
        assert w[4, 6] == pytest.approx(0.0, abs=1e-6)

    def test_merge_additive(self):
        a = film_mod.new_film(4, 4)
        p = jnp.asarray([[1.5, 1.5]], jnp.float32)
        L = jnp.ones((1, 3), jnp.float32)
        a = film_mod.add_samples(a, p, L, filters.box_filter(0.5))
        m = film_mod.merge(a, a)
        assert np.asarray(m.weight).sum() == pytest.approx(2.0)


class TestPng:
    """film.write_png's standard-library encoder."""

    @pytest.mark.parametrize("hw", [(1, 1), (5, 7), (54, 96)])
    def test_round_trip(self, tmp_path, hw):
        h, w = hw
        rng = np.random.default_rng(h * w)
        img = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
        path = film_mod.write_png(str(tmp_path / "out.png"), img)
        data = open(path, "rb").read()
        expect = film_mod.to_uint8(img)
        np.testing.assert_array_equal(film_mod.decode_png(data), expect)
        # any PNG reader agrees (Pillow, when the test host has it)
        Image = pytest.importorskip("PIL.Image")
        with Image.open(path) as im:
            assert im.mode == "RGB" and im.size == (w, h)
            np.testing.assert_array_equal(np.asarray(im), expect)

    def test_corrupt_chunk_is_refused(self):
        data = bytearray(film_mod.encode_png(np.zeros((4, 4, 3), np.uint8)))
        data[40] ^= 0xFF  # inside the IDAT payload: its CRC no longer holds
        with pytest.raises(ValueError, match="CRC"):
            film_mod.decode_png(bytes(data))


class TestSrgb:
    def test_roundtrip_monotone(self):
        x = jnp.linspace(0, 1, 64)
        y = np.asarray(film_mod.srgb_encode(x))
        assert (np.diff(y) > 0).all()
        assert y[0] == pytest.approx(0.0, abs=1e-6)
        assert y[-1] == pytest.approx(1.0, abs=1e-3)


class TestPerspectiveCamera:
    def make(self, w=64, h=64, fov=90.0):
        return cam_mod.perspective_camera(geom.identity(), w, h, fov_deg=fov)

    def test_center_ray_along_axis(self):
        cam = self.make()
        p = jnp.asarray([[32.0, 32.0]], jnp.float32)
        o, d = cam_mod.generate_rays(cam, p, jnp.zeros((1, 2)))
        np.testing.assert_allclose(np.asarray(o[0]), 0.0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(d[0]), [0, 0, 1], atol=1e-5)

    def test_corners_symmetric_and_fov(self):
        cam = self.make(fov=90.0)
        p = jnp.asarray([[0.0, 32.0], [64.0, 32.0]], jnp.float32)
        o, d = cam_mod.generate_rays(cam, p, jnp.zeros((2, 2)))
        d = np.asarray(d)
        # 90° fov: edge rays at 45° from axis horizontally
        assert abs(d[0, 0]) == pytest.approx(abs(d[1, 0]), abs=1e-5)
        assert abs(np.degrees(np.arctan2(abs(d[0, 0]), d[0, 2])) - 45.0) < 0.1
        # raster x increases -> screen x decreases? (PBRT: +x right)
        assert d[0, 0] != d[1, 0]

    def test_camera_to_world_applied(self):
        m = geom.look_at([10.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
        cam = cam_mod.perspective_camera(m, 64, 64, fov_deg=60.0)
        p = jnp.asarray([[32.0, 32.0]], jnp.float32)
        o, d = cam_mod.generate_rays(cam, p, jnp.zeros((1, 2)))
        np.testing.assert_allclose(np.asarray(o[0]), [10, 0, 0], atol=1e-4)
        np.testing.assert_allclose(np.asarray(d[0]), [-1, 0, 0], atol=1e-5)

    def test_thin_lens_jitters_origin(self):
        cam = cam_mod.perspective_camera(
            geom.identity(), 64, 64, fov_deg=60.0,
            lens_radius=0.5, focal_distance=10.0,
        )
        p = jnp.tile(jnp.asarray([[32.0, 32.0]], jnp.float32), (2, 1))
        u = jnp.asarray([[0.1, 0.2], [0.9, 0.8]], jnp.float32)
        o, d = cam_mod.generate_rays(cam, p, u)
        o = np.asarray(o)
        assert not np.allclose(o[0], o[1])
        # both rays converge at the focal plane
        t0 = 10.0 / np.asarray(d)[0, 2]
        t1 = 10.0 / np.asarray(d)[1, 2]
        f0 = o[0] + np.asarray(d)[0] * t0
        f1 = o[1] + np.asarray(d)[1] * t1
        np.testing.assert_allclose(f0, f1, atol=1e-4)

    def test_orthographic_parallel_rays(self):
        cam = cam_mod.orthographic_camera(geom.identity(), 32, 32)
        p = jnp.asarray([[4.0, 4.0], [28.0, 28.0]], jnp.float32)
        o, d = cam_mod.generate_rays(cam, p, jnp.zeros((2, 2)))
        d = np.asarray(d)
        np.testing.assert_allclose(d[0], d[1], atol=1e-6)
        np.testing.assert_allclose(d[0], [0, 0, 1], atol=1e-6)
        assert not np.allclose(np.asarray(o)[0], np.asarray(o)[1])


class TestCropWindow:
    """Film crop window (film.go:42-59 CroppedPixelBounds): only crop pixels
    are sampled/stored, and — because pixel ids stay global — the crop
    render equals the same region of the full render exactly."""

    def test_crop_equals_full_render_region(self):
        import numpy as np
        from gopbrt_tpu.models import render as render_mod
        from gopbrt_tpu.models import camera as cam_mod
        from gopbrt_tpu.models.scene import SceneBuilder
        from gopbrt_tpu.ops import geom

        b = SceneBuilder()
        mat = b.matte(kd=(0.7, 0.5, 0.3))
        b.sphere(np.asarray(geom.translate([0.0, 1.0, 0.0])), 1.0, mat)
        floor = b.matte(kd=(0.4, 0.4, 0.4))
        b.disk(np.asarray(geom.rotate_x(-90.0)), 40.0, floor)
        b.point_light(p=(2.0, 6.0, 3.0), intensity=(60.0, 60.0, 60.0))
        scene = b.build(accelerator="none")
        cam = cam_mod.perspective_camera(
            geom.look_at([0.0, 2.0, 5.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]),
            32, 24, fov_deg=45.0,
        )
        settings = render_mod.RenderSettings(
            width=32, height=24, spp=2, max_depth=2, samples_per_pass=2,
        )
        full = np.asarray(render_mod.render(scene, cam, settings))
        crop = ((0.25, 0.25), (0.75, 0.75))
        img = np.asarray(
            render_mod.render(scene, cam, settings._replace(crop=crop))
        )
        x0, x1, y0, y1 = render_mod.crop_pixel_bounds(settings._replace(crop=crop))
        assert img.shape == (y1 - y0, x1 - x0, 3)
        # interior pixels match the full render bit-for-bit (same streams);
        # the crop's border row/col may differ (filter taps from outside
        # the crop are absent) -> compare the interior
        np.testing.assert_allclose(
            img[1:-1, 1:-1], full[y0 + 1 : y1 - 1, x0 + 1 : x1 - 1], atol=1e-6
        )
