"""Per-feature-family throughput ledger (VERDICT r4 task 5).

This bench records ONE number per feature family on the current backend:
what each family costs through the jnp wavefront chain.

All families render 960x544 spp1 through render_pass;
depth matches each family's natural workload.  --e2e additionally times
the reference's de-facto full workload — 1920x1080, 16 spp, depth 10,
through render() including film develop and PNG write
(internal/render/server.go:136-164) — as wall-clock seconds per frame.

Usage: python benchmarks/bench_families.py [--family NAME] [--e2e]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from gopbrt_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

W, H = 960, 544


def _cam(eye, look, fov=45.0):
    from gopbrt_tpu.models import camera as cam_mod
    from gopbrt_tpu.ops import geom

    return cam_mod.perspective_camera(
        geom.look_at(list(eye), list(look), [0.0, 1.0, 0.0]), W, H,
        fov_deg=fov,
    )


def smooth_glass():
    from gopbrt_tpu.models.gallery import config4

    scene, camera, _ = config4(W, H)
    return scene, camera, 8


def rough_glass():
    from gopbrt_tpu.models.scene import SceneBuilder
    from gopbrt_tpu.ops import geom

    b = SceneBuilder()
    checker = b.checkerboard_texture(
        (0.8, 0.8, 0.8), (0.2, 0.2, 0.2),
        vs=(0.7, 0.0, 0.0), vt=(0.0, 0.0, 0.7), mapping="planar",
    )
    floor = b.matte(kd=(1.0, 1.0, 1.0), kd_tex=checker)
    b.disk(np.asarray(geom.rotate_x(-90.0)), 60.0, floor)
    rough = b.glass(roughness=0.15)
    b.sphere(np.asarray(geom.translate([0.0, 1.2, 0.0])), 1.2, rough)
    matte = b.matte(kd=(0.7, 0.3, 0.2))
    b.sphere(np.asarray(geom.translate([2.4, 0.8, -1.4])), 0.8, matte)
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    lamp = b.sphere(np.asarray(geom.translate([-2.5, 4.0, 2.0])), 0.5, dark)
    b.area_light(lamp, radiance=(30.0, 28.0, 24.0), two_sided=False)
    return b.build(accelerator="none"), _cam((0, 2.4, 6.5), (0, 1.0, 0)), 8


def bounded_media():
    from gopbrt_tpu.models.scene import SceneBuilder
    from gopbrt_tpu.ops import geom

    b = SceneBuilder()
    floor = b.matte(kd=(0.6, 0.6, 0.6))
    b.disk(np.asarray(geom.rotate_x(-90.0)), 60.0, floor)
    fog = b.add_medium(sigma_a=(0.08,) * 3, sigma_s=(0.4,) * 3, g=0.2)
    nm = b.null_material()
    ball = b.sphere(np.asarray(geom.translate([0.0, 1.5, 0.0])), 1.5, nm)
    b.set_medium_interface(ball, inside=fog)
    matte = b.matte(kd=(0.7, 0.3, 0.2))
    b.sphere(np.asarray(geom.translate([2.4, 0.8, -1.4])), 0.8, matte)
    b.point_light(p=(3.0, 5.0, 3.0), intensity=(80.0,) * 3)
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    lamp = b.sphere(np.asarray(geom.translate([-2.5, 4.0, 2.0])), 0.5, dark)
    b.area_light(lamp, radiance=(30.0, 28.0, 24.0), two_sided=False)
    return b.build(accelerator="none"), _cam((0, 2.4, 6.5), (0, 1.2, 0)), 5


def global_fog():
    from gopbrt_tpu.models.scene import SceneBuilder
    from gopbrt_tpu.ops import geom

    b = SceneBuilder()
    b.set_medium(sigma_a=(0.01,) * 3, sigma_s=(0.02,) * 3, g=0.0)
    floor = b.matte(kd=(0.6, 0.6, 0.6))
    b.disk(np.asarray(geom.rotate_x(-90.0)), 60.0, floor)
    matte = b.matte(kd=(0.7, 0.3, 0.2))
    b.sphere(np.asarray(geom.translate([0.0, 1.0, 0.0])), 1.0, matte)
    b.point_light(p=(3.0, 5.0, 3.0), intensity=(80.0,) * 3)
    return b.build(accelerator="none"), _cam((0, 2.4, 6.5), (0, 1.0, 0)), 5


def sss():
    from gopbrt_tpu.models.scene import SceneBuilder
    from gopbrt_tpu.ops import geom

    b = SceneBuilder()
    m = b.subsurface(rho=(0.9, 0.6, 0.3), mfp=(0.3,) * 3, eta=1.33)
    b.sphere(np.asarray(geom.translate([0.0, 1.0, 0.0])), 1.0, m)
    floor = b.matte(kd=(0.4, 0.4, 0.4))
    b.disk(np.asarray(geom.rotate_x(-90.0)), 20.0, floor)
    b.point_light(p=(3.0, 4.0, 3.0), intensity=(60.0,) * 3)
    return b.build(accelerator="none"), _cam((0, 1.5, 4.5), (0, 0.8, 0)), 4


def spatial_lights():
    from gopbrt_tpu.models.scene import SceneBuilder
    from gopbrt_tpu.ops import geom

    b = SceneBuilder(light_strategy="spatial")
    mat = b.matte(kd=(0.6, 0.6, 0.6))
    b.disk(np.asarray(geom.rotate_x(-90.0)), 40.0, mat)
    ball = b.matte(kd=(0.5, 0.5, 0.7))
    b.sphere(np.asarray(geom.translate([0.0, 1.0, 0.0])), 1.0, ball)
    b.point_light(p=(10.0, 3.0, 0.0), intensity=(300.0,) * 3)
    b.point_light(p=(-10.0, 3.0, 0.0), intensity=(3.0,) * 3)
    return b.build(accelerator="none"), _cam((0, 2.4, 8.0), (0, 1.0, 0)), 3


FAMILIES = {
    "smooth_glass": smooth_glass,
    "rough_glass": rough_glass,
    "bounded_media": bounded_media,
    "global_fog": global_fog,
    "sss": sss,
    "spatial_lights": spatial_lights,
}


def bench_family(name: str, iters: int = 3) -> None:
    from gopbrt_tpu.models import film as film_mod
    from gopbrt_tpu.models import render as render_mod

    scene, camera, depth = FAMILIES[name]()
    settings = render_mod.RenderSettings(
        width=W, height=H, spp=1, max_depth=depth, integrator="path",
        samples_per_pass=1,
    )
    film = film_mod.new_film(W, H)
    out = render_mod.render_pass(scene, camera, film, settings, jnp.uint32(0))
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for i in range(iters):
        out = render_mod.render_pass(scene, camera, out, settings,
                                     jnp.uint32(i + 1))
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    print(json.dumps({
        "family": name,
        "platform": jax.devices()[0].platform,
        "depth": depth,
        "ms_per_pass": round(dt * 1e3, 1),
        "mrays_per_s": round(W * H / dt / 1e6, 3),
    }), flush=True)


def bench_e2e() -> None:
    """The reference's de-facto full request: 1920x1080, 16 spp stratified,
    path depth 10, develop + PNG (internal/render/server.go:136-164)."""
    import tempfile

    from gopbrt_tpu.models import film as film_mod
    from gopbrt_tpu.models import render as render_mod
    from gopbrt_tpu.models.demo import build_demo_camera, build_demo_scene

    scene = build_demo_scene(accelerator="none")
    camera = build_demo_camera(1920, 1080)
    settings = render_mod.RenderSettings(
        width=1920, height=1080, spp=16, max_depth=10, integrator="path",
        samples_per_pass=4,
    )
    # warm the compile cache for the whole pipeline (render pass +
    # develop + on-device quantize): steady-state seconds-per-frame,
    # matching how the reference's long-lived daemon serves requests
    film = film_mod.new_film(1920, 1080)
    film = render_mod.render_pass(scene, camera, film, settings, jnp.uint32(0))
    np.asarray(film_mod._quantize8(film_mod.develop(film)))
    t0 = time.perf_counter()
    img = render_mod.render(scene, camera, settings)
    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        film_mod.write_png(f.name, np.asarray(img))
    dt = time.perf_counter() - t0
    rays = 1920 * 1080 * 16
    print(json.dumps({
        "family": "e2e_reference_workload_1080p_16spp_depth10",
        "seconds_per_frame": round(dt, 2),
        "mrays_per_s": round(rays / dt / 1e6, 2),
    }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default=None)
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    if args.e2e:
        bench_e2e()
        return
    names = [args.family] if args.family else list(FAMILIES)
    for n in names:
        bench_family(n)


if __name__ == "__main__":
    main()
