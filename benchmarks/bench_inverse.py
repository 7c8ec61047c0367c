"""BASELINE config-5 end-to-end: inverse rendering.

Optimizes an albedo IMAGE TEXTURE (16x16 atlas on a uv-mapped sphere)
and the area-light radiance jointly from a target image, with 64-spp
gradient steps (the config-5 description verbatim), Adam, pixel-MSE
loss.  Gradients flow through the full wavefront path integrator
(reverse mode through the jnp wavefront chain).  Prints one JSON line:
loss trajectory endpoints, texture recovery error, and ms per gradient
step.

Usage: python benchmarks/bench_inverse.py [--steps N]
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
import optax

from gopbrt_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

W = H = 64
SPP = 64
TEX = 16


def build(atlas: np.ndarray, radiance):
    from gopbrt_tpu.models import camera as cam_mod
    from gopbrt_tpu.models.scene import SceneBuilder
    from gopbrt_tpu.ops import geom

    b = SceneBuilder()
    floor = b.matte(kd=(0.4, 0.4, 0.4))
    b.disk(np.asarray(geom.rotate_x(-90.0)), 40.0, floor)
    tex = b.image_texture(atlas)
    m = b.matte(kd=(1.0, 1.0, 1.0), kd_tex=tex)
    b.sphere(np.asarray(geom.translate([0.0, 1.0, 0.0])), 1.0, m)
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    lamp = b.sphere(np.asarray(geom.translate([-2.0, 3.5, 2.0])), 0.5, dark)
    b.area_light(lamp, radiance=tuple(radiance), two_sided=False)
    scene = b.build(accelerator="none")
    cam = cam_mod.perspective_camera(
        geom.look_at([0.0, 1.6, 4.0], [0.0, 0.9, 0.0], [0.0, 1.0, 0.0]),
        W, H, fov_deg=40.0,
    )
    return scene, cam


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()

    from gopbrt_tpu.models import film as film_mod
    from gopbrt_tpu.models import render as render_mod

    # ground truth: smooth RGB gradient atlas + warm lamp
    yy, xx = np.mgrid[0:TEX, 0:TEX].astype(np.float32) / (TEX - 1)
    true_atlas = np.stack([0.2 + 0.7 * xx, 0.2 + 0.7 * yy,
                           0.9 - 0.6 * xx * yy], -1).astype(np.float32)
    true_rad = np.asarray([26.0, 22.0, 18.0], np.float32)
    scene, cam = build(true_atlas, true_rad)
    settings = render_mod.RenderSettings(
        width=W, height=H, spp=SPP, max_depth=3, samples_per_pass=1,
        compaction=False,
    )

    n = W * H
    pixel = jnp.tile(jnp.arange(n, dtype=jnp.uint32), SPP)
    sample = jnp.repeat(jnp.arange(SPP, dtype=jnp.uint32), n)

    def render64(scene, sample_off):
        film = film_mod.new_film(W, H)
        film = render_mod.render_wave(
            scene, cam, film, settings, pixel, sample + sample_off
        )
        return film.rgb / jnp.maximum(film.weight[..., None], 1e-8)

    target = jax.block_until_ready(render64(scene, jnp.uint32(1 << 20)))
    # the loss cannot converge below the MC noise floor: the MSE between
    # two INDEPENDENT 64-spp renders of the ground-truth scene itself
    noise_floor = float(jnp.mean(
        (render64(scene, jnp.uint32(1 << 21)) - target) ** 2
    ))

    def param_to_scene(p):
        # sigmoid keeps the albedo in [0,1] with live gradients at the
        # boundary (a hard clip zero-grads saturated texels and stalls
        # the joint albedo/light recovery 30x above the noise floor)
        tex = scene.textures._replace(atlas=jax.nn.sigmoid(p["atlas"]))
        # radiance is optimized in LOG space: Adam's step size is scale-
        # free there, so a 10 -> 26 radiance recovery doesn't need 500
        # absolute-space steps
        li = scene.lights._replace(
            intensity=jnp.exp(p["log_radiance"])[None, :]
        )
        return scene._replace(textures=tex, lights=li)

    @jax.jit
    def step(params, opt_state, k):
        def loss_fn(p):
            img = render64(param_to_scene(p), k * jnp.uint32(SPP))
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params = {
        "atlas": jnp.zeros((TEX, TEX, 3), jnp.float32),  # sigmoid(0)=0.5
        "log_radiance": jnp.log(jnp.asarray([10.0, 10.0, 10.0], jnp.float32)),
    }
    opt = optax.adam(3e-2)
    state = opt.init(params)

    # texels the view actually constrains (nonzero gradient at init):
    # the sphere's back hemisphere is invisible and its texels never
    # receive signal, so recovery error is only meaningful on this mask
    def _loss0(p):
        return jnp.mean((render64(param_to_scene(p), jnp.uint32(0)) - target) ** 2)

    g0 = jax.grad(_loss0)(params)["atlas"]
    vis = np.abs(np.asarray(g0)).max(-1) > 1e-7

    params, state, l0 = step(params, state, jnp.uint32(0))
    jax.block_until_ready(l0)
    t0 = time.perf_counter()
    losses = [float(l0)]
    for k in range(1, args.steps):
        params, state, l = step(params, state, jnp.uint32(k))
        losses.append(float(l))
    dt = (time.perf_counter() - t0) / max(args.steps - 1, 1)

    err0 = np.abs(0.5 - true_atlas).max(-1)
    err = np.abs(
        1.0 / (1.0 + np.exp(-np.asarray(params["atlas"]))) - true_atlas
    ).max(-1)
    rad_err = float(np.abs(
        np.exp(np.asarray(params["log_radiance"])) - true_rad
    ).mean())
    print(json.dumps({
        "metric": "inverse_rendering_config5",
        "image": f"{W}x{H}", "spp_per_step": SPP, "steps": args.steps,
        "loss_first": round(losses[0], 6),
        "loss_last": round(losses[-1], 6),
        "mc_noise_floor": round(noise_floor, 6),
        "visible_texels": int(vis.sum()),
        "atlas_mae_visible_init": round(float(err0[vis].mean()), 4),
        "atlas_mae_visible_final": round(float(err[vis].mean()), 4),
        "radiance_mae_final": round(rad_err, 3),
        "ms_per_step": round(dt * 1e3, 1),
        "note": "converged when loss_last ~= mc_noise_floor; back-of-"
                "sphere texels are unconstrained and excluded via the "
                "visibility mask",
    }), flush=True)


if __name__ == "__main__":
    main()
