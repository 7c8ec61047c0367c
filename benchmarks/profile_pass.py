"""Ablation profile of one 1080p render pass on the demo scene.

Times the components of the wavefront bounce loop separately so the
roofline note in BENCH_NOTES.md is grounded in measurements, not intuition
Run on the GPU:

    python benchmarks/profile_pass.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from gopbrt_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from gopbrt_tpu.models import camera as cam_mod
from gopbrt_tpu.models import film as film_mod
from gopbrt_tpu.models import integrators
from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.demo import build_demo_camera, build_demo_scene
from gopbrt_tpu.ops import rng

W, H, DEPTH = 1920, 1080, 10
N = W * H


def timeit(fn, *args, iters=5, warmup=1):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    scene = build_demo_scene(accelerator="bvh")
    camera = build_demo_camera(W, H)
    settings = render_mod.RenderSettings(
        width=W, height=H, spp=1, max_depth=DEPTH, integrator="path",
        samples_per_pass=1,
    )
    film = film_mod.new_film(W, H)
    seed = jnp.uint32(0)

    # --- full pass
    t_full = timeit(
        lambda s: render_mod.render_pass(scene, camera, film, settings, s),
        jnp.uint32(1),
    )
    print(f"full render_pass        : {t_full*1e3:8.2f} ms   ({N/t_full/1e6:.1f} Mrays/s)")

    # --- raygen only
    pixel_idx = jnp.arange(N, dtype=jnp.uint32)
    sample_idx = jnp.zeros((N,), jnp.uint32)

    @jax.jit
    def raygen(s):
        p_film, u_lens = render_mod.camera_samples(settings, pixel_idx, sample_idx, s)
        return cam_mod.generate_rays(camera, p_film, u_lens)

    o, d = raygen(seed)
    t_raygen = timeit(raygen, seed)
    print(f"raygen                  : {t_raygen*1e3:8.2f} ms")

    # --- single closest-hit intersect over the wavefront
    t_max = jnp.full((N,), 1e30, jnp.float32)

    @jax.jit
    def isect_once(o, d):
        return integrators._scene_intersect(scene, o, d, t_max)

    t_isect = timeit(isect_once, o, d)
    print(f"closest-hit x1          : {t_isect*1e3:8.2f} ms   (x{DEPTH} = {t_isect*DEPTH*1e3:.1f} ms)")

    @jax.jit
    def isect_p_once(o, d):
        return integrators._scene_intersect_p(scene, o, d, t_max)

    t_isectp = timeit(isect_p_once, o, d)
    print(f"any-hit x1              : {t_isectp*1e3:8.2f} ms   (x{DEPTH} = {t_isectp*DEPTH*1e3:.1f} ms)")

    # --- surface interaction build (phase 2)
    hit, t, prim_idx = isect_once(o, d)

    @jax.jit
    def si_build(hit, t, prim_idx, o, d):
        from gopbrt_tpu.ops import intersect as isect_ops
        return isect_ops.surface_interaction(scene.prims, hit, t, prim_idx, o, d)

    t_si = timeit(si_build, hit, t, prim_idx, o, d)
    print(f"surface_interaction x1  : {t_si*1e3:8.2f} ms   (x{DEPTH} = {t_si*DEPTH*1e3:.1f} ms)")

    si = si_build(hit, t, prim_idx, o, d)

    # --- material gather + texture eval
    @jax.jit
    def mat_at(si):
        return integrators._material_at(scene, si)

    t_mat = timeit(mat_at, si)
    print(f"material_at x1          : {t_mat*1e3:8.2f} ms   (x{DEPTH} = {t_mat*DEPTH*1e3:.1f} ms)")

    mp = mat_at(si)

    # --- NEE estimate_direct, minus its shadow ray (jit fuses; do both)
    @jax.jit
    def nee(si, mp):
        ss, ts, ns = integrators._shading_frame(si)
        return integrators._estimate_direct(
            scene, si, mp, ss, ts, ns, si.valid, seed, pixel_idx, sample_idx, 5
        )

    t_nee = timeit(nee, si, mp)
    print(f"estimate_direct x1      : {t_nee*1e3:8.2f} ms   (x{DEPTH} = {t_nee*DEPTH*1e3:.1f} ms)")

    # --- BSDF sample
    @jax.jit
    def bsample(si, mp):
        from gopbrt_tpu.ops import bsdf as bsdf_ops
        ss, ts, ns = integrators._shading_frame(si)
        u_b = rng.sample_2d(seed, pixel_idx, sample_idx, 8)
        u_lobe = rng.sample_1d(seed, pixel_idx, sample_idx, 10)
        wo_l = integrators._to_local(ss, ts, ns, si.wo)
        return bsdf_ops.bsdf_sample(mp, wo_l, u_b, u_lobe)

    t_bs = timeit(bsample, si, mp)
    print(f"bsdf_sample x1          : {t_bs*1e3:8.2f} ms   (x{DEPTH} = {t_bs*DEPTH*1e3:.1f} ms)")

    # --- film splat
    L = jnp.ones((N, 3), jnp.float32)
    p_film = jnp.stack(
        [(pixel_idx % W).astype(jnp.float32), (pixel_idx // W).astype(jnp.float32)],
        axis=-1,
    ) + 0.5

    @jax.jit
    def splat(L):
        return film_mod.add_samples(film, p_film, L, settings.filter)

    t_splat = timeit(splat, L)
    print(f"film splat (scatter)    : {t_splat*1e3:8.2f} ms")

    # --- single full bounce-loop at varying depths to see marginal cost
    for depth in (1, 2, 5, 10):
        st = settings._replace(max_depth=depth)
        td = timeit(
            lambda s: render_mod.render_pass(scene, camera, film, st, s),
            jnp.uint32(1),
        )
        print(f"render_pass depth={depth:2d}    : {td*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
