"""Headline benchmark: rays/s for a 1080p 1spp path trace of the demo scene.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline context: the reference publishes no numbers (BASELINE.md); its
de-facto workload is the demo scene at 1920x1080, path depth 10, on CPU with
64 goroutines (internal/render/server.go:136-164).  BASELINE_RAYS_PER_S is
now MEASURED (round 3): a faithful scalar C++ reimplementation of the
reference's demo workload (native/cpu_baseline.cpp, cross-validated against
this renderer to <1% mean radiance) measures 0.893 Mrays/s/core on this
image's Xeon @2.1GHz with 99.7% thread scaling; the adopted baseline is a
16-core box at C++ speed = 14.3 Mrays/s, generous to the reference on both
axes (Go with per-Spectrum heap allocation is measurably slower per core;
see BASELINE.md for the measurement table and the 64-core upper bound).
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

from gopbrt_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

# MEASURED (see module docstring + BASELINE.md): 0.893 Mrays/s/core for the
# reference demo workload in scalar C++, x16 cores (Go-speed generosity
# folded in).  benchmarks/measure_baseline.py reproduces the number.
BASELINE_RAYS_PER_S = 14.3e6

WIDTH, HEIGHT, SPP = 1920, 1080, 1
MAX_DEPTH = 10


def main() -> None:
    from gopbrt_tpu.models import film as film_mod
    from gopbrt_tpu.models import render as render_mod
    from gopbrt_tpu.models.demo import build_demo_camera, build_demo_scene

    scene = build_demo_scene(accelerator="bvh")
    camera = build_demo_camera(WIDTH, HEIGHT)
    settings = render_mod.RenderSettings(
        width=WIDTH, height=HEIGHT, spp=SPP, max_depth=MAX_DEPTH,
        integrator="path", samples_per_pass=1,
    )
    film = film_mod.new_film(WIDTH, HEIGHT)

    # compile + warm up; passes chain through the film, so waiting on the
    # last pass's film waits on the whole timed chain
    out = render_mod.render_pass(scene, camera, film, settings, jnp.uint32(0))
    jax.block_until_ready(out)

    n_iters = 5
    t0 = time.perf_counter()
    for i in range(n_iters):
        out = render_mod.render_pass(
            scene, camera, out, settings, jnp.uint32(i + 1)
        )
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n_iters

    # rays/s counts camera rays only (the conventional paths/s metric);
    # each path traces up to MAX_DEPTH segments + shadow rays.
    rays = WIDTH * HEIGHT * SPP
    rays_per_s = rays / dt
    print(
        json.dumps(
            {
                "metric": "camera_rays_per_s_1080p_path_depth10",
                "value": round(rays_per_s, 1),
                "unit": "rays/s",
                "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
