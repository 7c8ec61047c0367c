"""BVH-in-anger throughput: path-trace the BASELINE config-3 mesh scene.

Renders models/meshes.build_mesh_scene (10,224-triangle tessellated sphere
+ checker floor + point/area lights) at 1spp depth-5 and reports
camera-rays/s.  The path trace runs the jnp wavefront chain with the
lockstep BVH traversal of ops/bvh.py.

Usage: python benchmarks/bench_mesh.py [--width W --height H --depth D]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from gopbrt_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    from gopbrt_tpu.models import film as film_mod
    from gopbrt_tpu.models import render as render_mod
    from gopbrt_tpu.models.meshes import build_mesh_scene, mesh_camera

    scene = build_mesh_scene()  # 10,224 tris under SAH BVH
    assert scene.bvh is not None
    camera = mesh_camera(args.width, args.height)
    settings = render_mod.RenderSettings(
        width=args.width, height=args.height, spp=1, max_depth=args.depth,
        integrator="path", samples_per_pass=1,
    )
    film = film_mod.new_film(args.width, args.height)

    out = render_mod.render_pass(scene, camera, film, settings, jnp.uint32(0))
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    for i in range(args.iters):
        out = render_mod.render_pass(scene, camera, out, settings, jnp.uint32(i + 1))
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / args.iters

    rays = args.width * args.height
    print(
        json.dumps(
            {
                "metric": f"bvh_mesh10k_rays_per_s_{args.width}x{args.height}_depth{args.depth}",
                "value": round(rays / dt, 1),
                "unit": "rays/s",
                "n_prims": int(scene.prims.count),
                "ms_per_pass": round(dt * 1e3, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
