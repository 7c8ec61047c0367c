"""Intersection micro-benchmarks.

Mirrors the reference's scaling series —
``pkg/accelerator/{simple,bvh}_benchmark_test.go`` Benchmark*_Intersect
{1,10,100,1000} over a line of n spheres — measured as rays/s for a batch
of rays instead of ns/op for one ray (the wavefront's unit of work).

Run: python benchmarks/bench_intersect.py [--cpu] [--check]
Prints one JSON line per (aggregate, n_prims) combo.  --check applies CI
regression gates (portable structural asserts, not machine-absolute
numbers): every kernel must produce finite correct hits, and results must
agree between brute force and BVH where both run.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--rays", type=int, default=1 << 16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--check", action="store_true",
                    help="CI regression gates (oracle agreement + sanity)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from gopbrt_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from gopbrt_tpu.ops import bvh as bvh_mod
    from gopbrt_tpu.ops import geom, intersect

    def line_of_spheres(n):
        # the reference fixture: spheres spaced along +x (radius .5, step 2)
        prim_type = np.zeros(n, np.int32)
        o2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        o2w[:, 0, 3] = np.arange(n) * 2.0
        w2o = o2w.copy()
        w2o[:, 0, 3] = -o2w[:, 0, 3]
        params = np.zeros((n, 9), np.float32)
        params[:, 0] = 0.5
        params[:, 1] = -0.5
        params[:, 2] = 0.5
        params[:, 3] = 2 * np.pi
        return intersect.Primitives(
            prim_type=jnp.asarray(prim_type),
            obj_to_world=jnp.asarray(o2w),
            world_to_obj=jnp.asarray(w2o),
            params=jnp.asarray(params),
            material_id=jnp.zeros(n, jnp.int32),
            area_light_id=jnp.full((n,), -1, jnp.int32),
            reverse_orientation=jnp.zeros(n, bool),
        ), (
            np.stack([np.arange(n) * 2.0 - 0.5, np.full(n, -0.5), np.full(n, -0.5)], -1).astype(np.float32),
            np.stack([np.arange(n) * 2.0 + 0.5, np.full(n, 0.5), np.full(n, 0.5)], -1).astype(np.float32),
        )

    rng = np.random.default_rng(0)

    for n in (1, 10, 100, 1000):
        prims, (blo, bhi) = line_of_spheres(n)
        o = np.zeros((args.rays, 3), np.float32)
        o[:, 0] = rng.uniform(-2, n * 2.0, args.rays)
        o[:, 1] = 3.0
        d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (args.rays, 1))
        o_j, d_j = jnp.asarray(o), jnp.asarray(d)
        t_max = jnp.full((args.rays,), 1e30)

        runs = {}
        if n <= 100:  # brute force memory O(rays*prims)
            brute = jax.jit(lambda o, d: intersect.intersect_brute(prims, o, d, t_max))
            runs["simple"] = brute
        bvh = bvh_mod.build_from_bounds(blo, bhi)
        runs["bvh"] = jax.jit(lambda o, d: bvh_mod.bvh_intersect(bvh, prims, o, d, t_max))

        if args.check:
            outs = {name: jax.tree.map(np.asarray, fn(o_j, d_j))
                    for name, fn in runs.items()}
            for name, (hit, t, idx) in outs.items():
                assert np.isfinite(t).all(), f"{name}@{n}: non-finite t"
                assert hit.any(), f"{name}@{n}: no hits on a hit-all fixture"
            if "simple" in outs and "bvh" in outs:
                (h1, t1, i1), (h2, t2, i2) = outs["simple"], outs["bvh"]
                assert (h1 == h2).mean() > 0.9999, f"oracle mismatch @ {n}"
                same = h1 & h2
                assert np.allclose(t1[same], t2[same], atol=1e-4), (
                    f"t mismatch @ {n}"
                )

        for name, fn in runs.items():
            out = fn(o_j, d_j)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = fn(o_j, d_j)
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t0) / args.iters
            print(
                json.dumps(
                    {
                        "metric": f"{name}_intersect_{n}_spheres",
                        "value": round(args.rays / dt, 1),
                        "unit": "rays/s",
                        "batch": args.rays,
                    }
                )
            )


if __name__ == "__main__":
    main()
