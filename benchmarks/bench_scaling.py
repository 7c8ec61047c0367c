"""Multi-device scaling measurement on the virtual CPU mesh.

Measures the 1 -> 2 -> 4 -> 8 device scaling of the sharded renderer
(parallel/shard.py) and the band-film vs replicated-film communication
cost.  Run with:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python benchmarks/bench_scaling.py

HONESTY NOTE: an 8-device virtual CPU mesh time-slices the host's cores,
so wall-clock here measures *overhead scaling* (does the SPMD program add
communication/lowering cost as the mesh grows), not compute scaling.  The
compute partition is exact by construction (each device traces 1/N of the
pixel wavefront; the counter-based sampler makes the partition
bit-equivalent, tests/test_sharding.py).  The table below therefore reports:
  * wall time per pass (proxy: flat or sub-linear growth = low overhead),
  * per-device film bytes moved per pass (analytic, the real interconnect
    cost).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")
from gopbrt_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import jax.numpy as jnp
import numpy as np


def main() -> None:
    from gopbrt_tpu.models import render as render_mod
    from gopbrt_tpu.models.demo import build_demo_camera, build_demo_scene
    from gopbrt_tpu.parallel import shard as shard_mod

    W, H, DEPTH = 320, 184, 5
    scene = build_demo_scene(accelerator="none")
    camera = build_demo_camera(W, H)
    settings = render_mod.RenderSettings(
        width=W, height=H, spp=1, max_depth=DEPTH, samples_per_pass=1,
    )

    matrix = [("band", 1), ("band", 2), ("band", 4), ("band", 8),
              ("replicated", 8)]
    rows = []
    for layout, n in matrix:
            mesh = shard_mod.make_mesh(data=n, sample=1,
                                       devices=jax.devices()[:n])
            band = layout == "band"
            if band:
                film = shard_mod.new_band_film(mesh, settings)
                fn = jax.jit(shard_mod.render_pass_sharded_band,
                             static_argnames=("mesh", "settings"))
            else:
                from jax.sharding import NamedSharding, PartitionSpec as P
                from gopbrt_tpu.models import film as film_mod

                film = jax.device_put(
                    film_mod.new_film(W, H), NamedSharding(mesh, P())
                )
                fn = jax.jit(shard_mod.render_pass_sharded,
                             static_argnames=("mesh", "settings"))
            out = fn(mesh, scene, camera, film, settings, jnp.uint32(0))
            jax.block_until_ready(out)  # compile
            iters = 3
            t0 = time.perf_counter()
            f = out
            for i in range(iters):
                f = fn(mesh, scene, camera, f, settings, jnp.uint32(i + 1))
            jax.block_until_ready(f)
            dt = (time.perf_counter() - t0) / iters
            # per-device film bytes communicated per pass (analytic):
            # replicated: whole-film psum -> H*W*4 floats in+out
            # band: spp-psum none (sample=1) + 2 halo rows each way
            if band:
                rr = 1
                comm = 2 * rr * W * 4 * 4  # 2 directions x rr rows x rgba'ish
            else:
                comm = H * W * 4 * 4
            rows.append(dict(layout=layout, devices=n,
                             ms_per_pass=round(dt * 1e3, 1),
                             film_comm_bytes_per_dev=comm))
            print(json.dumps(rows[-1]), flush=True)

    base = {r["devices"]: r["ms_per_pass"] for r in rows if r["layout"] == "band"}
    summary = dict(
        metric="band_film_overhead_scaling_320x184_depth5_cpu_proxy",
        ms_per_pass=base,
        note=(
            "8 virtual devices sharing the host's cores: wall time measures SPMD "
            "overhead, not compute scaling (see module docstring). Film comm "
            f"per device per pass: band={2*1*W*4*4}B vs replicated={H*W*4*4}B "
            f"({(H*W)//(2*1*W)}x reduction)."
        ),
        rows=rows,
    )
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
