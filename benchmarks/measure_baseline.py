"""Measure the CPU baseline: the Go reference's demo workload
(internal/render/server.go:136-164 — 1920x1080, path depth 10) re-run as a
faithful scalar C++ tracer (native/cpu_baseline.cpp) on this host.

The Go toolchain is absent from this image, so the reference itself cannot
be timed; this measures the same algorithm in plain C++ (per-core at least
as fast as Go — no interface dispatch, no per-Spectrum heap allocation, no
GC) and extrapolates linearly to the reference's 64 goroutines
(integrator.go:307-309).  Rendering is embarrassingly parallel, so linear
extrapolation over cores is the generous upper bound for the reference.

Writes the measured numbers to stdout; BASELINE.md records the result.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def build() -> Path:
    sys.path.insert(0, str(REPO / "benchmarks"))
    from cross_validate import build_exe

    return build_exe()


def camera_matrices(width: int, height: int):
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    from gopbrt_tpu.compile_cache import enable_compile_cache
    from gopbrt_tpu.models.demo import build_demo_camera

    enable_compile_cache()
    cam = build_demo_camera(width, height)
    return (
        np.asarray(cam.raster_to_camera).reshape(-1),
        np.asarray(cam.camera_to_world).reshape(-1),
    )


def run(width=1920, height=1080, spp=1, depth=10, threads=1) -> dict:
    exe = build()
    r2c, c2w = camera_matrices(width, height)
    args = [str(exe), str(width), str(height), str(spp), str(depth),
            str(threads)]
    args += [f"{v:.9g}" for v in r2c] + [f"{v:.9g}" for v in c2w]
    out = subprocess.run(args, check=True, capture_output=True, text=True)
    return json.loads(out.stdout)


def main() -> None:
    res1 = run(threads=1)
    import os

    ncpu = os.cpu_count() or 1
    resn = run(threads=ncpu)
    per_core = res1["rays_per_s"]
    scaling = resn["rays_per_s"] / (per_core * ncpu)
    print(json.dumps({
        "per_core_rays_per_s": per_core,
        "all_core_rays_per_s": resn["rays_per_s"],
        "host_cores": ncpu,
        "thread_scaling_efficiency": round(scaling, 3),
        "ref_64core_extrapolation": per_core * 64,
        "mean_luminance": res1["mean_luminance"],
    }, indent=2))


if __name__ == "__main__":
    sys.exit(main())
