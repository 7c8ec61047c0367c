"""Cross-validate every golden config against the independent C++ tracer.

For each BASELINE config (1-4) this renders the scene twice —

  * with this repo's JAX renderer (whatever backend is active), linear
    radiance via film.develop(gamma=False);
  * with the scalar C++ tracer (native/cpu_baseline.cpp --scene mode),
    an INDEPENDENT reimplementation of the reference's BVH + path/direct
    integrator + matte/mirror/glass/plastic BSDFs that shares only the
    flattened scene tables —

and asserts mean radiance and all nine 3x3 region means agree within the
per-config tolerance.  The two sides use unrelated RNGs and samplers, so
agreement is a semantic check on the light-transport math, not an RNG
echo (VERDICT r4 task 4: the goldens were previously validated only
against this renderer itself for configs 2-4).

Tolerances are Monte-Carlo-noise bounds, loosest for config 4 whose
glass caustics converge slowest.

Usage: python benchmarks/cross_validate.py [--fast] [--config N]
       python benchmarks/cross_validate.py --mesh-baseline
Exit code 0 = all configs agree; 1 = divergence (the check CI consumes).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gopbrt_tpu.compile_cache import enable_compile_cache  # noqa: E402


def build_exe() -> Path:
    """Build the scalar tracer once per source version.  Portable flags
    only: a binary tuned for one host's CPU could die with SIGILL on
    another that shares the checkout."""
    import hashlib

    src = REPO / "gopbrt_tpu/native/cpu_baseline.cpp"
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = REPO / f"gopbrt_tpu/native/_build/cpu_baseline-{h}"
    out.parent.mkdir(exist_ok=True)
    if not out.exists():
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-pthread", str(src), "-o", str(out)],
            check=True,
        )
    return out


def export_scene(scene, camera, path: str) -> None:
    """Flatten scene tables to the GOPBRT-SCENE-1 text dump."""
    from gopbrt_tpu.ops.intersect import SPHERE, DISK, TRIANGLE
    from gopbrt_tpu.native.scene_tables import light_tables, mat_shade_table

    prims = scene.prims
    ptype = np.asarray(prims.prim_type)
    o2w = np.asarray(prims.obj_to_world, np.float64)
    w2o = np.asarray(prims.world_to_obj, np.float32)
    par = np.asarray(prims.params, np.float32)
    mat = np.asarray(prims.material_id)
    alid = np.asarray(prims.area_light_id)
    P = len(ptype)

    # world bounds: object AABB corners through obj_to_world
    lo = np.zeros((P, 3), np.float64)
    hi = np.zeros((P, 3), np.float64)
    for i in range(P):
        if ptype[i] == TRIANGLE:
            v = par[i].reshape(3, 3).astype(np.float64)
            lo[i] = v.min(0) - 1e-4
            hi[i] = v.max(0) + 1e-4
            continue
        if ptype[i] == SPHERE:
            r = float(par[i, 0])
            olo = np.array([-r, -r, -r])
            ohi = np.array([r, r, r])
        else:  # DISK: z = height, radius par[1]
            h, r = float(par[i, 0]), float(par[i, 1])
            olo = np.array([-r, -r, h - 1e-3])
            ohi = np.array([r, r, h + 1e-3])
        corners = np.array(
            [[olo[0] if a == 0 else ohi[0],
              olo[1] if b == 0 else ohi[1],
              olo[2] if c == 0 else ohi[2]]
             for a in (0, 1) for b in (0, 1) for c in (0, 1)]
        )
        wc = corners @ o2w[i, :3, :3].T + o2w[i, :3, 3]
        lo[i] = wc.min(0)
        hi[i] = wc.max(0)

    mtypes = np.asarray(scene.materials.mat_type)
    mshade = mat_shade_table(scene)
    ltype, lpos, lint, laux = light_tables(scene)
    ltype = np.asarray(ltype)
    lpos = np.asarray(lpos)
    lint = np.asarray(lint)
    laux = np.asarray(laux)
    if len(ltype):
        assert np.allclose(laux[:, 5], laux[0, 5]), (
            "cross_validate assumes uniform light selection (equal pick "
            "pmf); power/spatial strategies change only MIS weights "
            "(unbiased either way) but the C++ side implements uniform — "
            "rebuild the scene with light_strategy='uniform'"
        )

    def fmt(a):
        return " ".join(f"{float(x):.9g}" for x in np.asarray(a).reshape(-1))

    with open(path, "w") as f:
        f.write("GOPBRT-SCENE-1\n")
        f.write(f"cam {fmt(camera.raster_to_camera)} "
                f"{fmt(camera.camera_to_world)}\n")
        f.write(f"wr {float(np.asarray(scene.world_radius)):.9g}\n")
        f.write(f"nprims {P}\n")
        tmap = {int(SPHERE): 0, int(DISK): 1, int(TRIANGLE): 2}
        for i in range(P):
            f.write(f"{tmap[int(ptype[i])]} {fmt(w2o[i, :3, :4])} "
                    f"{fmt(par[i])} {int(mat[i])} {int(alid[i])} "
                    f"{fmt(lo[i])} {fmt(hi[i])}\n")
        f.write(f"nmats {len(mtypes)}\n")
        for i in range(len(mtypes)):
            f.write(f"{int(mtypes[i])} {fmt(mshade[i])}\n")
        f.write(f"nlights {len(ltype)}\n")
        for i in range(len(ltype)):
            f.write(f"{int(ltype[i])} {fmt(lpos[i])} {fmt(lint[i])} "
                    f"{fmt(laux[i])}\n")


def render_jax(scene, camera, settings) -> np.ndarray:
    import jax.numpy as jnp

    from gopbrt_tpu.models import film as film_mod
    from gopbrt_tpu.models import render as render_mod

    film = film_mod.new_film(settings.width, settings.height)
    n_passes = -(-settings.spp // settings.samples_per_pass)
    for p in range(n_passes):
        film = render_mod.render_pass(
            scene, camera, film, settings,
            jnp.uint32(p * settings.samples_per_pass),
        )
    return np.asarray(film_mod.develop(film, gamma=False))


def region_means(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    lum = img.mean(-1)
    return np.array([
        lum[(h * r) // 3:(h * (r + 1)) // 3,
            (w * c) // 3:(w * (c + 1)) // 3].mean()
        for r in range(3) for c in range(3)
    ])


# (name, width, height, spp, depth, mode, mean_tol, region_tol)
VAL_CONFIGS = [
    ("config1_demo_direct", 480, 270, 32, 3, "direct", 0.02, 0.05),
    ("config2_cornell_mirror", 480, 480, 32, 5, "path", 0.02, 0.04),
    ("config3_mesh_bvh", 480, 270, 32, 3, "path", 0.02, 0.05),
    ("config4_arealights_glass", 480, 480, 48, 8, "path", 0.03, 0.08),
]


def validate(fast: bool, only: int | None) -> int:
    from gopbrt_tpu.models.gallery import CONFIGS

    exe = build_exe()
    ncpu = os.cpu_count() or 1
    failures = 0
    for idx, (name, w, h, spp, depth, mode, mtol, rtol) in enumerate(
        VAL_CONFIGS, start=1
    ):
        if only is not None and idx != only:
            continue
        if fast:
            w, h, spp = w // 2, h // 2, max(8, spp // 4)
        scene, camera, settings = CONFIGS[name](w, h)
        from gopbrt_tpu.ops.filters import box_filter

        # radius-0.5 box filter = each sample lands only in its own pixel,
        # exactly what the scalar tracer computes; the default radius-1.0
        # box spreads clipped in-view-emitter energy and dark-silhouette
        # spill differently and is validated separately by the goldens
        settings = settings._replace(
            width=w, height=h, spp=spp, max_depth=depth,
            samples_per_pass=min(4, spp), filter=box_filter(0.5),
        )
        with tempfile.TemporaryDirectory() as td:
            dumpf = os.path.join(td, "scene.txt")
            imgf = os.path.join(td, "img.raw")
            export_scene(scene, camera, dumpf)
            env = dict(os.environ, GOPBRT_BASELINE_DUMP=imgf)
            out = subprocess.run(
                [str(exe), "--scene", dumpf, str(w), str(h), str(spp),
                 str(depth), str(ncpu), mode],
                check=True, capture_output=True, text=True, env=env,
            )
            cpp_stats = json.loads(out.stdout)
            # clip exactly like film.develop does (film.go display range):
            # in-view emitters carry radiance >> 1 and both sides must
            # saturate identically for the region means to be comparable
            cpp_img = np.clip(
                np.fromfile(imgf, np.float32).reshape(h, w, 3), 0.0, 1.0
            )
        jax_img = render_jax(scene, camera, settings)

        m_cpp, m_jax = cpp_img.mean(), jax_img.mean()
        rel_mean = abs(m_cpp - m_jax) / max(m_jax, 1e-6)
        r_cpp, r_jax = region_means(cpp_img), region_means(jax_img)
        # denominator floor at 5% of image mean: near-black sky regions
        # (1e-4-level) otherwise turn MC noise into huge relative errors
        rel_reg = np.abs(r_cpp - r_jax) / np.maximum(r_jax, 0.05 * m_jax)
        ok = bool(rel_mean < mtol and np.all(rel_reg < rtol))
        failures += 0 if ok else 1
        print(json.dumps({
            "config": name, "size": f"{w}x{h}", "spp": spp, "mode": mode,
            "mean_cpp": round(float(m_cpp), 6),
            "mean_jax": round(float(m_jax), 6),
            "rel_mean": round(float(rel_mean), 4),
            "max_rel_region": round(float(rel_reg.max()), 4),
            "tol": [mtol, rtol],
            "cpp_rays_per_s": cpp_stats["rays_per_s"],
            "ok": ok,
        }), flush=True)
    return failures


def mesh_baseline() -> None:
    """Measured scalar baseline for the config-3 workload class: the full
    10,226-prim mesh scene at 960x544 depth-5 (what bench_mesh times on
    the accelerator), single-thread and all-core."""
    from gopbrt_tpu.models.meshes import build_mesh_scene, mesh_camera

    exe = build_exe()
    scene = build_mesh_scene()
    camera = mesh_camera(960, 544)
    with tempfile.TemporaryDirectory() as td:
        dumpf = os.path.join(td, "scene.txt")
        export_scene(scene, camera, dumpf)
        for threads in (1, os.cpu_count() or 1):
            out = subprocess.run(
                [str(exe), "--scene", dumpf, "960", "544", "1", "5",
                 str(threads), "path"],
                check=True, capture_output=True, text=True,
            )
            st = json.loads(out.stdout)
            print(json.dumps({
                "metric": "cpu_mesh10k_rays_per_s_960x544_depth5",
                "threads": threads,
                "rays_per_s": st["rays_per_s"],
                "mean_luminance": st["mean_luminance"],
            }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--config", type=int, default=None)
    ap.add_argument("--mesh-baseline", action="store_true")
    args = ap.parse_args()
    enable_compile_cache()
    if args.mesh_baseline:
        mesh_baseline()
        return
    failures = validate(args.fast, args.config)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
