"""Bring-up check of the render service on NVIDIA GPUs.

    python chip_smoke.py               # every phase, on one card
    python chip_smoke.py --four-cards  # the sharded paths on four cards

One card: the golden configs rendered on the card and held to the golden
gates; three requests served in process through ``RenderService.render``
(the ``Render`` RPC's code; plus one loopback RPC when grpc is installed);
three inverse-rendering steps on a one-card mesh, the first gradient
compared with the same step on the CPU; the Triton intersector compiled for
the card and compared with its plain jnp reference on 524,288 rays.

Four cards: ``render_sharded`` on 4x1 and 2x2 ('data', 'sample') meshes
against ``render.render`` on card 0, one request served over the mesh, and
a training step on four cards against one.

Every phase runs in this one process; the first failure ends the run with
a non-zero exit and no result line.  Without a GPU the script exits
non-zero before any phase.  The last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the CPU stays available beside the GPU: the inverse phase compares with it
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "goldens"
OUT_DIR = ROOT / "build" / "chip_smoke"


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu() -> None:
    """Refuse to run anywhere but on a GPU backend."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX backend is {backend!r}")


def device_report() -> None:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({e})"
    import jaxlib

    log("nvidia-smi --query-gpu=name,power.limit:")
    log(smi)
    log(f"jax.devices(): {jax.devices()}")
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_time(fn, *args, iters: int = 10) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def phase_goldens() -> None:
    """Configs 1-4 and the compat_go demo, held to the golden gates."""
    from gopbrt_tpu.models import render as render_mod
    from gopbrt_tpu.models.gallery import (
        CONFIGS, golden_check, golden_config, render_compat_go_demo,
    )

    for name in [*sorted(CONFIGS), "compat_go_demo"]:
        ref = np.load(GOLDEN_DIR / f"{name}.npz")["img"].astype(np.float32)
        t0 = time.perf_counter()
        if name == "compat_go_demo":
            img = render_compat_go_demo()
        else:
            img = np.asarray(render_mod.render(*golden_config(name)))
        mean, within, ok = golden_check(name, img, ref)
        log(f"golden {name}: mean|diff| {mean:.3e}, within gate {within:.5f}, "
            f"{time.perf_counter() - t0:.1f} s")
        check(ok, f"golden {name} outside its gate")


def _check_png(path: str, width: int, height: int) -> np.ndarray:
    from gopbrt_tpu.models.film import decode_png

    img = decode_png(Path(path).read_bytes()).astype(np.float32) / 255.0
    check(img.shape == (height, width, 3),
          f"{path}: {img.shape} != {(height, width, 3)}")
    check(bool(np.isfinite(img).all()), f"{path}: non-finite pixels")
    check(0.0 < img.mean() < 1.0, f"{path}: blank image ({img.mean()})")
    return img


def phase_served(requests=None, out_dir: Path = OUT_DIR) -> None:
    """The Render RPC's code in process: cold and warm time per request."""
    from gopbrt_tpu.service.proto import RenderRequest
    from gopbrt_tpu.service.server import RenderService

    if requests is None:
        requests = [
            ("default 1920x1080 16spp d10", RenderRequest(), 1920, 1080),
            ("cornell 512x512", RenderRequest(scene_id="cornell", width=512,
                                              height=512), 512, 512),
            ("mesh 960x544 d5", RenderRequest(scene_id="mesh", width=960,
                                              height=544, max_depth=5),
             960, 544),
        ]
    svc = RenderService(use_mesh=False, out_dir=str(out_dir))
    for label, req, w, h in requests:
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            resp = svc.render(req, None)
            times.append(time.perf_counter() - t0)
            img = _check_png(resp.path, w, h)
        n_prims = svc._get_scene(req.scene_id or "demo").prims.count
        log(f"served {label} ({n_prims} prims): cold {times[0]:.3f} s, "
            f"warm {times[1]:.3f} s, mean pixel {img.mean():.4f}")
    try:
        import grpc
    except ImportError:
        log("loopback RPC: skipped, grpc is not installed")
        return
    from gopbrt_tpu.service.proto import RenderResponse
    from gopbrt_tpu.service.server import make_server

    label, req, w, h = requests[1]
    server = make_server(port=0, service=svc)
    port = server.add_insecure_port("localhost:0")
    server.start()
    try:
        with grpc.insecure_channel(f"localhost:{port}") as chan:
            stub = chan.unary_unary(
                "/render.Render/Render",
                request_serializer=RenderRequest.SerializeToString,
                response_deserializer=RenderResponse.FromString,
            )
            t0 = time.perf_counter()
            resp = stub(req, timeout=600)
            dt = time.perf_counter() - t0
        _check_png(resp.path, w, h)
    finally:
        server.stop(grace=None)
    log(f"loopback RPC ran: {label} over grpc on localhost:{port}, {dt:.3f} s")


def _inverse_problem(size: int, tex: int, spp_per_step: int):
    """BASELINE config 5: an albedo texture and a lamp's radiance recovered
    from a target image (benchmarks/bench_inverse.py's scene)."""
    import optax

    sys.path.insert(0, str(ROOT / "benchmarks"))
    import bench_inverse as inv

    from gopbrt_tpu.models import film as film_mod
    from gopbrt_tpu.models import render as render_mod

    inv.W = inv.H = size
    yy, xx = np.mgrid[0:tex, 0:tex].astype(np.float32) / (tex - 1)
    true_atlas = np.stack([0.2 + 0.7 * xx, 0.2 + 0.7 * yy,
                           0.9 - 0.6 * xx * yy], -1).astype(np.float32)
    scene, cam = inv.build(true_atlas, (26.0, 22.0, 18.0))
    settings = render_mod.RenderSettings(
        width=size, height=size, spp=spp_per_step, max_depth=3,
        samples_per_pass=spp_per_step, seed=0,
    )
    film = render_mod.render_pass(
        scene, cam, film_mod.new_film(size, size),
        settings._replace(seed=1), jnp.uint32(0),
    )
    target = film.rgb / jnp.maximum(film.weight[..., None], 1e-8)

    def param_to_scene(p):
        tex_ = scene.textures._replace(atlas=jax.nn.sigmoid(p["atlas"]))
        li = scene.lights._replace(intensity=jnp.exp(p["log_radiance"])[None])
        return scene._replace(textures=tex_, lights=li)

    params = {
        "atlas": jnp.zeros((tex, tex, 3), jnp.float32),
        "log_radiance": jnp.log(jnp.full((3,), 10.0, jnp.float32)),
    }

    def keep_grads(inner):
        """inner's updates; the state also carries the last gradient."""
        def init(p):
            return inner.init(p), jax.tree.map(jnp.zeros_like, p)

        def update(g, state, p=None):
            u, s = inner.update(g, state[0], p)
            return u, (s, g)

        return optax.GradientTransformation(init, update)

    return cam, settings, param_to_scene, params, target, keep_grads(
        optax.adam(3e-2)
    )


def _train(devices, problem, steps):
    from gopbrt_tpu.parallel import shard as shard_mod

    cam, settings, param_to_scene, params, target, opt = problem
    # rows over 'data' only: each 'sample' shard would add samples, and so
    # change the estimator the one-card step is compared with
    mesh = shard_mod.make_mesh(data=len(devices), sample=1, devices=devices)
    step = shard_mod.make_train_step(mesh, cam, settings, param_to_scene, opt)
    state = opt.init(params)
    losses, grads = [], None
    for _ in range(steps):
        params, state, loss = step(params, state, target)
        losses.append(float(loss))
        if grads is None:
            grads = jax.tree.map(np.asarray, state[1])
    return losses, grads


def _grad_rel_err(a, b) -> float:
    errs = [np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30)
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))]
    return float(max(errs))


def phase_inverse(size: int = 64, tex: int = 16, spp_per_step: int = 4,
                  steps: int = 3) -> None:
    """Three make_train_step steps on a one-card mesh: the loss falls, and
    the first step's loss and gradient match the CPU's at rtol 1e-3."""
    problem = _inverse_problem(size, tex, spp_per_step)
    t0 = time.perf_counter()
    losses, g_dev = _train(jax.devices()[:1], problem, steps)
    dt = time.perf_counter() - t0
    l_cpu, g_cpu = _train(jax.devices("cpu")[:1], problem, 1)
    rel = _grad_rel_err(g_dev, g_cpu)
    log(f"inverse {size}x{size}, {tex}x{tex} texture: losses {losses} "
        f"({dt:.1f} s with compile); cpu loss {l_cpu[0]}; "
        f"|g - g_cpu| / |g_cpu| = {rel:.2e}")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(all(b < a for a, b in zip(losses, losses[1:])), "loss did not fall")
    check(abs(losses[0] - l_cpu[0]) <= 1e-3 * abs(l_cpu[0]), "loss != cpu")
    check(rel <= 1e-3, "gradient != cpu")


def _kernel_rays(scene, cam, n: int, light):
    """n camera rays from the top of a 1920x1080 frame, secondary rays from
    just short of their hits, shadow rays toward ``light`` (a quarter of
    them dead, as the integrators mark masked lanes)."""
    from gopbrt_tpu.models import camera as cam_mod
    from gopbrt_tpu.models import render as render_mod
    from gopbrt_tpu.ops import intersect as isect

    settings = render_mod.RenderSettings(width=1920, height=1080, spp=1)
    pix = jnp.arange(n, dtype=jnp.uint32)
    p_film, u_lens = render_mod.camera_samples(
        settings, pix, jnp.zeros_like(pix), jnp.uint32(0))
    o, d = cam_mod.generate_rays(cam, p_film, u_lens)
    t_inf = jnp.full((n,), 1e30, jnp.float32)
    hit, t, _ = jax.jit(isect.intersect_brute)(scene.prims, o, d, t_inf)
    o2 = jnp.where(hit[:, None], o + d * (0.999 * t)[:, None], o)
    d2 = jax.random.normal(jax.random.PRNGKey(0), (n, 3))
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    ds = jnp.asarray(light, jnp.float32) - o2
    dist = jnp.linalg.norm(ds, axis=-1)
    t_sh = jnp.where(jnp.arange(n) % 4 == 0, 1e-4, 0.999 * dist)
    return {"camera": (o, d, t_inf), "secondary": (o2, d2, t_inf)}, (
        o2, ds / dist[:, None], t_sh)


def phase_kernel(n: int = 524_288) -> None:
    """The Triton intersector compiled for the card against the plain jnp
    version: hit masks agree on >= 99.99% of lanes; where both hit, t
    agrees to 1e-4 relative and prim_idx is equal."""
    from gopbrt_tpu.models import gallery
    from gopbrt_tpu.models.demo import build_demo_camera, build_demo_scene
    from gopbrt_tpu.ops import intersect as isect
    from gopbrt_tpu.ops import pallas_intersect as pk

    plain = jax.jit(isect.intersect_brute)
    plain_p = jax.jit(isect.intersect_p_brute)
    cases = {
        "demo": (build_demo_scene(accelerator="none"),
                 build_demo_camera(1920, 1080), (50.0, 20.0, 50.0)),
        "config4": (*gallery.config4(1920, 1080)[:2], (-2.5, 4.0, 2.0)),
    }
    for name, (scene, cam, light) in cases.items():
        prims = scene.prims
        closest, shadow = _kernel_rays(scene, cam, n, light)
        for kind, rays in closest.items():
            bh, bt, bi = map(np.asarray, plain(prims, *rays))
            kh, kt, ki = map(np.asarray, pk.intersect_brute_pallas(prims, *rays))
            both = bh & kh
            rel = np.abs(kt[both] - bt[both]) / np.maximum(np.abs(bt[both]), 1e-6)
            agree = float((bh == kh).mean())
            t_k = median_time(pk.intersect_brute_pallas, prims, *rays)
            t_p = median_time(plain, prims, *rays)
            log(f"kernel closest-hit {name}/{kind} ({prims.count} prims, "
                f"{n} rays): hit agree {agree:.6f}, hit rate {bh.mean():.4f}, "
                f"max rel dt {rel.max(initial=0.0):.2e}; median "
                f"kernel {t_k * 1e3:.3f} ms, plain {t_p * 1e3:.3f} ms")
            check(agree >= 0.9999, "hit masks disagree")
            check(bool((rel <= 1e-4).all()), "t disagrees")
            check(bool((bi[both] == ki[both]).all()), "prim_idx disagrees")
        bp = np.asarray(plain_p(prims, *shadow))
        kp = np.asarray(pk.intersect_p_brute_pallas(prims, *shadow))
        agree = float((bp == kp).mean())
        t_k = median_time(pk.intersect_p_brute_pallas, prims, *shadow)
        t_p = median_time(plain_p, prims, *shadow)
        log(f"kernel any-hit {name}/shadow: agree {agree:.6f}, occluded "
            f"{bp.mean():.4f}; median kernel {t_k * 1e3:.3f} ms, "
            f"plain {t_p * 1e3:.3f} ms")
        check(agree >= 0.9999, "occlusion disagrees")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four_render(width: int = 1920, height: int = 1080, spp: int = 16,
                      devices=None) -> None:
    """render_sharded on 4x1 and 2x2 meshes against render.render on card 0:
    the sample streams are identical, only psum's order of sums differs."""
    from gopbrt_tpu.models import render as render_mod
    from gopbrt_tpu.models.demo import (
        build_demo_camera, build_demo_scene, demo_settings,
    )
    from gopbrt_tpu.parallel import shard as shard_mod

    devices = devices or jax.devices()[:4]
    scene = build_demo_scene()
    cam = build_demo_camera(width, height)
    settings = demo_settings(width=width, height=height, spp=spp)
    t0 = time.perf_counter()
    ref = np.asarray(render_mod.render(
        *jax.device_put((scene, cam), devices[0]), settings))
    log(f"render on one card: {time.perf_counter() - t0:.2f} s with compile")
    for data, sample in [(4, 1), (2, 2)]:
        mesh = shard_mod.make_mesh(data=data, sample=sample, devices=devices)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            img = np.asarray(
                shard_mod.render_sharded(mesh, scene, cam, settings))
            times.append(time.perf_counter() - t0)
        diff = np.abs(img - ref)
        mean, within = float(diff.mean()), float((diff < 5e-3).mean())
        log(f"render_sharded {data}x{sample}: cold {times[0]:.2f} s, warm "
            f"{times[1]:.2f} s; mean|diff| {mean:.3e}, within 5e-3 "
            f"{within:.5f}")
        check(mean <= 1e-4 and within >= 0.995,
              f"sharded {data}x{sample} != one card")


def phase_four_served(width: int = 1920, height: int = 1080,
                      out_dir: Path = OUT_DIR) -> None:
    from gopbrt_tpu.service.proto import RenderRequest
    from gopbrt_tpu.service.server import RenderService

    svc = RenderService(use_mesh=True, out_dir=str(out_dir))
    req = RenderRequest(width=width, height=height)
    t0 = time.perf_counter()
    resp = svc.render(req, None)
    dt = time.perf_counter() - t0
    img = _check_png(resp.path, width, height)
    log(f"served over the {len(jax.devices())}-card mesh: {width}x{height} "
        f"16spp d10, {dt:.2f} s with compile, mean pixel {img.mean():.4f}")


def phase_four_train(size: int = 64, tex: int = 16, spp_per_step: int = 4,
                     devices=None) -> None:
    devices = devices or jax.devices()[:4]
    problem = _inverse_problem(size, tex, spp_per_step)
    l4, g4 = _train(devices, problem, 1)
    l1, g1 = _train(devices[:1], problem, 1)
    rel = _grad_rel_err(g4, g1)
    log(f"train step, four cards vs one: loss {l4[0]} vs {l1[0]}; "
        f"|g4 - g1| / |g1| = {rel:.2e}")
    check(abs(l4[0] - l1[0]) <= 1e-3 * abs(l1[0]), "loss differs")
    check(rel <= 1e-3, "gradient differs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the sharded paths on four cards, and only them")
    args = ap.parse_args(argv)

    from gopbrt_tpu.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    device_report()
    require_gpu()
    need = 4 if args.four_cards else 1
    check(len(jax.devices()) >= need,
          f"needs {need} GPUs, found {len(jax.devices())}")
    phases = (
        [phase_four_render, phase_four_served, phase_four_train]
        if args.four_cards
        else [phase_goldens, phase_served, phase_inverse, phase_kernel]
    )
    for phase in phases:
        t0 = time.perf_counter()
        log(f"--- {phase.__name__}")
        phase()
        log(f"--- {phase.__name__} ok ({time.perf_counter() - t0:.1f} s)")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
