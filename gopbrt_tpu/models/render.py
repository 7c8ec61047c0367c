"""Render driver: the wavefront replacement for the tile/goroutine pool.

The reference's ``Render`` (``pkg/pbrt/integrator.go:291-350``) splits the
film into 16px tiles, fans them out over a channel to 64 goroutines, and
merges FilmTiles under a mutex.  Here a "tile" is the whole wavefront: one
jit-compiled step renders every pixel's s-th sample in a single fused
program (raygen -> bounce loop -> film scatter), and the host loop over
sample batches is the only orchestration.  Multi-device sharding of the
pixel axis lives in parallel/shard.py.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from gopbrt_tpu.models import camera as cam_mod
from gopbrt_tpu.models import film as film_mod
from gopbrt_tpu.models import integrators
from gopbrt_tpu.models.scene import Scene
from gopbrt_tpu.ops import rng
from gopbrt_tpu.ops.filters import Filter, box_filter


class RenderSettings(NamedTuple):
    """Static render configuration (the knobs hardcoded in server.go:136-164)."""

    width: int = 256
    height: int = 256
    spp: int = 16
    max_depth: int = 5
    rr_threshold: float = 1.0
    seed: int = 0
    integrator: str = "path"  # or "direct"
    # NEE light strategy for the direct integrator: "one" =
    # UniformSampleOneLight; "all" = UniformSampleAll — every light sampled
    # at every vertex (directlighting.go:10-15, integrator.go:23-46)
    light_strategy: str = "one"
    stratify: bool = True  # stratified pixel jitter (NewStratified, server.go:142)
    # pixel-sample pattern: "stratified" (default; NewStratified semantics),
    # "random" (sampler/random.go), or "halton" — scrambled Halton(2,3) with
    # per-pixel Cranley-Patterson rotation (the reference ships the radical-
    # inverse tables, lowdiscrepancy.go:210-244, but never built the sampler)
    sampler: str = "stratified"
    filter: Filter = box_filter(1.0)
    samples_per_pass: int = 1  # spp folded into one device launch
    # wavefront compaction in the path integrator (see PathConfig): off by
    # default; its dynamic-trip-count loops are not reverse-mode
    # differentiable.
    compaction: bool = False
    # filtered texture lookups from a per-ray cone footprint (the
    # wavefront ComputeDifferentials, camera.pixel_spread): anti-aliases
    # procedural textures (checker closed-form box filter).  The footprint
    # is scaled by 1/sqrt(spp) — ScaleDifferentials (integrator.go:246-247)
    texture_aa: bool = True
    # crop window ((x0, y0), (x1, y1)) in NDC fractions of the film — the
    # reference's Film crop (film.go:42-59 CroppedPixelBounds): only pixels
    # inside the crop are sampled and stored.  None = full film.
    crop: Optional[tuple] = None
    # wavefront chunk: pixels per launch segment inside a pass.  Bounds the
    # peak HBM footprint of the bounce loop's carried state (the analogue of
    # the reference's 16px tiles, integrator.go:297-299 — but chunked for
    # memory, not for parallelism).  0 = whole image in one wavefront.
    chunk_pixels: int = 1 << 19


def camera_samples(settings: RenderSettings, pixel_idx, sample_idx, seed):
    """CameraSample generation (Sampler.GetCameraSample, sampler.go:19-25):
    stratified-jittered film position + lens + time from counter streams."""
    w = settings.width
    px = (pixel_idx % jnp.uint32(w)).astype(jnp.float32)
    py = (pixel_idx // jnp.uint32(w)).astype(jnp.float32)
    mode = settings.sampler if settings.stratify else "random"
    if mode == "halton":
        from gopbrt_tpu.ops import sampling

        # Halton (2,3) over the sample index, decorrelated across pixels by
        # Cranley–Patterson rotation from the pixel's hash stream
        h0 = sampling.radical_inverse_base2(sample_idx)
        h1 = sampling.radical_inverse(1, sample_idx)
        r = rng.sample_2d(seed, pixel_idx, jnp.uint32(0), integrators.DIM_CAMERA)
        jitter = jnp.stack(
            [jnp.mod(h0 + r[..., 0], 1.0), jnp.mod(h1 + r[..., 1], 1.0)],
            axis=-1,
        )
    elif mode == "stratified":
        # stratify over a near-square spp grid
        nx = int(np.floor(np.sqrt(settings.spp))) or 1
        ny = max(settings.spp // nx, 1)
        jitter = rng.stratified_2d(
            seed, pixel_idx, sample_idx, integrators.DIM_CAMERA, nx, ny
        )
    else:
        jitter = rng.sample_2d(seed, pixel_idx, sample_idx, integrators.DIM_CAMERA)
    p_film = jnp.stack([px, py], axis=-1) + jitter
    u_lens = rng.sample_2d(seed, pixel_idx, sample_idx, integrators.DIM_CAMERA + 2)
    return p_film, u_lens


def camera_time(camera: cam_mod.Camera, pixel_idx, sample_idx, seed):
    """Per-ray shutter time (CameraSample.Time, sampler.go:19-25): uniform
    in [shutter_open, shutter_close], from the 5th camera dimension."""
    u_t = rng.sample_1d(seed, pixel_idx, sample_idx, integrators.DIM_CAMERA + 4)
    return camera.shutter_open + u_t * (camera.shutter_close - camera.shutter_open)



def _cone(scene: Scene, camera, settings: RenderSettings):
    if not settings.texture_aa:
        return None
    w0, spread = cam_mod.pixel_spread(camera)
    s = 1.0 / float(np.sqrt(max(settings.spp, 1)))
    return (w0 * s, spread * s)

def render_wave(
    scene: Scene,
    camera: cam_mod.Camera,
    film: film_mod.Film,
    settings: RenderSettings,
    pixel_idx: jnp.ndarray,
    sample_idx: jnp.ndarray,
) -> film_mod.Film:
    """Render one wavefront (each lane = one pixel-sample) into the film.

    Jit-friendly: all shapes static, scene/camera/film are traced pytrees.
    """
    seed = jnp.uint32(settings.seed)
    p_film, u_lens = camera_samples(settings, pixel_idx, sample_idx, seed)
    o, d = cam_mod.generate_rays(camera, p_film, u_lens)
    time = (
        camera_time(camera, pixel_idx, sample_idx, seed)
        if scene.prims.anim is not None else None
    )
    if settings.integrator == "direct":
        L = integrators.li_direct(
            scene, o, d, pixel_idx, sample_idx, seed,
            max_depth=settings.max_depth, time=time,
            cone=_cone(scene, camera, settings),
            light_strategy=settings.light_strategy,
        )
    else:
        cfg = integrators.PathConfig(
            max_depth=settings.max_depth, rr_threshold=settings.rr_threshold,
            compaction=settings.compaction,
        )
        L = integrators.li(
            scene, o, d, pixel_idx, sample_idx, seed, cfg, time=time,
            cone=_cone(scene, camera, settings),
        )
    return film_mod.add_samples(film, p_film, L, settings.filter)


def band_jitter_radiance(
    scene: Scene,
    camera: cam_mod.Camera,
    settings: RenderSettings,
    row0: jnp.ndarray,
    n_rows: int,
    sample_idx: jnp.ndarray,
):
    """Trace one sample for every pixel of a contiguous band of image rows;
    returns (jitter f32[rows,W,2], L f32[rows,W,3]) ready for a dense row
    splat.  Shared by the single-device chunked driver and the band-sharded
    SPMD renderer.
    """
    w = settings.width
    seed = jnp.uint32(settings.seed)
    y = row0.astype(jnp.uint32) + jnp.arange(n_rows, dtype=jnp.uint32)[:, None]
    x = jnp.arange(w, dtype=jnp.uint32)[None, :]
    pixel_idx = (y * jnp.uint32(w) + x).reshape(-1)
    sample_flat = jnp.broadcast_to(sample_idx.astype(jnp.uint32), pixel_idx.shape)
    p_film, u_lens = camera_samples(settings, pixel_idx, sample_flat, seed)
    # jitter relative to the pixel corner (camera_samples adds it to px,py)
    px = (pixel_idx % jnp.uint32(w)).astype(jnp.float32)
    py = (pixel_idx // jnp.uint32(w)).astype(jnp.float32)
    jitter = p_film - jnp.stack([px, py], axis=-1)
    o, d = cam_mod.generate_rays(camera, p_film, u_lens)
    time = (
        camera_time(camera, pixel_idx, sample_flat, seed)
        if scene.prims.anim is not None else None
    )
    if settings.integrator == "direct":
        L = integrators.li_direct(
            scene, o, d, pixel_idx, sample_flat, seed,
            max_depth=settings.max_depth, time=time,
            cone=_cone(scene, camera, settings),
            light_strategy=settings.light_strategy,
        )
    else:
        cfg = integrators.PathConfig(
            max_depth=settings.max_depth, rr_threshold=settings.rr_threshold,
            compaction=settings.compaction,
        )
        L = integrators.li(
            scene, o, d, pixel_idx, sample_flat, seed, cfg, time=time,
            cone=_cone(scene, camera, settings),
        )
    return jitter.reshape(n_rows, w, 2), L.reshape(n_rows, w, 3)


def render_wave_rows(
    scene: Scene,
    camera: cam_mod.Camera,
    film: film_mod.Film,
    settings: RenderSettings,
    row0: jnp.ndarray,
    n_rows: int,
    sample_idx: jnp.ndarray,
) -> film_mod.Film:
    """Render a contiguous band of ``n_rows`` image rows (one sample per
    pixel) and splat with the dense row-aligned path — the fast layout used
    by the chunked driver and the sharded renderer.  Rows beyond the image
    (last band) render junk that the splat's pad margin discards.
    """
    jitter, L = band_jitter_radiance(
        scene, camera, settings, row0, n_rows, sample_idx
    )
    return film_mod.add_samples_rows(film, row0, jitter, L, settings.filter)


@partial(jax.jit, static_argnames=("settings",))
def render_pass(
    scene: Scene,
    camera: cam_mod.Camera,
    film: film_mod.Film,
    settings: RenderSettings,
    sample_base: jnp.ndarray,
) -> film_mod.Film:
    """One full-image pass: samples_per_pass spp, chunked over row bands.

    Bands iterate under ``lax.scan`` so the band body is compiled once
    regardless of image size (compile time is part of a cold request).
    """
    w, h = settings.width, settings.height
    chunk = settings.chunk_pixels or (w * h)
    band_rows = max(1, min(chunk // w, h))
    n_bands = -(-h // band_rows)

    def band_body(film, r0):
        for s in range(settings.samples_per_pass):
            film = render_wave_rows(
                scene, camera, film, settings, r0, band_rows,
                sample_base.astype(jnp.uint32) + jnp.uint32(s),
            )
        return film, None

    if n_bands == 1:
        film, _ = band_body(film, jnp.int32(0))
        return film
    starts = (jnp.arange(n_bands) * band_rows).astype(jnp.int32)
    film, _ = jax.lax.scan(band_body, film, starts)
    return film


def crop_pixel_bounds(settings: RenderSettings):
    """CroppedPixelBounds (film.go:53-59): ceil/ceil bounds of the crop."""
    (cx0, cy0), (cx1, cy1) = settings.crop
    w, h = settings.width, settings.height
    x0 = int(np.ceil(w * cx0))
    x1 = min(int(np.ceil(w * cx1)), w)
    y0 = int(np.ceil(h * cy0))
    y1 = min(int(np.ceil(h * cy1)), h)
    assert x1 > x0 and y1 > y0, "empty crop window"
    return x0, x1, y0, y1


@partial(jax.jit, static_argnames=("settings",))
def _render_pass_crop(
    scene: Scene,
    camera: cam_mod.Camera,
    film: film_mod.Film,
    settings: RenderSettings,
    sample_base: jnp.ndarray,
) -> film_mod.Film:
    """One pass over the crop window only (scatter splat; out-of-crop taps
    drop).  Pixel ids stay GLOBAL, so a crop render is bit-consistent with
    the same region of the full render (same counter streams)."""
    x0, x1, y0, y1 = crop_pixel_bounds(settings)
    w = settings.width
    xs = jnp.arange(x0, x1, dtype=jnp.uint32)[None, :]
    ys = jnp.arange(y0, y1, dtype=jnp.uint32)[:, None]
    pixel_idx = (ys * jnp.uint32(w) + xs).reshape(-1)
    for s in range(settings.samples_per_pass):
        sample_idx = jnp.broadcast_to(
            sample_base.astype(jnp.uint32) + jnp.uint32(s), pixel_idx.shape
        )
        film = render_wave(scene, camera, film, settings, pixel_idx, sample_idx)
    return film


def render(
    scene: Scene,
    camera: cam_mod.Camera,
    settings: RenderSettings,
    progress: Optional[Callable[[int, int], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
) -> jnp.ndarray:
    """Full render: host loop over sample passes (the only Python loop).

    Returns the developed image f32[H,W,3] in [0,1] (normalized + sRGB).
    Counterpart of the whole Render->WriteImage pipeline
    (integrator.go:291-350), minus PNG encoding (models/film.write_png).

    checkpoint_path: when set, the accumulated film + pass counter are saved
    atomically every ``checkpoint_every`` passes and the render *resumes*
    from an existing checkpoint (the reference has no checkpointing — a
    render runs to completion or is cancelled, SURVEY §5; a pass is the
    natural device-side checkpoint unit).
    """
    film = film_mod.new_film(settings.width, settings.height)
    n_passes = -(-settings.spp // settings.samples_per_pass)
    start_pass = 0
    if checkpoint_path is not None:
        ck = _load_checkpoint(checkpoint_path, settings)
        if ck is not None:
            film, start_pass = ck
    pass_fn = render_pass if settings.crop is None else _render_pass_crop
    for p in range(start_pass, n_passes):
        film = pass_fn(
            scene, camera, film, settings, jnp.uint32(p * settings.samples_per_pass)
        )
        if checkpoint_path is not None and (
            (p + 1) % max(checkpoint_every, 1) == 0 or p + 1 == n_passes
        ):
            jax.block_until_ready(film)
            _save_checkpoint(checkpoint_path, settings, film, p + 1)
        if progress is not None:
            jax.block_until_ready(film)
            progress(p + 1, n_passes)
    img = film_mod.develop(film)
    if settings.crop is not None:
        x0, x1, y0, y1 = crop_pixel_bounds(settings)
        img = img[y0:y1, x0:x1]
    return img


def _checkpoint_key(settings: RenderSettings) -> str:
    """Settings fingerprint: a checkpoint only resumes an identical render."""
    return repr((settings.width, settings.height, settings.spp,
                 settings.max_depth, settings.seed, settings.integrator,
                 settings.sampler, settings.samples_per_pass))


def _save_checkpoint(path: str, settings: RenderSettings, film, next_pass: int):
    import os

    tmp = path + ".tmp"
    np.savez(
        tmp if tmp.endswith(".npz") else tmp,
        rgb=np.asarray(film.rgb),
        weight=np.asarray(film.weight),
        next_pass=np.int64(next_pass),
        key=np.array(_checkpoint_key(settings)),
    )
    # np.savez appends .npz to names without it
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def _load_checkpoint(path: str, settings: RenderSettings):
    import os

    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["key"]) != _checkpoint_key(settings):
                return None
            film = film_mod.Film(
                rgb=jnp.asarray(z["rgb"]), weight=jnp.asarray(z["weight"])
            )
            return film, int(z["next_pass"])
    except Exception:
        return None
