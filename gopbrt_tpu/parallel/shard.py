"""SPMD rendering over a ``jax.sharding.Mesh``.

Replaces the reference's entire "distributed runtime" — the 16px film
tiles fanned over a channel to 64 goroutines with mutex-merged FilmTiles
(``pkg/pbrt/integrator.go:291-350``, ``pkg/pbrt/film.go:115-132``) — with
SPMD over a device mesh:

  * axis ``data``   shards the *pixel wavefront* (the tile analogue),
  * axis ``sample`` shards spp (independent sample batches per device),
  * the scene/BVH tables are replicated into each device's memory,
  * film accumulation is a single ``psum`` (the mutex analogue),
  * inverse-rendering gradients are psum'd the same way, overlapped with
    the backward sweep by XLA.

The mesh shape follows the algorithm alone: the cards of one host are
joined all to all (NVLink), so no axis order is cheaper than another.

Determinism: the counter-based sampler (ops/rng.py) keys on global pixel
and sample ids, so any mesh shape produces bit-identical sample streams —
the multi-device render equals the 1-device render up to f32 psum
ordering.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gopbrt_tpu.models import camera as cam_mod
from gopbrt_tpu.models import film as film_mod
from gopbrt_tpu.models import render as render_mod
from gopbrt_tpu.models.scene import Scene


def make_mesh(data: int = 0, sample: int = 1, devices=None) -> Mesh:
    """Build a ('data', 'sample') mesh; data=0 -> use all remaining."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data == 0:
        data = n // sample
    assert data * sample == n, f"mesh {data}x{sample} != {n} devices"
    dev_array = np.asarray(devices).reshape(data, sample)
    return Mesh(dev_array, ("data", "sample"))


def render_pass_sharded(
    mesh: Mesh,
    scene: Scene,
    camera: cam_mod.Camera,
    film: film_mod.Film,
    settings: render_mod.RenderSettings,
    sample_base: int,
):
    """One distributed pass: every device renders its pixel-shard for its
    sample-shard, film is psum'd across the whole mesh.

    film is replicated (psum-reduced); pixels shard over 'data'; the
    samples_per_pass spp of this pass shard over 'sample'.
    """
    n_data = mesh.shape["data"]
    spp_here = settings.samples_per_pass
    # each data-shard owns a contiguous band of image rows (the tile
    # decomposition, integrator.go:296-299 — but as an SPMD sharding)
    band_rows = -(-settings.height // n_data)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def step(scene_, camera_, film_):
        local_film = film_mod.Film(
            rgb=jnp.zeros_like(film_.rgb), weight=jnp.zeros_like(film_.weight)
        )
        s_idx = jax.lax.axis_index("sample")
        row0 = (jax.lax.axis_index("data") * band_rows).astype(jnp.int32)
        for s in range(spp_here):
            sample_idx = (
                sample_base.astype(jnp.uint32)
                + (s_idx * spp_here + s).astype(jnp.uint32)
            )
            local_film = render_mod.render_wave_rows(
                scene_, camera_, local_film, settings, row0, band_rows,
                sample_idx,
            )
        rgb = jax.lax.psum(local_film.rgb, ("data", "sample"))
        weight = jax.lax.psum(local_film.weight, ("data", "sample"))
        return film_mod.Film(rgb=rgb, weight=weight)

    delta = step(scene, camera, film)
    return film_mod.merge(film, delta)


def render_pass_sharded_band(
    mesh: Mesh,
    scene: Scene,
    camera: cam_mod.Camera,
    film: film_mod.Film,
    settings: render_mod.RenderSettings,
    sample_base,
):
    """One distributed pass with a BAND-SHARDED film: each device owns only
    its contiguous band of image rows (film height padded to
    n_data x band_rows, rgb/weight sharded P('data') on axis 0).

    Replaces the replicated-film whole-image psum of
    :func:`render_pass_sharded` — the round-2 scaling bottleneck — with the
    minimal communication the filter actually requires:

      * spp reduction: psum over the 'sample' axis of the *band* only,
      * cross-band filter taps (the ceil(radius)-row halo of the dense row
        splat): a single neighbour ``ppermute`` each way.

    Per-pass film traffic per device drops from O(H*W) to
    O(band + 2*rr*W); film HBM footprint per device drops n_data-fold.
    """
    n_data = mesh.shape["data"]
    hp = film.weight.shape[0]
    assert hp % n_data == 0, "film height must be padded to the data axis"
    band_rows = hp // n_data
    rr = int(np.ceil(settings.filter.radius))
    spp_here = settings.samples_per_pass
    band_spec = film_mod.Film(rgb=P("data"), weight=P("data"))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), band_spec),
        out_specs=band_spec,
        check_vma=False,
    )
    def step(scene_, camera_, film_):
        d_idx = jax.lax.axis_index("data")
        s_idx = jax.lax.axis_index("sample")
        row0 = (d_idx * band_rows).astype(jnp.int32)
        w_img = settings.width
        acc_rgb = jnp.zeros((band_rows + 2 * rr, w_img, 3), jnp.float32)
        acc_w = jnp.zeros((band_rows + 2 * rr, w_img), jnp.float32)
        for s in range(spp_here):
            sample_idx = (
                jnp.asarray(sample_base, jnp.uint32)
                + (s_idx * spp_here + s).astype(jnp.uint32)
            )
            jit_, L_ = render_mod.band_jitter_radiance(
                scene_, camera_, settings, row0, band_rows, sample_idx
            )
            r_, w_ = film_mod.splat_band_halo(
                row0, jit_, L_, settings.height, settings.filter
            )
            acc_rgb = acc_rgb + r_
            acc_w = acc_w + w_
        if mesh.shape["sample"] > 1:
            acc_rgb = jax.lax.psum(acc_rgb, "sample")
            acc_w = jax.lax.psum(acc_w, "sample")
        core_rgb = acc_rgb[rr : rr + band_rows]
        core_w = acc_w[rr : rr + band_rows]
        if n_data > 1 and rr > 0:
            # halo exchange: my top rows belong to the previous band, my
            # bottom rows to the next — one ppermute each way
            # (non-circular: edge devices receive zeros)
            fwd = [(i, i + 1) for i in range(n_data - 1)]
            bwd = [(i, i - 1) for i in range(1, n_data)]
            from_prev_rgb = jax.lax.ppermute(acc_rgb[band_rows + rr :], "data", fwd)
            from_prev_w = jax.lax.ppermute(acc_w[band_rows + rr :], "data", fwd)
            from_next_rgb = jax.lax.ppermute(acc_rgb[:rr], "data", bwd)
            from_next_w = jax.lax.ppermute(acc_w[:rr], "data", bwd)
            core_rgb = core_rgb.at[:rr].add(from_prev_rgb)
            core_rgb = core_rgb.at[band_rows - rr :].add(from_next_rgb)
            core_w = core_w.at[:rr].add(from_prev_w)
            core_w = core_w.at[band_rows - rr :].add(from_next_w)
        return film_mod.Film(
            rgb=film_.rgb + core_rgb, weight=film_.weight + core_w
        )

    return step(scene, camera, film)


def new_band_film(mesh: Mesh, settings: render_mod.RenderSettings) -> film_mod.Film:
    """Fresh film padded to the data axis, rows sharded over 'data'."""
    n_data = mesh.shape["data"]
    band_rows = -(-settings.height // n_data)
    film = film_mod.new_film(settings.width, band_rows * n_data)
    sh = NamedSharding(mesh, P("data"))
    return film_mod.Film(
        rgb=jax.device_put(film.rgb, sh), weight=jax.device_put(film.weight, sh)
    )


def render_sharded(
    mesh: Mesh,
    scene: Scene,
    camera: cam_mod.Camera,
    settings: render_mod.RenderSettings,
    band_film: bool = True,
) -> jnp.ndarray:
    """Full distributed render (the multi-device ``Render``).

    band_film=True (default) keeps the film row-sharded per device for the
    whole render (one cross-band halo ppermute per pass) and gathers bands
    only at develop time; False reproduces the round-2 replicated-film psum
    (kept for comparison benchmarks).
    """
    # pin inputs to the mesh's devices: the mesh may live on a different
    # backend than the default (e.g. a virtual-CPU validation mesh while the
    # default backend is a single GPU)
    rep = NamedSharding(mesh, P())
    scene, camera = jax.device_put((scene, camera), rep)
    n_sample = mesh.shape["sample"]
    spp_per_pass = settings.samples_per_pass * n_sample
    n_passes = -(-settings.spp // spp_per_pass)
    if band_film:
        film = new_band_film(mesh, settings)
        fn = jax.jit(render_pass_sharded_band, static_argnames=("mesh", "settings"))
    else:
        film = jax.device_put(
            film_mod.new_film(settings.width, settings.height), rep
        )
        fn = jax.jit(render_pass_sharded, static_argnames=("mesh", "settings"))
    for p in range(n_passes):
        film = fn(mesh, scene, camera, film, settings, jnp.uint32(p * spp_per_pass))
    if band_film:
        # allgather once at develop: crop the padding rows, then resolve
        film = film_mod.Film(
            rgb=film.rgb[: settings.height], weight=film.weight[: settings.height]
        )
    return film_mod.develop(film)


# multi-host bring-up: import-light module so workers can initialize
# BEFORE importing the renderer (which touches the backend at import) —
# re-exported here for the public API
from gopbrt_tpu.parallel.dist import init_distributed  # noqa: E402,F401


# ---------------------------------------------------------------------------
# Differentiable / training step (inverse rendering, BASELINE config 5)
# ---------------------------------------------------------------------------


def make_train_step(
    mesh: Mesh,
    camera: cam_mod.Camera,
    settings: render_mod.RenderSettings,
    param_to_scene,
    optimizer,
):
    """Build a jitted SPMD gradient step for inverse rendering.

    param_to_scene(params) -> Scene splices optimisable leaves (e.g. albedo
    texture values, light intensities) into the scene pytree.  The loss is
    pixel MSE against a target image on each device's pixel shard; gradients
    psum over the mesh — the renderer's analogue of data-parallel training.
    """
    n_data = mesh.shape["data"]
    band_rows = -(-settings.height // n_data)
    # reverse-mode AD cannot unroll the compacted integrator's dynamic
    # while_loop — force the static fori_loop path (identical radiometry)
    settings = settings._replace(compaction=False)

    def local_loss(params, target, row0, s_idx):
        scene = param_to_scene(params)
        film_local = film_mod.new_film(settings.width, settings.height)
        for s in range(settings.samples_per_pass):
            sample_idx = (s_idx * settings.samples_per_pass + s).astype(
                jnp.uint32
            )
            film_local = render_mod.render_wave_rows(
                scene, camera, film_local, settings, row0, band_rows,
                sample_idx,
            )
        rgb = jax.lax.psum(film_local.rgb, ("data", "sample"))
        weight = jax.lax.psum(film_local.weight, ("data", "sample"))
        img = rgb / jnp.maximum(weight[..., None], 1e-8)
        return jnp.mean((img - target) ** 2)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def sharded_grad(params, opt_state, target):
        s_idx = jax.lax.axis_index("sample")
        row0 = (jax.lax.axis_index("data") * band_rows).astype(jnp.int32)
        loss, grads = jax.value_and_grad(local_loss)(params, target, row0, s_idx)
        # Combine per-device partial gradients.  Under shard_map with
        # check_vma=False, the film-psum's transpose re-broadcasts the full
        # cotangent to every device, so a plain psum over-counts by the mesh
        # size — pmean gives exactly the single-device gradient (verified
        # against jax.grad in tests/test_sharding.py).  This all-reduce is
        # the renderer's gradient all-reduce, overlapped with the backward
        # sweep by XLA.
        grads = jax.lax.pmean(grads, ("data", "sample"))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    jitted = jax.jit(sharded_grad)
    rep = NamedSharding(mesh, P())

    def train_step(params, opt_state, target):
        # pin to the mesh's devices (no-op when already there)
        params, opt_state, target = jax.device_put(
            (params, opt_state, target), rep
        )
        return jitted(params, opt_state, target)

    return train_step
