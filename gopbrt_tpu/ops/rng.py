"""Stateless, counter-based random number generation.

Replaces the reference's mutable PCG32 RNG + Sampler object tree
(``pkg/pbrt/rng.go``, ``pkg/sampler/``) with pure functions of a
``(seed, pixel, sample-index, dimension)`` counter tuple.  The reference
achieves per-tile determinism by ``sampler.Clone(tileIndex)`` seeding
(``pkg/pbrt/integrator.go:318,328``); here determinism is per *pixel-sample*
and independent of device count, sharding, or execution order — renders are
bit-reproducible across 1-device and N-device runs and across batch
splits.

Design: every random dimension consumed along a path has a statically
assigned dimension index (camera jitter = dims 0-4, then a fixed stride of
dims per bounce — see models/integrators.py).  The generator is a chained
32-bit finalizer hash over (seed, pixel, sample, dim).  This is the
wavefront-renderer analogue of PBRT's dimension-indexed samplers and is
cheap enough to inline in a kernel (a few integer ops per sample).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gopbrt_tpu.ops.geom import ONE_MINUS_EPSILON

_GOLDEN = jnp.uint32(0x9E3779B9)

# ---------------------------------------------------------------------------
# Sampling-dimension layout (the static dimension assignment described in the
# module docstring).  Lives here, beside the generator, so that any consumer
# draws the *same* streams as the jnp integrator chain; integrators
# re-exports these names.
# dims 0-4: camera (pixel jitter x2, lens x2, time); then a fixed
# stride of dimensions per bounce.
# ---------------------------------------------------------------------------
DIM_CAMERA = 0
DIMS_PER_BOUNCE = 16
DIM_BOUNCE_BASE = 5
# within a bounce:
D_LIGHT_PICK = 0
D_LIGHT_UV = 1  # +2
D_BSDF_UV = 3  # +2
D_BSDF_LOBE = 5
D_RR = 6
D_SSS = 7  # +4: entry Fresnel, probe axis, channel+radius, azimuth
D_MEDIUM = 11  # +2: channel pick, distance
D_PHASE = 13  # +2: HG cos-theta, azimuth
# sample-all-lights strategy (UniformSampleAllLights, integrator.go:23-46):
# per-light 2D samples live in a disjoint dimension region so they can
# never collide with the 16-dim per-bounce stride above.  The dim for
# (bounce dim_base, light l) is DIM_ALL_LIGHT_BASE + dim_base*64 + 2*l.
DIM_ALL_LIGHT_BASE = 0x10000


def hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    """High-quality 32-bit finalizer (lowbias32). Pure, vectorised."""
    x = jnp.asarray(x).astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_combine(h: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    h = jnp.asarray(h).astype(jnp.uint32)
    v = jnp.asarray(v).astype(jnp.uint32)
    return hash_u32(h ^ (v + _GOLDEN + (h << 6) + (h >> 2)))


def stream_u32(seed, pixel, sample, dim) -> jnp.ndarray:
    """The core counter-based stream: uint32 of (seed, pixel, sample, dim).

    All arguments broadcast; any may be traced (e.g. dim = bounce * stride).
    """
    h = hash_combine(jnp.uint32(seed) if isinstance(seed, int) else seed, pixel)
    h = hash_combine(h, sample)
    h = hash_combine(h, dim)
    return h


def u32_to_unit(x: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> f32 in [0, 1): top 23 bits become the mantissa of a float
    in [1, 2), minus 1.  Exactly uniform over {k*2^-23}; max value is
    exactly ONE_MINUS_EPSILON; and it is pure bit arithmetic, so every
    backend produces bit-identical streams (the goldens depend on it).
    """
    bits = jnp.uint32(0x3F800000) | (x >> jnp.uint32(9))
    return jax.lax.bitcast_convert_type(bits, jnp.float32) - 1.0


def sample_1d(seed, pixel, sample, dim) -> jnp.ndarray:
    """u in [0,1). Counterpart of Sampler.Get1D (pkg/pbrt/sampler.go:11)."""
    return u32_to_unit(stream_u32(seed, pixel, sample, dim))


def sample_2d(seed, pixel, sample, dim) -> jnp.ndarray:
    """(..., 2) point in [0,1)². Counterpart of Sampler.Get2D.

    Consumes dimensions dim and dim+1.
    """
    u = sample_1d(seed, pixel, sample, dim)
    v = sample_1d(seed, pixel, sample, jnp.asarray(dim) + 1)
    return jnp.stack([u, v], axis=-1)


def stratified_1d(seed, pixel, sample, dim, n_strata, jitter: bool = True):
    """Stratified 1D: sample index s lands in stratum s (mod n).

    Fixes reference quirk #6 (StratifiedSample2D writes X twice,
    ``pkg/pbrt/sampling.go:122-124``, losing stratification) by construction.
    """
    s = jnp.asarray(sample).astype(jnp.uint32) % jnp.uint32(n_strata)
    j = sample_1d(seed, pixel, sample, dim) if jitter else 0.5
    return jnp.minimum(
        (s.astype(jnp.float32) + j) / n_strata, jnp.float32(ONE_MINUS_EPSILON)
    )


def stratified_2d(seed, pixel, sample, dim, nx, ny, jitter: bool = True):
    """Stratified 2D over an nx*ny grid; spp index picks the stratum.

    Counterpart of the *intended* StratifiedSample2D (sampling.go:115-127).
    Consumes dimensions dim and dim+1.
    """
    s = jnp.asarray(sample).astype(jnp.uint32) % jnp.uint32(nx * ny)
    sx = (s % jnp.uint32(nx)).astype(jnp.float32)
    sy = (s // jnp.uint32(nx)).astype(jnp.float32)
    if jitter:
        jx = sample_1d(seed, pixel, sample, dim)
        jy = sample_1d(seed, pixel, sample, jnp.asarray(dim) + 1)
    else:
        jx = jy = 0.5
    u = jnp.minimum((sx + jx) / nx, jnp.float32(ONE_MINUS_EPSILON))
    v = jnp.minimum((sy + jy) / ny, jnp.float32(ONE_MINUS_EPSILON))
    return jnp.stack([u, v], axis=-1)
