"""Reconstruction filters.

Counterpart of ``pkg/pbrt/filter.go`` (interface + BoxFilter, the only
concrete filter in the reference) — extended to the full PBRT filter set
(triangle, gaussian, Mitchell–Netravali, Lanczos–sinc) since the film
splat kernel is generic over the filter weight function.

Weights are evaluated analytically per splat tap instead of the reference's
16x16 precomputed table (film.go:61-73): the few transcendental ops fuse
into the splat, where a table would need a gather per tap.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

FILTER_BOX = 0
FILTER_TRIANGLE = 1
FILTER_GAUSSIAN = 2
FILTER_MITCHELL = 3
FILTER_LANCZOS = 4


class Filter(NamedTuple):
    kind: int  # static python int — selects the weight fn at trace time
    radius: float  # static: determines the splat footprint
    alpha: float = 2.0  # gaussian falloff / lanczos tau
    b: float = 1.0 / 3.0  # mitchell B
    c: float = 1.0 / 3.0  # mitchell C


def box_filter(radius: float = 0.5) -> Filter:
    """BoxFilter (filter.go:20-32).  Note the reference demo uses radius
    (1,1) (server.go:139) — wider than a pixel."""
    return Filter(FILTER_BOX, radius)


def triangle_filter(radius: float = 2.0) -> Filter:
    return Filter(FILTER_TRIANGLE, radius)


def gaussian_filter(radius: float = 2.0, alpha: float = 2.0) -> Filter:
    return Filter(FILTER_GAUSSIAN, radius, alpha=alpha)


def mitchell_filter(radius: float = 2.0, b: float = 1 / 3, c: float = 1 / 3) -> Filter:
    return Filter(FILTER_MITCHELL, radius, b=b, c=c)


def lanczos_filter(radius: float = 4.0, tau: float = 3.0) -> Filter:
    return Filter(FILTER_LANCZOS, radius, alpha=tau)


def _mitchell_1d(x, b, c):
    """Mitchell–Netravali piecewise cubic over |2x| (PBRT 7.1.4)."""
    x = jnp.abs(2.0 * x)
    p1 = ((12 - 9 * b - 6 * c) * x**3 + (-18 + 12 * b + 6 * c) * x**2
          + (6 - 2 * b)) * (1.0 / 6.0)
    p2 = ((-b - 6 * c) * x**3 + (6 * b + 30 * c) * x**2
          + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) * (1.0 / 6.0)
    return jnp.where(x < 1.0, p1, jnp.where(x < 2.0, p2, 0.0))


def _sinc(x):
    x = jnp.abs(x)
    return jnp.where(x < 1e-5, 1.0, jnp.sin(math.pi * x) / (math.pi * x + 1e-20))


def evaluate(f: Filter, dx: jnp.ndarray, dy: jnp.ndarray) -> jnp.ndarray:
    """Filter weight at offset (dx, dy) from the sample; 0 outside support."""
    r = f.radius
    inside = (jnp.abs(dx) <= r) & (jnp.abs(dy) <= r)
    if f.kind == FILTER_BOX:
        w = jnp.ones_like(dx)
    elif f.kind == FILTER_TRIANGLE:
        w = jnp.maximum(0.0, r - jnp.abs(dx)) * jnp.maximum(0.0, r - jnp.abs(dy))
    elif f.kind == FILTER_GAUSSIAN:
        expv = math.exp(-f.alpha * r * r)
        gx = jnp.maximum(0.0, jnp.exp(-f.alpha * dx * dx) - expv)
        gy = jnp.maximum(0.0, jnp.exp(-f.alpha * dy * dy) - expv)
        w = gx * gy
    elif f.kind == FILTER_MITCHELL:
        w = _mitchell_1d(dx / r, f.b, f.c) * _mitchell_1d(dy / r, f.b, f.c)
    else:  # lanczos
        tau = f.alpha
        wx = _sinc(dx) * _sinc(dx / tau)
        wy = _sinc(dy) * _sinc(dy / tau)
        w = wx * wy
    return jnp.where(inside, w, 0.0)
