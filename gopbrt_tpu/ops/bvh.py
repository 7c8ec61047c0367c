"""BVH: host-side SAH build -> flat arrays; device lockstep traversal.

Counterpart of ``pkg/accelerator/bvh.go``: the reference builds with
recursive SAH (12 buckets, bvh.go:272-411) or HLBVH (Morton + treelets,
:413-630) and traverses a flattened depth-first ``LinearBVHNode`` array with
an explicit 64-deep stack (:659-765).

Wavefront re-design:
  * Build runs **on the host in NumPy at scene-load time** (the reference
    builds on the serving path too, server.go:104).  Binned SAH, iterative
    with an explicit stack — no recursion limits.  Output is the same
    linearised node layout (bvh.go:80-87,632-651) as SoA arrays uploaded
    once to device memory.
  * Traversal is a *lockstep wavefront*: every ray keeps its own stack in
    a [N, DEPTH] register array and all rays advance one node per
    ``lax.while_loop`` iteration with masking.  Divergence costs the max
    iteration count over the batch — acceptable for coherent camera/shadow
    wavefronts, and the sort-by-direction optimisation can be layered on.
  * Leaves hold up to MAX_LEAF prims; leaf tests unroll statically.

An LBVH/Morton GPU-style build (jax.lax.sort on device) is the planned
upgrade for animated scenes; static scenes build once so host SAH wins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from gopbrt_tpu.ops import geom
from gopbrt_tpu.ops import intersect as isect

MAX_LEAF = 4
STACK_DEPTH = 64
N_BUCKETS = 12


class LinearBVH(NamedTuple):
    """Flattened depth-first BVH (LinearBVHNode, bvh.go:80-87) as SoA."""

    node_lo: jnp.ndarray  # f32[Nn,3]
    node_hi: jnp.ndarray  # f32[Nn,3]
    node_right: jnp.ndarray  # int32[Nn] second-child index (interior), -1 leaf
    node_first: jnp.ndarray  # int32[Nn] first ordered-prim index (leaf)
    node_count: jnp.ndarray  # int32[Nn] prim count (leaf), 0 interior
    node_axis: jnp.ndarray  # int32[Nn] split axis (interior)
    prim_order: jnp.ndarray  # int32[P] ordered primitive ids


def _prim_bounds_np(builder) -> tuple[np.ndarray, np.ndarray]:
    los, his = zip(
        *[builder._prim_world_bounds(i) for i in range(len(builder._prim_type))]
    )
    return np.asarray(los, np.float32), np.asarray(his, np.float32)


def build_bvh_host(builder, backend: str = "auto", method: str = "sah") -> LinearBVH:
    """Binned-SAH build (bvh.go:272-411 semantics, iterative re-design)."""
    lo, hi = _prim_bounds_np(builder)
    return build_from_bounds(lo, hi, backend=backend, method=method)


def build_from_bounds(
    lo: np.ndarray, hi: np.ndarray, backend: str = "auto", method: str = "sah"
) -> LinearBVH:
    """Build the flat BVH.  backend: "auto" prefers the native C++
    multithreaded builder (gopbrt_tpu/native, the counterpart of the
    reference's goroutine-parallel build, bvh.go:454-483) and falls back to
    NumPy; "numpy"/"native" force one.  method: "sah" or "hlbvh"
    (native backend only; NumPy builder is SAH)."""
    if backend in ("auto", "native"):
        from gopbrt_tpu import native

        out = native.bvh_build(
            np.asarray(lo, np.float32),
            np.asarray(hi, np.float32),
            max_leaf=MAX_LEAF,
            n_buckets=N_BUCKETS,
            method=method,
        )
        if out is not None:
            nlo, nhi, nright, nfirst, ncount, naxis, order = out
            return LinearBVH(
                node_lo=jnp.asarray(nlo),
                node_hi=jnp.asarray(nhi),
                node_right=jnp.asarray(nright),
                node_first=jnp.asarray(nfirst),
                node_count=jnp.asarray(ncount),
                node_axis=jnp.asarray(naxis),
                prim_order=jnp.asarray(order),
            )
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable (no C++ toolchain?)")
    return _build_from_bounds_numpy(lo, hi)


def _build_from_bounds_numpy(lo: np.ndarray, hi: np.ndarray) -> LinearBVH:
    p = lo.shape[0]
    centroids = 0.5 * (lo + hi)
    order: list[int] = []
    n_lo, n_hi, n_right, n_first, n_count, n_axis = [], [], [], [], [], []

    def alloc():
        n_lo.append(np.zeros(3, np.float32))
        n_hi.append(np.zeros(3, np.float32))
        n_right.append(-1)
        n_first.append(0)
        n_count.append(0)
        n_axis.append(0)
        return len(n_lo) - 1

    def make_leaf(node, ids):
        n_first[node] = len(order)
        n_count[node] = ids.size
        order.extend(ids.tolist())

    def split_ids(node, ids, blo, bhi):
        """Returns (left_ids, right_ids, axis) or None to make a leaf."""
        c = centroids[ids]
        clo, chi = c.min(axis=0), c.max(axis=0)
        extent = chi - clo
        axis = int(np.argmax(extent))
        if extent[axis] < 1e-12:
            mid = ids.size // 2  # degenerate: equal-counts (bvh.go fallback)
            return ids[:mid], ids[mid:], axis
        # binned SAH (12 buckets, bvh.go:344-401)
        b = np.minimum(
            (N_BUCKETS * (c[:, axis] - clo[axis]) / extent[axis]).astype(np.int64),
            N_BUCKETS - 1,
        )
        costs = np.full(N_BUCKETS - 1, np.inf)
        for split in range(N_BUCKETS - 1):
            lmask = b <= split
            nl = int(lmask.sum())
            nr = ids.size - nl
            if nl == 0 or nr == 0:
                continue
            sa_l = _surface_area(lo[ids[lmask]].min(axis=0), hi[ids[lmask]].max(axis=0))
            sa_r = _surface_area(lo[ids[~lmask]].min(axis=0), hi[ids[~lmask]].max(axis=0))
            costs[split] = 0.125 + (nl * sa_l + nr * sa_r) / max(
                _surface_area(blo, bhi), 1e-20
            )
        best = int(np.argmin(costs))
        if costs[best] < ids.size or ids.size > MAX_LEAF:
            if np.isfinite(costs[best]):
                lmask = b <= best
            else:  # all prims in one bucket: median split
                med = np.argsort(c[:, axis], kind="stable")
                lmask = np.zeros(ids.size, bool)
                lmask[med[: ids.size // 2]] = True
            return ids[lmask], ids[~lmask], axis
        return None

    def build(ids) -> int:
        """Depth-first recursive build: left child is node+1 by construction,
        right child index stored (the LinearBVHNode layout, bvh.go:632-651)."""
        node = alloc()
        blo = lo[ids].min(axis=0)
        bhi = hi[ids].max(axis=0)
        n_lo[node], n_hi[node] = blo, bhi
        if ids.size <= MAX_LEAF:
            make_leaf(node, ids)
            return node
        split = split_ids(node, ids, blo, bhi)
        if split is None:
            make_leaf(node, ids)
            return node
        left_ids, right_ids, axis = split
        n_axis[node] = axis
        n_count[node] = 0
        build(left_ids)  # == node + 1
        n_right[node] = build(right_ids)
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * int(np.log2(max(p, 2))) * 64))
    try:
        build(np.arange(p, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old_limit)
    return _finalize(n_lo, n_hi, n_right, n_first, n_count, n_axis, order)


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])


def _finalize(n_lo, n_hi, n_right, n_first, n_count, n_axis, order) -> LinearBVH:
    return LinearBVH(
        node_lo=jnp.asarray(np.stack(n_lo)),
        node_hi=jnp.asarray(np.stack(n_hi)),
        node_right=jnp.asarray(np.asarray(n_right, np.int32)),
        node_first=jnp.asarray(np.asarray(n_first, np.int32)),
        node_count=jnp.asarray(np.asarray(n_count, np.int32)),
        node_axis=jnp.asarray(np.asarray(n_axis, np.int32)),
        prim_order=jnp.asarray(np.asarray(order, np.int32)),
    )


# ---------------------------------------------------------------------------
# Device traversal: lockstep wavefront with per-ray stacks.
# Counterpart of BVH.Intersect / IntersectP (bvh.go:659-765).
# ---------------------------------------------------------------------------


def _traverse(bvh: LinearBVH, prims: isect.Primitives, o, d, t_max, any_hit: bool, time=None):
    """Shared closest-hit / any-hit traversal.

    State per ray: current node, explicit [STACK_DEPTH] stack (bvh.go:664
    uses 64 too), best (t, prim).  One node processed per while_loop
    iteration across all rays; `pending` lanes idle once done.  Near-child
    ordering uses the ray direction sign on the node's split axis
    (bvh.go:678-690).
    """
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    neg = inv_d < 0.0  # [N,3]

    class _Carry(NamedTuple):
        node: jnp.ndarray  # int32[N] current node (-1 = pop next)
        sp: jnp.ndarray  # int32[N] stack pointer
        stack: jnp.ndarray  # int32[N, STACK_DEPTH]
        t_best: jnp.ndarray  # f32[N]
        prim_best: jnp.ndarray  # int32[N]
        done: jnp.ndarray  # bool[N]

    carry = _Carry(
        node=jnp.zeros((n,), jnp.int32),
        sp=jnp.zeros((n,), jnp.int32),
        stack=jnp.zeros((n, STACK_DEPTH), jnp.int32),
        t_best=t_max,
        prim_best=jnp.full((n,), -1, jnp.int32),
        done=jnp.zeros((n,), bool),
    )

    def cond(c: _Carry):
        return jnp.any(~c.done)

    def body(c: _Carry) -> _Carry:
        active = ~c.done
        node = jnp.maximum(c.node, 0)
        lo = bvh.node_lo[node]
        hi = bvh.node_hi[node]
        box_hit = geom.bounds_intersect_p(lo, hi, o, d, c.t_best, inv_d) & active

        count = bvh.node_count[node]
        is_leaf = count > 0
        leaf_hit = box_hit & is_leaf

        t_best, prim_best = c.t_best, c.prim_best
        # static unroll over leaf slots (MAX_LEAF small)
        for k in range(MAX_LEAF):
            in_range = leaf_hit & (k < count)
            pid = bvh.prim_order[
                jnp.clip(bvh.node_first[node] + k, 0, bvh.prim_order.shape[0] - 1)
            ]
            tk = isect.prim_t(prims, pid, o, d, t_best, time=time)
            better = in_range & (tk < t_best)
            t_best = jnp.where(better, tk, t_best)
            prim_best = jnp.where(better, pid, prim_best)

        if any_hit:
            found = prim_best >= 0
        else:
            found = jnp.zeros((n,), bool)

        # interior: descend near child first, push far child
        interior_hit = box_hit & ~is_leaf
        axis = bvh.node_axis[node]
        dir_neg = jnp.take_along_axis(neg, axis[:, None], axis=1)[:, 0]
        left = node + 1
        right = bvh.node_right[node]
        near = jnp.where(dir_neg, right, left)
        far = jnp.where(dir_neg, left, right)

        push = interior_hit
        sp_clamped = jnp.clip(c.sp, 0, STACK_DEPTH - 1)
        new_stack = jnp.where(
            (push[:, None])
            & (jnp.arange(STACK_DEPTH)[None, :] == sp_clamped[:, None]),
            far[:, None],
            c.stack,
        )
        sp_after_push = jnp.where(push, jnp.minimum(c.sp + 1, STACK_DEPTH), c.sp)

        # next node: near child if interior-hit, else pop
        need_pop = active & ~interior_hit
        can_pop = sp_after_push > 0
        popped_sp = jnp.where(need_pop & can_pop, sp_after_push - 1, sp_after_push)
        popped_node = new_stack[
            jnp.arange(n), jnp.clip(popped_sp, 0, STACK_DEPTH - 1)
        ]
        next_node = jnp.where(interior_hit, near, popped_node)
        newly_done = (need_pop & ~can_pop) | found
        return _Carry(
            node=jnp.where(active, next_node, c.node),
            sp=jnp.where(active, popped_sp, c.sp),
            stack=new_stack,
            t_best=t_best,
            prim_best=prim_best,
            done=c.done | newly_done,
        )

    out = jax.lax.while_loop(cond, body, carry)
    hit = out.prim_best >= 0
    return hit, jnp.where(hit, out.t_best, t_max), jnp.maximum(out.prim_best, 0)


def bvh_intersect(bvh: LinearBVH, prims: isect.Primitives, o, d, t_max, time=None):
    """Closest hit (bvh.go:659-712). Returns (hit[N], t[N], prim_idx[N]).

    time: per-lane ray times for animated scenes — leaf tests interpolate
    the primitive transform; node bounds must have been built to cover the
    whole shutter (SceneBuilder unions keyframe bounds)."""
    return _traverse(bvh, prims, o, d, t_max, any_hit=False, time=time)


def bvh_intersect_p(bvh: LinearBVH, prims: isect.Primitives, o, d, t_max, time=None):
    """Any hit / shadow rays (bvh.go:713-765). Returns bool[N]."""
    hit, _, _ = _traverse(bvh, prims, o, d, t_max, any_hit=True, time=time)
    return hit
