"""BVH: host-side threaded build + vectorized wavefront traversal.

The reference builds a binary BVH per render — top-down median split on the
longest axis of the node bbox, one object per leaf (bvh.rs:42-84), AABBs
padded by 1e-4 total (aabb.rs:13-19) — and traverses it recursively with
closest-hit range narrowing (bvh.rs:88-107). Its GPU path replaces this with
Metal hardware acceleration structures (accelstructure.rs).

Re-design for a vectorized accelerator:
  - The *build* is host-side (numpy here; native/ has the C++ fast path),
    the analog of the Metal accel-structure build+compact — it happens once
    per scene, off the device.
  - The tree is flattened to SoA arrays in DFS order with *threaded* links:
    hit_link (= node+1, the DFS next) and miss_link (the escape index), so
    traversal needs no stack — each ray walks a node pointer, which maps to
    a masked `lax.while_loop` over the whole ray wavefront.
  - Traversal narrows the t range with the running best hit exactly like
    the reference's `t_range.start..hit.t` (bvh.rs:96-101).
  - Reverse-mode AD can't flow through `while_loop`, and shouldn't: the
    traversal only *selects* the winning primitive (discrete). The winner's
    t is recomputed differentiably outside the loop, so gradients w.r.t.
    scene parameters are identical to the brute-force path's.

Brute force (ops/intersect.py) stays the oracle: for any scene and rays,
BVH and brute-force hits must agree bitwise on (t, winner) — the test suite
enforces the self-consistency gate of SURVEY.md §7 phase 6.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tinyraytracer_tpu.models import world as _world
from tinyraytracer_tpu.models.world import SceneArrays
from tinyraytracer_tpu.ops.intersect import (
    MISS_T,
    T_MIN,
    HitRecord,
    prim_t,
    select_to_record,
)

# AABB padding: the reference pads each axis by 1e-4 total, 5e-5 per side
# (aabb.rs:13-19). Shared with models/world.py's reference-visit-order
# emulation — storage order and BVH visit order must agree on the policy
# or the Cornell z-fight tie parity silently breaks.
AABB_PAD = float(_world.REF_AABB_PAD)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BVHArrays:
    """Flattened threaded BVH (DFS order). M = 2N-1 nodes for N primitives.

    leaf_prim >= 0 is a *global* primitive index (spheres then quads, the
    same convention as ops.intersect.hit_record_from); -1 marks inner nodes.
    hit_link is the node to visit when this node's bbox is hit (DFS next);
    miss_link is the escape node; M itself is the "done" sentinel.
    """

    node_min: jax.Array   # (M, 3) f32
    node_max: jax.Array   # (M, 3) f32
    hit_link: jax.Array   # (M,)   i32
    miss_link: jax.Array  # (M,)   i32
    leaf_prim: jax.Array  # (M,)   i32


def primitive_aabbs(scene: SceneArrays) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host AABBs + global ids of the *valid* primitives of a scene.

    Sphere: center ± radius (sphere.rs:16-25). Quad: merge of the four
    corners (quad.rs precomputes its AABB the same way). Both padded like
    aabb.rs:13-19.
    """
    c = np.asarray(scene.sph_center, np.float32)
    r = np.asarray(scene.sph_radius, np.float32)[:, None]
    sv = np.asarray(scene.sph_valid, bool)
    s_min = c - np.abs(r)
    s_max = c + np.abs(r)

    corner = np.asarray(scene.quad_corner, np.float32)
    u = np.asarray(scene.quad_u, np.float32)
    v = np.asarray(scene.quad_v, np.float32)
    qv = np.asarray(scene.quad_valid, bool)
    pts = np.stack([corner, corner + u, corner + v, corner + u + v], axis=0)
    q_min = pts.min(axis=0)
    q_max = pts.max(axis=0)

    ns = c.shape[0]
    ids = np.concatenate([np.arange(ns), ns + np.arange(corner.shape[0])])
    bb_min = np.concatenate([s_min, q_min], axis=0) - AABB_PAD
    bb_max = np.concatenate([s_max, q_max], axis=0) + AABB_PAD
    valid = np.concatenate([sv, qv])
    return bb_min[valid], bb_max[valid], ids[valid].astype(np.int32)


def _build_host(bb_min: np.ndarray, bb_max: np.ndarray, prim_ids: np.ndarray):
    """Iterative median-split build -> threaded DFS arrays (bvh.rs:42-84).

    Split policy matches the reference exactly: node bbox = merge of member
    bboxes, split axis = longest axis of the node bbox (aabb.rs:63-78),
    members sorted by bbox min on that axis (aabb.rs:80-82), split at n/2;
    n == 2 skips the sort (bvh.rs:58-67); leaves hold one primitive.
    """
    n = bb_min.shape[0]
    m = 2 * n - 1
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    hit_link = np.empty((m,), np.int32)
    miss_link = np.empty((m,), np.int32)
    leaf_prim = np.full((m,), -1, np.int32)

    order = np.arange(n)
    next_idx = 0
    # (member index array, escape node) stack; DFS preorder assigns indices.
    stack = [(order, m)]
    while stack:
        members, escape = stack.pop()
        idx = next_idx
        next_idx += 1
        mn = bb_min[members].min(axis=0)
        mx = bb_max[members].max(axis=0)
        node_min[idx] = mn
        node_max[idx] = mx
        miss_link[idx] = escape
        k = members.shape[0]
        if k == 1:
            leaf_prim[idx] = prim_ids[members[0]]
            hit_link[idx] = escape  # unused for leaves; keep well-defined
            continue
        hit_link[idx] = idx + 1
        # aabb.rs:63-78 longest_axis (shared: models/world.py, ties -> z)
        axis = _world.ref_longest_axis(mn, mx)
        if k == 2:
            left, right = members[:1], members[1:]  # bvh.rs:58-67 (no sort)
        else:
            srt = members[np.argsort(bb_min[members, axis], kind="stable")]
            half = k // 2
            left, right = srt[:half], srt[half:]
        # DFS preorder: left occupies idx+1 .. idx+2*len(left)-1, then right.
        # Left's escape is the right child's start index.
        right_start = idx + 1 + (2 * left.shape[0] - 1)
        # Push right first so left is popped (and numbered) first.
        stack.append((right, escape))
        stack.append((left, right_start))
    return node_min, node_max, hit_link, miss_link, leaf_prim


def build_bvh(scene: SceneArrays, use_native: bool = True) -> BVHArrays:
    """Build the flattened BVH for a (concrete, host-resident) scene."""
    bb_min, bb_max, prim_ids = primitive_aabbs(scene)
    if bb_min.shape[0] == 0:
        raise ValueError("cannot build a BVH over an empty scene")
    built = None
    if use_native:
        # Graceful fallback covers MISSING native bits only (no compiler /
        # unbuilt library); a runtime error from a present builder is a
        # real defect and must surface, not silently take the slow path.
        try:
            from tinyraytracer_tpu.native import runtime
        except ImportError:
            runtime = None
        if runtime is not None and runtime.available():
            nm, nx, hl, ml, lp = runtime.bvh_build(bb_min, bb_max)
            # Native builder works in local prim order; map to global ids.
            lp = np.where(lp >= 0, prim_ids[np.maximum(lp, 0)], -1).astype(
                np.int32
            )
            built = (nm, nx, hl, ml, lp)
    if built is None:
        built = _build_host(bb_min, bb_max, prim_ids)
    nm, nx, hl, ml, lp = built
    return BVHArrays(
        node_min=jnp.asarray(nm),
        node_max=jnp.asarray(nx),
        hit_link=jnp.asarray(hl),
        miss_link=jnp.asarray(ml),
        leaf_prim=jnp.asarray(lp),
    )


def _safe_inv(d):
    """1/d with zero components nudged off zero (slab test stays NaN-free)."""
    tiny = jnp.float32(1.0e-24)
    d = jnp.where(jnp.abs(d) < tiny, tiny, d)
    return 1.0 / d


def traverse(
    scene: SceneArrays,
    bvh: BVHArrays,
    o,
    d,
    t_min=T_MIN,
    t_max=MISS_T,
):
    """Walk the threaded BVH for a ray wavefront. Returns detached (t, j).

    Per-ray node pointers advance together under one `lax.while_loop`; a ray
    parks at the sentinel M when its walk ends. The AABB slab test uses the
    narrowed range [t_min, best_t) like BVH::hit (bvh.rs:96-101, aabb.rs:36-61).
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    scene = jax.tree.map(jax.lax.stop_gradient, scene)
    m = bvh.node_min.shape[0]
    rcount = o.shape[0]
    inv_d = _safe_inv(d)

    def cond(state):
        node, _, _ = state
        return jnp.any(node < m)

    def body(state):
        node, best_t, best_j = state
        nc = jnp.minimum(node, m - 1)
        nmin = jnp.take(bvh.node_min, nc, axis=0)      # (R,3)
        nmax = jnp.take(bvh.node_max, nc, axis=0)
        lp = jnp.take(bvh.leaf_prim, nc)               # (R,)
        hl = jnp.take(bvh.hit_link, nc)
        ml = jnp.take(bvh.miss_link, nc)

        t0 = (nmin - o) * inv_d
        t1 = (nmax - o) * inv_d
        near = jnp.minimum(t0, t1)
        far = jnp.maximum(t0, t1)
        lo = jnp.maximum(jnp.max(near, axis=-1), t_min)
        hi = jnp.minimum(jnp.min(far, axis=-1), best_t)
        box_hit = lo < hi                               # aabb.rs:36-61

        is_leaf = lp >= 0
        # Note [t_min, t_max) bound, not best_t: an exact tie at best_t must
        # still be seen so the tie-break below can fire.
        pt = prim_t(scene, o, d, jnp.maximum(lp, 0), t_min, t_max)
        # Ties (coplanar primitives, e.g. the Cornell light embedded in the
        # ceiling plane) resolve to the lowest global index — exactly the
        # brute-force argmin's semantics, so both paths pick the same winner.
        better = (
            is_leaf
            & (pt < MISS_T)
            & ((pt < best_t) | ((pt == best_t) & (lp < best_j)))
        )
        best_t = jnp.where(better, pt, best_t)
        best_j = jnp.where(better, lp, best_j)

        nxt = jnp.where(is_leaf, ml, jnp.where(box_hit, hl, ml))
        node = jnp.where(node >= m, m, nxt)
        return node, best_t, best_j

    node0 = jnp.zeros((rcount,), jnp.int32)
    t0 = jnp.full((rcount,), t_max, jnp.float32)
    j0 = jnp.full((rcount,), -1, jnp.int32)
    node, best_t, best_j = jax.lax.while_loop(cond, body, (node0, t0, j0))
    return best_t, best_j


def intersect_scene_bvh(
    scene: SceneArrays,
    bvh: BVHArrays,
    o,
    d,
    t_min=T_MIN,
    t_max=MISS_T,
) -> HitRecord:
    """BVH-accelerated closest hit, gradient-equivalent to intersect_scene.

    The while_loop only selects the winner (detached); the winner's t is
    recomputed differentiably, so `jax.grad` through this path matches the
    brute-force path exactly (SURVEY.md §7 phase 8: detach discrete hit
    selection, reparameterize the continuous terms). Record assembly is the
    shared select_to_record so all three selection paths keep one
    miss-fallback policy.
    """
    t_sel, j = traverse(scene, bvh, o, d, t_min, t_max)
    t_sel = jnp.where(j >= 0, t_sel, MISS_T)
    return select_to_record(scene, o, d, t_sel, j, t_min, t_max)
