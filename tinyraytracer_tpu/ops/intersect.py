"""Batched ray-scene intersection.

The reference intersects one ray against one primitive at a time through
trait objects (hittable/sphere.rs:29-54, quad.rs:33-54) or Metal intersection
functions (shader/geometry.metal:33-99). This formulation intersects a
batch of R rays against *all* N primitives at once:

  - sphere quadratic terms d.c and o.c are (R,3)@(3,N) matmuls;
  - quad plane/planar-coordinate tests reduce to scalar triple products
    (p x v).w = p.(v x w), linear in p, so they are matmuls too;
  - the closest-hit argmin is a reduction over the primitive axis.

Semantics preserved from the reference:
  - t range is half-open [t_min, t_max) (Rust Range::contains);
  - sphere: near root, then far root fallback (sphere.rs:40-46);
  - quad: planar coords in half-open [0,1) — the CPU semantics, not the
    Metal shader's closed bounds (quad.rs:41 vs geometry.metal:88);
  - HitRecord normal flipped to face the ray, front_face = d.n_out < 0
    (hittable/mod.rs:34-40).
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from tinyraytracer_tpu.models.world import SceneArrays

# Accelerator default matmul precision may be reduced (bf16 passes, or TF32
# on the GPU); the screening matmuls feed winner selection where ulp-level
# ties (coplanar surfaces) matter, so force full f32.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)

# t for "no hit". Large-but-finite so downstream arithmetic never makes NaNs.
MISS_T = jnp.float32(3.0e38)
T_MIN = jnp.float32(1.0e-3)  # sampler/cpu.rs:48

@jax.custom_vjp
def take_rows(table, j):
    """Differentiable `table[j]` for (N,) / (N, K) tables, (R,) indices.

    Forward is a plain gather. The *transpose*, however, would be an
    R-update scatter-add, which some XLA backends compile slowly and run
    ~serialized — so the backward is written as a one-hot matmul instead:
    ct_table = onehot(j)ᵀ @ ct, an (N,R)@(R,K) reduction with R the minor
    axis; exactness holds because every product is 1.0 * x.
    """
    return jnp.take(table, j, axis=0)


def _take_rows_fwd(table, j):
    return jnp.take(table, j, axis=0), (j, table.shape[0], table.ndim)


def _take_rows_bwd(res, ct):
    j, n, ndim = res
    oh_t = (jnp.arange(n, dtype=j.dtype)[:, None] == j[None, :]).astype(
        jnp.float32
    )                                                       # (N, R)
    if ndim == 1:
        ct_table = _mm(oh_t, ct[:, None])[:, 0]
    else:
        ct_table = _mm(oh_t, ct)
    return ct_table, None


take_rows.defvjp(_take_rows_fwd, _take_rows_bwd)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HitRecord:
    """SoA hit record for a ray batch (hittable/mod.rs:19-48, vectorized)."""

    t: jax.Array          # (R,)  f32, MISS_T when no hit
    hit: jax.Array        # (R,)  bool
    point: jax.Array      # (R,3) f32
    normal: jax.Array     # (R,3) f32, unit, flipped toward the ray
    front_face: jax.Array  # (R,) bool
    mat_kind: jax.Array   # (R,)  i32
    albedo: jax.Array     # (R,3) f32
    fuzz: jax.Array       # (R,)  f32
    ior: jax.Array        # (R,)  f32
    emit: jax.Array       # (R,3) f32
    is_quad: jax.Array    # (R,)  bool — winner is a quad (NEE light-kind gate)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def sphere_ts(scene: SceneArrays, o, d, t_min, t_max, exact: bool = False):
    """Per-(ray, sphere) hit parameter t, MISS_T where no valid hit.

    o, d: (R,3); returns (R, Ns). `exact` uses the reference's oc = o - c
    form (broadcasted (R,Ns,3), exact in f32, the test oracle); the default
    expands the quadratic so the heavy terms are matmuls.
    """
    c = scene.sph_center
    r = scene.sph_radius
    if exact:
        oc = o[:, None, :] - c[None, :, :]          # (R,Ns,3)
        half_b = jnp.einsum("rns,rs->rn", oc, d, precision=_HI)
        c_term = jnp.sum(oc * oc, axis=-1) - r[None, :] ** 2
    else:
        d_dot_c = _mm(d, c.T)                        # (R,Ns) matmul
        o_dot_c = _mm(o, c.T)                        # (R,Ns) matmul
        half_b = _dot(d, o)[:, None] - d_dot_c
        c_term = (
            _dot(o, o)[:, None] - 2.0 * o_dot_c + jnp.sum(c * c, axis=-1)[None, :]
            - r[None, :] ** 2
        )
    disc = half_b * half_b - c_term
    has_root = disc >= 0.0
    # sqrt's unselected branch must stay finite in the backward pass: a
    # masked-out disc <= 0 would contribute 0-cotangent * inf = NaN.
    sqrtd = jnp.sqrt(jnp.where(has_root, jnp.maximum(disc, 0.0), 1.0))
    t0 = -half_b - sqrtd  # near root (a == 1: directions are normalized)
    t1 = -half_b + sqrtd  # far root fallback (sphere.rs:42-46)
    in0 = (t0 >= t_min) & (t0 < t_max)
    in1 = (t1 >= t_min) & (t1 < t_max)
    t = jnp.where(in0, t0, jnp.where(in1, t1, MISS_T))
    valid = has_root & scene.sph_valid[None, :]
    return jnp.where(valid, t, MISS_T)


def quad_ts(scene: SceneArrays, o, d, t_min, t_max):
    """Per-(ray, quad) hit parameter t, MISS_T where no valid hit.

    Quad plane quantities (quad.rs:20-29): n = u x v, w = n/(n.n),
    d_plane = n.corner. Planar coordinates (quad.rs:38-41):
      alpha = (p x v).w = p.(v x w) / (n.n)  with p relative to corner,
      beta  = (u x p).w = p.(w_vec x u)... expressed as p.(n x u)/(n.n);
    both are linear in p, so alpha/beta over the whole (R,Nq) grid are
    matmuls of ray origin/direction against per-quad constant vectors.
    """
    corner, u, v = scene.quad_corner, scene.quad_u, scene.quad_v
    n = jnp.cross(u, v)                       # (Nq,3)
    nn = _dot(n, n)                           # (Nq,)
    inv_nn = 1.0 / jnp.maximum(nn, 1e-30)     # degenerate quads are masked
    d_plane = _dot(n, corner)                 # (Nq,)
    # alpha = (p x v) . (n/nn) = p . (v x n) / nn
    a_vec = jnp.cross(v, n) * inv_nn[:, None]   # (Nq,3)
    # beta = (u x p) . (n/nn) = p . (n x u) / nn
    b_vec = jnp.cross(n, u) * inv_nn[:, None]   # (Nq,3)

    denom = _mm(d, n.T)                        # (R,Nq) matmul
    # Grazing rays (denom -> 0) give t -> inf; forward masking handles the
    # value, but d(t)/d(denom) = -num/denom^2 must stay finite or the
    # backward pass NaNs through the mask (0 * inf).
    denom_safe = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    t = (d_plane[None, :] - _mm(o, n.T)) / denom_safe  # (R,Nq)
    in_range = (t >= t_min) & (t < t_max) & (jnp.abs(denom) >= 1e-12)

    # p = o + t*d - corner; alpha = p.a_vec, beta = p.b_vec — all matmuls.
    o_a = _mm(o, a_vec.T)
    d_a = _mm(d, a_vec.T)
    c_a = _dot(corner, a_vec)
    alpha = o_a + t * d_a - c_a[None, :]
    o_b = _mm(o, b_vec.T)
    d_b = _mm(d, b_vec.T)
    c_b = _dot(corner, b_vec)
    beta = o_b + t * d_b - c_b[None, :]

    inside = (alpha >= 0.0) & (alpha < 1.0) & (beta >= 0.0) & (beta < 1.0)
    valid = in_range & inside & scene.quad_valid[None, :] & jnp.isfinite(t)
    return jnp.where(valid, t, MISS_T)


def prim_t(scene: SceneArrays, o, d, j, t_min=T_MIN, t_max=MISS_T):
    """t of each ray against its *single* global primitive j, in [t_min, t_max).

    j: (R,) global index (spheres then quads). Sphere: near-then-far
    quadratic roots (sphere.rs:29-54). Quad: plane t + half-open planar
    bounds (quad.rs:33-54). This is the one differentiable t formula shared
    by the brute-force and BVH paths — winner *selection* may use any fast
    screening math, but the reported t (and therefore every gradient w.r.t.
    scene parameters) always comes from here.
    """
    ns = scene.sph_center.shape[0]
    nq = scene.quad_corner.shape[0]
    is_quad = j >= ns
    sj = jnp.clip(j, 0, ns - 1)
    qj = jnp.clip(j - ns, 0, nq - 1)

    # Sphere (exact oc = o - c form).
    c = take_rows(scene.sph_center, sj)
    r = take_rows(scene.sph_radius, sj)
    oc = o - c
    half_b = jnp.sum(oc * d, axis=-1)
    c_term = jnp.sum(oc * oc, axis=-1) - r * r
    disc = half_b * half_b - c_term
    has_root = disc >= 0.0
    # NaN-safe backward: sqrt'(0) is infinite, so a ray exactly tangent to
    # the sphere (disc == 0, t = -half_b) takes no gradient through the
    # root, and a masked-out disc < 0 stays finite under sqrt. One such
    # ray would otherwise turn the whole gradient table into NaN through
    # take_rows' one-hot reduction (0 * inf).
    pos = disc > 0.0
    sqrtd = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    t0 = -half_b - sqrtd
    t1 = -half_b + sqrtd
    in0 = (t0 >= t_min) & (t0 < t_max)
    in1 = (t1 >= t_min) & (t1 < t_max)
    ts = jnp.where(in0, t0, jnp.where(in1, t1, MISS_T))
    ts = jnp.where(has_root, ts, MISS_T)

    # Quad.
    corner = take_rows(scene.quad_corner, qj)
    qu = take_rows(scene.quad_u, qj)
    qv = take_rows(scene.quad_v, qj)
    n = jnp.cross(qu, qv)
    nn = jnp.maximum(jnp.sum(n * n, axis=-1), 1e-30)
    denom = jnp.sum(d * n, axis=-1)
    # NaN-safe backward through the grazing-ray mask (0-cotangent * inf).
    denom_safe = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    tq = (jnp.sum(n * corner, axis=-1) - jnp.sum(o * n, axis=-1)) / denom_safe
    p = o + tq[:, None] * d - corner
    alpha = jnp.sum(p * jnp.cross(qv, n), axis=-1) / nn
    beta = jnp.sum(p * jnp.cross(n, qu), axis=-1) / nn
    ok = (
        (tq >= t_min)
        & (tq < t_max)
        & (alpha >= 0.0)
        & (alpha < 1.0)
        & (beta >= 0.0)
        & (beta < 1.0)
        & (jnp.abs(denom) >= 1e-12)
        & jnp.isfinite(tq)
    )
    tq = jnp.where(ok, tq, MISS_T)

    return jnp.where(is_quad, tq, ts)


def _gather_materials(scene: SceneArrays, mat_id):
    return (
        jnp.take(scene.mat_kind, mat_id, axis=0),  # i32: no backward
        take_rows(scene.mat_albedo, mat_id),
        take_rows(scene.mat_fuzz, mat_id),
        take_rows(scene.mat_ior, mat_id),
        take_rows(scene.mat_emit, mat_id),
    )


def closest_select(
    scene: SceneArrays,
    o,
    d,
    t_min=T_MIN,
    t_max=MISS_T,
    exact: bool = False,
):
    """Detached closest-hit *selection*: (t_sel (R,), j (R,)) over all prims.

    Vectorized equivalent of walking World geometry / BVH::hit
    (bvh.rs:88-107): compute all candidate ts, take the argmin. Selection is
    discrete and detached by construction; differentiable consumers recompute
    the winner's t with `prim_t`. Also the shadow-ray screen for NEE (which
    needs only t, no HitRecord)."""
    sel = jax.tree.map(jax.lax.stop_gradient, scene)
    o_s = jax.lax.stop_gradient(o)
    d_s = jax.lax.stop_gradient(d)
    ts = sphere_ts(sel, o_s, d_s, t_min, t_max, exact=exact)
    tq = quad_ts(sel, o_s, d_s, t_min, t_max)
    t_all = jnp.concatenate([ts, tq], axis=1)      # (R, Ns+Nq)
    j = jnp.argmin(t_all, axis=1)                  # (R,)
    t_sel = jnp.take_along_axis(t_all, j[:, None], axis=1)[:, 0]
    return t_sel, j


def select_to_record(
    scene: SceneArrays, o, d, t_sel, j, t_min=T_MIN, t_max=MISS_T
) -> HitRecord:
    """Differentiable HitRecord from a detached selection (t_sel, j).

    The winner's t is recomputed by the shared differentiable `prim_t`, so
    gradients flow through R winners instead of R×N candidates and are
    identical across the dense / BVH / Pallas selection paths. On the rare
    grazing ray where the screening formula and prim_t disagree about
    validity, the screened t is kept."""
    hit = t_sel < MISS_T
    j = jnp.maximum(j, 0)  # miss sentinels (-1 from BVH/Pallas) -> any row
    t_re = prim_t(scene, o, d, j, t_min, t_max)
    t = jnp.where(hit, jnp.where(t_re < MISS_T, t_re, t_sel), MISS_T)
    return hit_record_from(scene, o, d, t, j)


def intersect_scene(
    scene: SceneArrays,
    o,
    d,
    t_min=T_MIN,
    t_max=MISS_T,
    exact: bool = False,
) -> HitRecord:
    """Closest hit of each ray in (o, d) against the whole scene
    (selection + differentiable recompute; see closest_select)."""
    t_sel, j = closest_select(scene, o, d, t_min, t_max, exact=exact)
    return select_to_record(scene, o, d, t_sel, j, t_min, t_max)


def hit_record_from(scene: SceneArrays, o, d, t, j) -> HitRecord:
    """Assemble a HitRecord from winning hit t and global primitive index j.

    j indexes spheres then quads (j >= Ns means quad j - Ns); t == MISS_T
    means no hit. Shared by the brute-force path and the BVH traversal, so
    both produce records (and gradients) through identical code.
    """
    ns = scene.sph_center.shape[0]
    nq = scene.quad_corner.shape[0]
    hit = t < MISS_T
    t_safe = jnp.where(hit, t, 1.0)
    point = o + t_safe[:, None] * d

    is_quad = j >= ns
    sph_j = jnp.minimum(j, ns - 1)
    quad_j = jnp.clip(j - ns, 0, nq - 1)

    center = take_rows(scene.sph_center, sph_j)             # (R,3)
    sph_out = point - center                                # outward normal dir
    qn = jnp.cross(
        take_rows(scene.quad_u, quad_j),
        take_rows(scene.quad_v, quad_j),
    )
    outward = jnp.where(is_quad[:, None], qn, sph_out)
    # sqrt(max(.)) instead of linalg.norm: d||x||/dx at x == 0 is NaN, and a
    # fitted sphere center can land exactly on a (masked) shading point.
    norm = jnp.sqrt(
        jnp.maximum(jnp.sum(outward * outward, axis=-1, keepdims=True), 1e-24)
    )
    outward_unit = outward / norm

    front_face = _dot(d, outward) < 0.0                     # hittable/mod.rs:35
    normal = jnp.where(front_face[:, None], outward_unit, -outward_unit)

    mat_id = jnp.where(
        is_quad,
        jnp.take(scene.quad_mat, quad_j),
        jnp.take(scene.sph_mat, sph_j),
    )
    kind, albedo, fuzz, ior, emit = _gather_materials(scene, mat_id)
    return HitRecord(
        t=t,
        hit=hit,
        point=point,
        normal=normal,
        front_face=front_face,
        mat_kind=kind,
        albedo=albedo,
        fuzz=fuzz,
        ior=ior,
        emit=emit,
        is_quad=is_quad,
    )
