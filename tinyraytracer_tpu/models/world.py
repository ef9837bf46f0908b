"""World: scene container + lowering to device SoA arrays.

The reference World (hittable/world.rs:10-78) holds boxed trait objects and a
named material registry. Here World is the same user-facing container, but
`build()` lowers it to a `SceneArrays` pytree: padded struct-of-arrays that a
whole batch of rays intersects with dense, matmul-friendly math. Primitive-count
padding keeps shapes static across scenes of similar size (one XLA compile
per size class); padded slots are masked out with `*_valid`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tinyraytracer_tpu.models.geometry import (
    Geometry,
    Group,
    Quad,
    Sphere,
    flatten_geometry,
)
from tinyraytracer_tpu.models.materials import Material

# Primitive counts pad to a multiple of 128 so scenes of similar size share
# array shapes, and with them compiled programs (the jit caches key on
# shapes); padded rows are invalid and never hit.
_PRIM_PAD = 128
_MAT_PAD = 8


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SceneArrays:
    """Device-side scene: SoA arrays, the unit of jit/vjp/sharding.

    Float leaves (centers, radii, quad vectors, material params) are the
    differentiable scene parameters; int/bool leaves are structure.
    """

    sph_center: jax.Array  # (Ns, 3) f32
    sph_radius: jax.Array  # (Ns,)   f32
    sph_mat: jax.Array     # (Ns,)   i32 — row in the material table
    sph_valid: jax.Array   # (Ns,)   bool

    quad_corner: jax.Array  # (Nq, 3) f32
    quad_u: jax.Array       # (Nq, 3) f32
    quad_v: jax.Array       # (Nq, 3) f32
    quad_mat: jax.Array     # (Nq,)   i32
    quad_valid: jax.Array   # (Nq,)   bool

    mat_kind: jax.Array    # (M,)   i32 — materials.LAMBERTIAN/METAL/...
    mat_albedo: jax.Array  # (M, 3) f32
    mat_fuzz: jax.Array    # (M,)   f32
    mat_ior: jax.Array     # (M,)   f32
    mat_emit: jax.Array    # (M, 3) f32

    @property
    def num_spheres(self) -> int:
        return int(self.sph_center.shape[0])

    @property
    def num_quads(self) -> int:
        return int(self.quad_corner.shape[0])

    def replace(self, **kw) -> "SceneArrays":
        return dataclasses.replace(self, **kw)


# --- reference BVH visit order -------------------------------------------
#
# Winner ties between coplanar primitives (the Cornell light is embedded in
# the ceiling plane, src/main.rs:42-59) are resolved by every intersector
# here as "first minimum = lowest storage index". The reference resolves
# them by its BVH traversal: left subtree first, right child needs a
# *strictly* smaller t (bvh.rs:96-101 half-open range), composite
# HittableList members in insertion order — i.e. first-visited-in-DFS wins.
# Storing primitives in that DFS order makes the two tie rules identical,
# which is what makes Cornell renders statistically match (the light would
# otherwise win ~25% more z-fights here than in the reference, brightening
# the whole image).

# Shared with ops/bvh.py's host builder (and mirrored by the C++ builder in
# native/src/tinyrt.cpp): ONE Python source for the reference split policy —
# the z-fight tie parity above holds only while storage order (built here)
# and BVH visit order (built there) agree on pad + axis rule.
REF_AABB_PAD = np.float32(0.0001 / 2.0)  # aabb.rs:14-17 (1e-4 total/axis)


def ref_longest_axis(mn: np.ndarray, mx: np.ndarray) -> int:
    """aabb.rs:63-78 longest axis; equal extents resolve to z (the
    reference's if/else chain requires strictly greater extent for x/y)."""
    s = mx - mn
    if s[0] > s[1]:
        return 0 if s[0] > s[2] else 2
    return 1 if s[1] > s[2] else 2


def _ref_bbox(g) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(g, Sphere):
        c = np.asarray(g.center, np.float32)
        r = np.float32(abs(g.radius))
        return c - r - REF_AABB_PAD, c + r + REF_AABB_PAD  # sphere.rs:16-25
    if isinstance(g, Quad):
        c = np.asarray(g.corner, np.float32)
        u = np.asarray(g.u, np.float32)
        v = np.asarray(g.v, np.float32)
        pts = np.stack([c, c + u + v, c + u, c + v])  # quad.rs:21-23
        return pts.min(0) - REF_AABB_PAD, pts.max(0) + REF_AABB_PAD
    if isinstance(g, Group):
        mns, mxs = zip(*(_ref_bbox(m) for m in g.members))
        return np.min(mns, axis=0), np.max(mxs, axis=0)
    raise TypeError(type(g))


def _reference_visit_order(geometries) -> Tuple[List[int], List[int]]:
    """(sphere_perm, quad_perm): flat indices in reference BVH DFS order.

    Emulates Node::new over the *top-level* geometry list (Groups are single
    composite leaves, as the reference's boxed HittableList objects are) with
    the exact split policy of bvh.rs:42-84: merged-bbox longest axis, stable
    sort by bbox.min[axis], median split, two-member nodes unsorted.
    """
    s_count = [0]
    q_count = [0]

    def prims(g):
        # Assign flat ids in the same DFS order flatten_geometry uses.
        if isinstance(g, Sphere):
            i = s_count[0]
            s_count[0] += 1
            return [("s", i)]
        if isinstance(g, Quad):
            i = q_count[0]
            q_count[0] += 1
            return [("q", i)]
        out = []
        for m in g.members:
            out.extend(prims(m))
        return out

    objs = []
    for g in geometries:
        mn, mx = _ref_bbox(g)
        objs.append((mn, mx, prims(g)))

    order: List[Tuple[str, int]] = []

    def visit(objs):
        if len(objs) == 1:
            order.extend(objs[0][2])
            return
        if len(objs) == 2:  # bvh.rs:58-67: no sort
            visit(objs[:1])
            visit(objs[1:])
            return
        mn = np.min([o[0] for o in objs], axis=0)
        mx = np.max([o[1] for o in objs], axis=0)
        axis = ref_longest_axis(mn, mx)
        objs = sorted(objs, key=lambda o: o[0][axis])  # stable, like sort_by
        mid = len(objs) // 2
        visit(objs[:mid])
        visit(objs[mid:])

    if objs:
        visit(objs)
    s_perm = [i for k, i in order if k == "s"]
    q_perm = [i for k, i in order if k == "q"]
    return s_perm, q_perm


class World:
    """Scene container mirroring hittable/world.rs: geometry list + named
    material registry. `add_material` rejects duplicate names the way the
    reference panics (world.rs:27-33)."""

    def __init__(self):
        self._materials: Dict[str, Material] = {}
        self._geometries: List[Geometry] = []
        # mutation counter: build() caches its lowering per version so
        # repeated renders of an unmodified world (e.g. render_batch
        # loops) reuse the same SceneArrays object — which also keys the
        # downstream compile caches by identity
        self._version = 0
        self._build_cache: Dict[tuple, SceneArrays] = {}

    def add_material(self, name: str, material: Material) -> None:
        if name in self._materials:
            raise ValueError(f"material {name!r} already registered")
        self._materials[name] = material
        self._version += 1

    def get_material(self, name: str) -> Optional[Material]:
        return self._materials.get(name)

    def add_geometry(self, geometry: Geometry) -> None:
        self._geometries.append(geometry)
        self._version += 1

    @property
    def geometries(self) -> Sequence[Geometry]:
        return tuple(self._geometries)

    @property
    def material_names(self) -> Sequence[str]:
        return tuple(self._materials.keys())

    def get_geometries(self, kind: type) -> List[Geometry]:
        """Typed extraction of flattened primitives, the downcast-based
        World::get_geometries::<T> (world.rs:47-56)."""
        spheres, quads = flatten_geometry(self._geometries)
        if kind is Sphere:
            return list(spheres)
        if kind is Quad:
            return list(quads)
        raise TypeError(f"unknown geometry kind {kind!r}")

    def get_materials(self, kind: int) -> Dict[str, Material]:
        """Materials of one kind code (world.rs:58-65's get_materials::<T>,
        keyed by materials.LAMBERTIAN/METAL/DIELECTRIC/LIGHT)."""
        return {n: m for n, m in self._materials.items() if m.kind == kind}

    def build(self, prim_pad: int = _PRIM_PAD) -> SceneArrays:
        """Lower to padded SoA device arrays (in reference visit order).

        Cached per (mutation version, prim_pad): calling build() twice on
        an unmodified world returns the SAME SceneArrays object."""
        key = (self._version, prim_pad)
        cached = self._build_cache.get(key)
        if cached is not None:
            return cached
        scene = self._build_uncached(prim_pad)
        self._build_cache = {key: scene}   # keep only the latest version
        return scene

    def _build_uncached(self, prim_pad: int = _PRIM_PAD) -> SceneArrays:
        spheres, quads = flatten_geometry(self._geometries)
        s_perm, q_perm = _reference_visit_order(self._geometries)
        spheres = [spheres[i] for i in s_perm]
        quads = [quads[i] for i in q_perm]
        mat_index = {name: i for i, name in enumerate(self._materials)}
        mats = list(self._materials.values())
        if not mats:
            raise ValueError("world has no materials")

        def mat_id(name: str) -> int:
            if name not in mat_index:
                raise KeyError(f"geometry references unknown material {name!r}")
            return mat_index[name]

        ns = _round_up(len(spheres), prim_pad) if spheres else prim_pad
        nq = _round_up(len(quads), prim_pad) if quads else prim_pad
        nm = _round_up(len(mats), _MAT_PAD)

        sph_center = np.zeros((ns, 3), np.float32)
        sph_radius = np.zeros((ns,), np.float32)
        sph_mat = np.zeros((ns,), np.int32)
        sph_valid = np.zeros((ns,), bool)
        for i, s in enumerate(spheres):
            sph_center[i] = s.center
            sph_radius[i] = s.radius
            sph_mat[i] = mat_id(s.material)
            sph_valid[i] = True

        quad_corner = np.zeros((nq, 3), np.float32)
        quad_u = np.zeros((nq, 3), np.float32)
        quad_v = np.zeros((nq, 3), np.float32)
        # Padded quads get degenerate u x v = 0; keep them numerically inert
        # by giving them unit edges (they are masked by quad_valid anyway).
        quad_u[:, 0] = 1.0
        quad_v[:, 1] = 1.0
        quad_mat = np.zeros((nq,), np.int32)
        quad_valid = np.zeros((nq,), bool)
        for i, q in enumerate(quads):
            quad_corner[i] = q.corner
            quad_u[i] = q.u
            quad_v[i] = q.v
            quad_mat[i] = mat_id(q.material)
            quad_valid[i] = True

        mat_kind = np.zeros((nm,), np.int32)
        mat_albedo = np.zeros((nm, 3), np.float32)
        mat_fuzz = np.zeros((nm,), np.float32)
        mat_ior = np.ones((nm,), np.float32)
        mat_emit = np.zeros((nm, 3), np.float32)
        for i, m in enumerate(mats):
            mat_kind[i] = m.kind
            mat_albedo[i] = m.albedo
            mat_fuzz[i] = m.fuzz
            mat_ior[i] = m.ior
            mat_emit[i] = m.emission

        return SceneArrays(
            sph_center=jnp.asarray(sph_center),
            sph_radius=jnp.asarray(sph_radius),
            sph_mat=jnp.asarray(sph_mat),
            sph_valid=jnp.asarray(sph_valid),
            quad_corner=jnp.asarray(quad_corner),
            quad_u=jnp.asarray(quad_u),
            quad_v=jnp.asarray(quad_v),
            quad_mat=jnp.asarray(quad_mat),
            quad_valid=jnp.asarray(quad_valid),
            mat_kind=jnp.asarray(mat_kind),
            mat_albedo=jnp.asarray(mat_albedo),
            mat_fuzz=jnp.asarray(mat_fuzz),
            mat_ior=jnp.asarray(mat_ior),
            mat_emit=jnp.asarray(mat_emit),
        )
