"""Intersection tests: port of the reference's deterministic geometry units
(sphere.rs:68-100, quad.rs:67-96) plus SoA/batch-specific coverage the
reference lacks (fast-vs-exact consistency, closest-hit selection,
half-open bounds, normal orientation)."""

import jax
import jax.numpy as jnp
import numpy as np

from tinyraytracer_tpu.models.geometry import Quad, Sphere
from tinyraytracer_tpu.models.materials import Lambertian
from tinyraytracer_tpu.models.world import World
from tinyraytracer_tpu.ops import intersect as isect


def _scene(geoms):
    w = World()
    w.add_material("m", Lambertian((0.5, 0.5, 0.5)))
    for g in geoms:
        w.add_geometry(g)
    return w.build()


def _rays(*od_pairs):
    o = jnp.asarray([p[0] for p in od_pairs], jnp.float32)
    d = jnp.asarray([p[1] for p in od_pairs], jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_sphere_hit_reference_cases():
    """sphere.rs:68-100: axis hit, oblique hit, miss."""
    scene = _scene([Sphere((0.0, 0.0, -1.0), 0.5, "m")])
    o, d = _rays(
        ([0, 0, 0], [0, 0, -1]),
        ([0, 0, 0], [0, np.sqrt(3.0), -3.0]),
        ([0, 0, 0], [0, -1, -1]),
    )
    rec = isect.intersect_scene(scene, o, d, t_min=0.0)
    t = np.asarray(rec.t)
    hit = np.asarray(rec.hit)
    assert hit[0] and abs(t[0] - 0.5) < 1e-6
    np.testing.assert_allclose(np.asarray(rec.point[0]), [0, 0, -0.5], atol=1e-6)
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [0, 0, 1], atol=1e-6)

    assert hit[1] and abs(t[1] - np.sqrt(3.0) / 2.0) < 1e-2
    np.testing.assert_allclose(
        np.asarray(rec.point[1]), [0, np.sqrt(3.0) / 4.0, -0.75], atol=1e-2
    )
    n_expect = np.array([0, np.sqrt(3.0), 1.0])
    n_expect /= np.linalg.norm(n_expect)
    np.testing.assert_allclose(np.asarray(rec.normal[1]), n_expect, atol=1e-2)

    assert not hit[2]


def test_sphere_inside_far_root_and_back_face():
    """Ray starting inside the sphere takes the far root (sphere.rs:42-46)
    and the normal is flipped inward (front_face = false)."""
    scene = _scene([Sphere((0.0, 0.0, 0.0), 1.0, "m")])
    o, d = _rays(([0, 0, 0], [0, 0, -1]))
    rec = isect.intersect_scene(scene, o, d, t_min=1e-3)
    assert bool(rec.hit[0])
    assert abs(float(rec.t[0]) - 1.0) < 1e-6
    assert not bool(rec.front_face[0])
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [0, 0, 1], atol=1e-6)


def test_quad_hit_reference_cases():
    """quad.rs:67-96: perpendicular hit, 45-degree hit, near-miss."""
    scene = _scene([Quad((0, 0, 0), (1, 0, 0), (0, 0, 3), "m")])
    o, d = _rays(
        ([0, 1, 0], [0, -1, 0]),
        ([0, 1, 1], [0, -1, -1]),
        ([0, 1, 1], [0, -1, -1.1]),
    )
    rec = isect.intersect_scene(scene, o, d, t_min=0.0)
    hit = np.asarray(rec.hit)
    t = np.asarray(rec.t)
    assert hit[0] and abs(t[0] - 1.0) < 1e-6
    np.testing.assert_allclose(np.asarray(rec.point[0]), [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [0, 1, 0], atol=1e-6)

    assert hit[1] and abs(t[1] - np.sqrt(2.0)) < 1e-6
    np.testing.assert_allclose(np.asarray(rec.point[1]), [0, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(rec.normal[1]), [0, 1, 0], atol=1e-6)

    assert not hit[2]


def test_quad_half_open_bounds():
    """Planar coords use half-open [0,1) — the CPU semantics (quad.rs:41),
    not the Metal shader's closed bounds (geometry.metal:88)."""
    scene = _scene([Quad((0, 0, 0), (1, 0, 0), (0, 0, 1), "m")])
    eps = 1e-4
    o, d = _rays(
        ([0.0, 1.0, 0.0], [0, -1, 0]),        # alpha=0, beta=0 -> inside
        ([1.0, 1.0, 0.5], [0, -1, 0]),        # alpha=1 -> OUTSIDE (half-open)
        ([1.0 - eps, 1.0, 0.5], [0, -1, 0]),  # just inside
        ([0.5, 1.0, 1.0], [0, -1, 0]),        # beta=1 -> OUTSIDE
    )
    hit = np.asarray(isect.intersect_scene(scene, o, d, t_min=0.0).hit)
    assert hit[0]
    assert not hit[1]
    assert hit[2]
    assert not hit[3]


def test_quad_parallel_ray_no_hit():
    scene = _scene([Quad((0, 0, 0), (1, 0, 0), (0, 0, 1), "m")])
    o, d = _rays(([0.5, 1.0, 0.5], [1, 0, 0]))
    assert not bool(isect.intersect_scene(scene, o, d).hit[0])


def test_closest_hit_selection_across_kinds():
    """Mixed sphere+quad scene: the argmin must pick the nearest, as BVH
    closest-hit narrowing does (bvh.rs:96-101)."""
    scene = _scene(
        [
            Sphere((0.0, 0.0, -2.0), 0.5, "m"),
            Quad((-1.0, -1.0, -1.0), (2, 0, 0), (0, 2, 0), "m"),
        ]
    )
    o, d = _rays(([0, 0, 0], [0, 0, -1]))
    rec = isect.intersect_scene(scene, o, d)
    assert bool(rec.hit[0])
    assert abs(float(rec.t[0]) - 1.0) < 1e-6  # quad at z=-1 in front of sphere
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [0, 0, 1], atol=1e-6)


def test_t_min_respected():
    """t range is (t_min, inf) exclusive below t_min (cpu.rs:48 uses 1e-3)."""
    scene = _scene([Quad((-1, -1, -1), (2, 0, 0), (0, 2, 0), "m")])
    o, d = _rays(([0, 0, -1 + 1e-5], [0, 0, -1]))  # on the quad within t_min
    rec = isect.intersect_scene(scene, o, d, t_min=1e-3)
    assert not bool(rec.hit[0])


def test_fast_matches_exact_oracle():
    """The matmul-expanded sphere quadratic must agree with the reference-form
    oc = o - c oracle on a realistic batch."""
    rng = np.random.default_rng(0)
    spheres = [
        Sphere(tuple(rng.uniform(-5, 5, 3).tolist()), float(rng.uniform(0.2, 2.0)), "m")
        for _ in range(40)
    ]
    scene = _scene(spheres)
    o = jnp.asarray(rng.uniform(-8, 8, (512, 3)), jnp.float32)
    d = rng.normal(size=(512, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True), jnp.float32)
    fast = isect.intersect_scene(scene, o, d, exact=False)
    oracle = isect.intersect_scene(scene, o, d, exact=True)
    np.testing.assert_array_equal(np.asarray(fast.hit), np.asarray(oracle.hit))
    m = np.asarray(fast.hit)
    np.testing.assert_allclose(
        np.asarray(fast.t)[m], np.asarray(oracle.t)[m], rtol=1e-4, atol=1e-4
    )


def test_tangent_ray_gradient_is_finite():
    """A ray exactly tangent to a sphere (discriminant == 0) still hits
    at t = -half_b, and its gradient w.r.t. the sphere is finite:
    sqrt'(0) is infinite, so the root contributes none. (At 300x300+
    renders on the GPU one such ray NaN'd every sphere-center gradient.)"""
    scene = _scene([Sphere((0.0, 0.0, -5.0), 1.0, "m")])
    row = int(np.nonzero(np.asarray(scene.sph_valid))[0][0])
    o, d = _rays(([1, 0, 0], [0, 0, -1]))

    def t_of(center):
        return isect.prim_t(scene.replace(sph_center=center), o, d,
                            jnp.asarray([row]))[0]

    assert float(t_of(scene.sph_center)) == 5.0
    g = np.asarray(jax.grad(t_of)(scene.sph_center))
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g[row], [0.0, 0.0, -1.0])


def test_material_gather():
    w = World()
    w.add_material("red", Lambertian((1.0, 0.0, 0.0)))
    w.add_material("blue", Lambertian((0.0, 0.0, 1.0)))
    w.add_geometry(Sphere((0, 0, -1), 0.5, "red"))
    w.add_geometry(Sphere((2, 0, -1), 0.5, "blue"))
    scene = w.build()
    o, d = _rays(([0, 0, 0], [0, 0, -1]), ([2, 0, 0], [0, 0, -1]))
    rec = isect.intersect_scene(scene, o, d)
    np.testing.assert_allclose(np.asarray(rec.albedo[0]), [1, 0, 0])
    np.testing.assert_allclose(np.asarray(rec.albedo[1]), [0, 0, 1])


def test_empty_padding_never_hits():
    """Padded (invalid) primitive slots must never produce hits."""
    scene = _scene([Sphere((0, 0, -1), 0.5, "m")])
    # rays pointing away from the real sphere, towards where padded
    # zero-radius spheres / degenerate quads sit (the origin)
    o, d = _rays(([5, 5, 5], [1, 0, 0]), ([-3, 0, 0], [-1, 0, 0]))
    rec = isect.intersect_scene(scene, o, d)
    assert not np.asarray(rec.hit).any()


def test_compact_padding_inert_for_diagonal_rays():
    """Regression: a padded (invalid) quad row must never fake-hit a ray
    with dx==dy==dz — fl(fl(1e30/dz)*dx) == 1e30 can make alpha/beta
    cancel into [0,1). The dense oracle masks quad_valid directly; the
    megakernel's host lowering drops invalid rows altogether."""
    from tinyraytracer_tpu.ops.megakernel import compact_scene

    # one real quad the diagonal rays miss -> padded invalid quad rows
    scene = _scene([Quad((100.0, -50.0, -50.0), (0, 1, 0), (0, 0, 1), "m")])
    assert not np.asarray(scene.quad_valid).all()
    assert compact_scene(scene).n_quad == 1
    inv = 1.0 / np.sqrt(3.0)
    o = jnp.asarray([[0.25, 0.5, 0.75], [0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[inv, inv, inv], [inv, inv, inv]], jnp.float32)
    rec = isect.intersect_scene(scene, o, d)
    assert not np.asarray(rec.hit).any()


def test_grazing_quad_ray_rejected_everywhere():
    """|n.d| < 1e-12 is a miss in the dense oracle (quad_ts) rather than a
    clamped, possibly sign-flipped plane t; the megakernel applies the
    same guard."""
    scene = _scene([Quad((-1.0, 0.0, -1.0), (2, 0, 0), (0, 0, 2), "m")])
    # ray in the quad's own plane (n = +y, d.n = 0), passing inside bounds
    o = jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    rec = isect.intersect_scene(scene, o, d)
    assert not bool(np.asarray(rec.hit)[0])
    t_sel, _ = isect.closest_select(scene, o, d, exact=True)
    assert float(t_sel[0]) == float(isect.MISS_T)
