"""Megakernel parity vs the modular renderer (interpret mode on CPU).

The megakernel re-implements raygen + RNG + intersection + scatter +
accumulation inside one Pallas kernel; every formula is written to match
the modular path (shared pcg4d streams, same intersection and scatter
arithmetic), so under the Pallas interpreter the whole image agrees with
the modular renderer to float rounding on scenes without coplanar-tie
degeneracies. On the GPU the kernel compiles through Triton, whose
arithmetic differs from XLA's by ulps; that comparison is statistical and
lives in chip_smoke.py (phase b), run on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinyraytracer_tpu.models import presets
from tinyraytracer_tpu.ops import megakernel as mk
from tinyraytracer_tpu.ops import trace as trace_ops


def _modular(scene, camera, background, **kw):
    return trace_ops.render_image(
        scene, camera, background=jnp.asarray(background, jnp.float32), **kw)


@pytest.mark.parametrize(
    "name",
    ["three_spheres", "sphere_ground", "cornell_box", "cornell_spheres",
     "five_quads"],
)
def test_megakernel_matches_modular(name):
    world, camera, kw = presets.PRESETS[name](width=16, height=12)
    scene = world.build()
    ref = _modular(scene, camera, kw["background"], spp=2, max_bounces=3,
                   seed=3)
    img = mk.render_image_megakernel(
        scene, camera, spp=2, max_bounces=3,
        background=kw["background"], seed=3, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("name", ["three_spheres", "rtiow_sky"])
def test_gradient_sky(name):
    """Gradient sky ((2,3) [bottom, top] background, the reference's
    output.png artifact class):

    - three_spheres with top==bottom must be BIT-identical to the (3,)
      constant path (the lerp's t*(top-b) term is exactly 0);
    - rtiow_sky: the megakernel matches the modular path."""
    world, camera, kw = presets.PRESETS[name](width=16, height=12)
    scene = world.build()
    if name == "three_spheres":
        bgc = jnp.asarray(kw["background"], jnp.float32)
        bg2 = jnp.stack([bgc, bgc])
        ref = trace_ops.render_image(
            scene, camera, spp=2, max_bounces=3, background=bgc, seed=3)
        dup = trace_ops.render_image(
            scene, camera, spp=2, max_bounces=3, background=bg2, seed=3)
        np.testing.assert_array_equal(np.asarray(dup), np.asarray(ref))
        img = mk.render_image_megakernel(
            scene, camera, spp=2, max_bounces=3, background=bg2, seed=3,
            interpret=True)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-6)
    else:
        bg = jnp.asarray(kw["background"], jnp.float32)
        assert bg.shape == (2, 3)
        ref = trace_ops.render_image(
            scene, camera, spp=2, max_bounces=4, background=bg, seed=5)
        # the sky must actually vary top-to-bottom in the miss region
        top_row = np.asarray(ref)[0]
        assert top_row.std(axis=0).max() > 1e-3
        img = mk.render_image_megakernel(
            scene, camera, spp=2, max_bounces=4,
            background=kw["background"], seed=5, interpret=True)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-6)


def test_many_primitives_match_modular():
    """60 spheres: the in-kernel primitive loop (scalar loads per row) and
    the by-index payload gather agree with the dense modular oracle."""
    world, cam, kw = presets.random_spheres(width=24, height=16, n=60)
    scene = world.build()
    ref = _modular(scene, cam, kw["background"], spp=2, max_bounces=5,
                   seed=3)
    img = mk.render_image_megakernel(
        scene, cam, spp=2, max_bounces=5, background=kw["background"],
        seed=3, interpret=True)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("spp,mb", [(1, 4), (2, 1), (1, 1), (2, 2)])
def test_regen_edge_budgets(spp, mb):
    """spp=1 and budgets of 1 and 2 exercise the regeneration loop's fold
    / budget boundaries (first-iteration regen, immediate budget kill —
    which adds no background term)."""
    world, camera, kw = presets.three_spheres(width=16, height=12)
    scene = world.build()
    ref = _modular(scene, camera, kw["background"], spp=spp,
                   max_bounces=mb, seed=2)
    img = mk.render_image_megakernel(
        scene, camera, spp=spp, max_bounces=mb,
        background=kw["background"], seed=2, interpret=True)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-6)


def test_megakernel_sharded_matches_single():
    """Megakernel under shard_map (tile and sample axes) reproduces the
    single-device render (tile-only exactly; sample split within 1 ulp)."""
    from tinyraytracer_tpu.parallel.sharded import make_mesh

    world, camera, kw = presets.three_spheres(width=16, height=12)
    scene = world.build()
    r = mk.MegakernelRenderer(scene, camera, kw["background"], interpret=True)
    ref = r.render(spp=4, max_bounces=3, seed=5)
    tile_only = r.render(spp=4, max_bounces=3, seed=5,
                         mesh=make_mesh(sample_parallel=1))
    np.testing.assert_array_equal(np.asarray(tile_only), np.asarray(ref))
    split = r.render(spp=4, max_bounces=3, seed=5,
                     mesh=make_mesh(sample_parallel=2))
    np.testing.assert_allclose(np.asarray(split), np.asarray(ref), atol=1e-6)


def test_sharded_uneven_blocks_match_single():
    """A 40x20 image is 3x3 pixel blocks; over 4 tile devices it pads to
    12 programs, so different devices own different pixels and two own
    only padding. Tile-only meshes must still equal the single render
    bitwise, sample splits within rounding."""
    from tinyraytracer_tpu.parallel.sharded import make_mesh

    world, camera, kw = presets.cornell_box(width=40, height=20)
    scene = world.build()
    r = mk.MegakernelRenderer(scene, camera, kw["background"], interpret=True)
    ref = np.asarray(r.render(spp=2, max_bounces=3, seed=5))
    devices = jax.devices()[:4]
    tile_only = r.render(spp=2, max_bounces=3, seed=5,
                         mesh=make_mesh(devices, sample_parallel=1))
    np.testing.assert_array_equal(np.asarray(tile_only), ref)
    split = r.render(spp=2, max_bounces=3, seed=5,
                     mesh=make_mesh(devices, sample_parallel=2))
    np.testing.assert_allclose(np.asarray(split), ref, atol=1e-6)


def test_megakernel_spp_offset_partitions_samples():
    """Two offset halves must average to the full-spp render (the sample
    mean is a plain average over global sample ids)."""
    world, camera, kw = presets.sphere_ground(width=16, height=12)
    scene = world.build()
    r = mk.MegakernelRenderer(scene, camera, kw["background"], interpret=True)
    full = r.render(spp=4, max_bounces=3, seed=5)
    a = r.render(spp=2, max_bounces=3, seed=5, spp_offset=0)
    b = r.render(spp=2, max_bounces=3, seed=5, spp_offset=2)
    np.testing.assert_allclose(
        np.asarray((a + b) / 2.0), np.asarray(full), atol=1e-6
    )


@pytest.mark.heavy
def test_material_specialization_bit_identical():
    """Compiling out absent material kinds (has_met/has_die) must be
    exactly value-preserving: a lambertian+light scene (flags auto-derived
    False) renders bit-identically to the same kernel forced to keep the
    full metal+dielectric chains."""
    world, camera, kw = presets.cornell_box(width=16, height=16)
    scene = world.build()
    r = mk.MegakernelRenderer(scene, camera, kw["background"],
                              interpret=True)
    assert (r.has_met, r.has_die) == (False, False)
    spec = r.render(spp=2, max_bounces=3, seed=7)
    r.has_met = r.has_die = True
    full = r.render(spp=2, max_bounces=3, seed=7)
    np.testing.assert_array_equal(np.asarray(spec), np.asarray(full))


@pytest.mark.parametrize("width,height,shards", [
    (16, 12, 1), (23, 17, 1), (40, 20, 4), (5, 3, 2)])
def test_block_pixel_ids_cover_image(width, height, shards):
    """Program-order pixel ids: a whole number of BLOCK-pixel programs (a
    multiple of the shard count), every pixel present, in-bounds repeats
    only, and `inv` pointing at each pixel's first position."""
    pid, inv = mk.block_pixel_ids(width, height, shards)
    npix = width * height
    assert pid.size % (mk.BLOCK * shards) == 0
    assert pid.min() >= 0 and pid.max() == npix - 1
    assert set(pid.tolist()) == set(range(npix))
    np.testing.assert_array_equal(pid[inv], np.arange(npix))
    first = {}
    for i, p in enumerate(pid.tolist()):
        first.setdefault(p, i)
    assert all(inv[p] == i for p, i in first.items())


@pytest.mark.parametrize("fuzz_seed", [11, 29, 47])
def test_megakernel_matches_modular_random_scene(fuzz_seed):
    """Randomized mixed scenes (spheres + quads, all four material kinds,
    random camera) — the megakernel must reproduce the modular oracle.
    Exercises arbitrary material/geometry mixes, kind specialization with
    every flag combination, and the compaction of invalid rows."""
    from tinyraytracer_tpu.models.camera import Camera
    from tinyraytracer_tpu.models.geometry import Quad, Sphere
    from tinyraytracer_tpu.models.materials import (
        Dielectric, Lambertian, Light, Metal,
    )
    from tinyraytracer_tpu.models.world import World

    rng = np.random.RandomState(fuzz_seed)
    world = World()
    makers = [
        lambda: Lambertian(tuple(rng.uniform(0.1, 0.9, 3))),
        lambda: Metal(tuple(rng.uniform(0.1, 0.9, 3)),
                      float(rng.uniform(0.0, 0.8))),
        lambda: Dielectric(tuple(rng.uniform(0.5, 1.0, 3)),
                           float(rng.uniform(1.1, 2.0))),
        lambda: Light(tuple(rng.uniform(1.0, 4.0, 3))),
    ]
    n_mats = rng.randint(2, 6)
    names = []
    for i in range(n_mats):
        name = f"m{i}"
        world.add_material(name, makers[rng.randint(len(makers))]())
        names.append(name)
    for _ in range(rng.randint(1, 6)):
        c = rng.uniform(-3, 3, 3)
        world.add_geometry(Sphere(tuple(c), float(rng.uniform(0.3, 1.2)),
                                  names[rng.randint(n_mats)]))
    for _ in range(rng.randint(0, 4)):
        world.add_geometry(Quad(tuple(rng.uniform(-3, 3, 3)),
                                tuple(rng.uniform(-2, 2, 3)),
                                tuple(rng.uniform(-2, 2, 3)),
                                names[rng.randint(n_mats)]))
    camera = Camera.new(
        float(rng.uniform(3, 8)), float(rng.uniform(0.0, 1.0)),
        tuple(rng.uniform(-1, 1, 3) + np.array([0, 0, -8])),
        (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 50.0, 16, 12)
    bg = tuple(rng.uniform(0.0, 0.8, 3))
    scene = world.build()
    ref = _modular(scene, camera, bg, spp=2, max_bounces=4, seed=7)
    img = mk.render_image_megakernel(scene, camera, spp=2, max_bounces=4,
                                     background=bg, seed=7, interpret=True)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-6)


def test_render_burst_matches_single():
    """render_burst bakes N seed-renders into one XLA program; each frame
    must be bit-identical to the corresponding single render (the public
    Renderer.render_batch route)."""
    world, cam, kw = presets.sphere_ground(16, 12)
    scene = world.build()
    r = mk.MegakernelRenderer(scene, cam, kw["background"], interpret=True)
    burst = np.asarray(r.render_burst(spp=2, max_bounces=3, seeds=[0, 4]))
    for i, s in enumerate((0, 4)):
        single = np.asarray(r.render(spp=2, max_bounces=3, seed=s))
        np.testing.assert_array_equal(burst[i], single)


def test_compact_scene_tables():
    """The host lowering keeps valid primitives only, spheres then quads in
    storage order, with material rows resolved per primitive."""
    world, _, _ = presets.cornell_spheres(8, 8)
    scene = world.build()
    ks = mk.compact_scene(scene)
    sv = np.asarray(scene.sph_valid)
    qv = np.asarray(scene.quad_valid)
    assert (ks.n_sph, ks.n_quad) == (sv.sum(), qv.sum())
    sph = np.asarray(ks.sph).reshape(-1, 4)[:ks.n_sph]
    np.testing.assert_array_equal(sph[:, :3],
                                  np.asarray(scene.sph_center)[sv])
    np.testing.assert_allclose(sph[:, 3],
                               np.asarray(scene.sph_radius)[sv] ** 2)
    pay = np.asarray(ks.pay).reshape(-1, 16)[:ks.n_sph + ks.n_quad]
    np.testing.assert_array_equal(pay[:, 0],
                                  [0] * ks.n_sph + [1] * ks.n_quad)
    mat_id = np.concatenate([np.asarray(scene.sph_mat)[sv],
                             np.asarray(scene.quad_mat)[qv]])
    np.testing.assert_array_equal(pay[:, 4],
                                  np.asarray(scene.mat_kind)[mat_id])
    np.testing.assert_allclose(pay[:, 5:8],
                               np.asarray(scene.mat_albedo)[mat_id])
    # quad normal source rows are unit plane normals
    np.testing.assert_allclose(
        np.linalg.norm(pay[ks.n_sph:, 1:4], axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize(
    "name", ["cornell_box", "three_spheres", "rtiow_sky", "random_spheres"])
def test_kernel_lowers_for_cuda(name):
    """The kernel lowers to Triton IR for the GPU on this machine: every
    primitive it uses has a Triton lowering and every load/store shape is
    a power of two. (Compiling that IR to PTX needs the card; chip_smoke.py
    does it.) The scenes cover each static specialization: quads only,
    spheres with metal + dielectric, the gradient sky, many spheres."""
    extra = {"n": 40} if name == "random_spheres" else {}
    world, camera, kw = presets.PRESETS[name](width=24, height=16, **extra)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"])
    ctl = jnp.asarray([0, 0, 0, 0], jnp.uint32)
    lowered = mk._render.trace(
        r.ks, r.cam_vec, ctl, spp=2, max_bounces=3, width=24, height=16,
        has_met=r.has_met, has_die=r.has_die, sky=r.sky,
    ).lower(lowering_platforms=("cuda",))
    assert "path_trace_megakernel" in lowered.as_text()
