"""End-to-end render tests: determinism, accumulation math (the Imager's
mean + gamma pipeline, renderer/imager.rs:46-57), and small statistical
sanity checks. Full golden-image comparisons against the reference renders
live in scripts/golden_check.py (slow; run on the GPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tinyraytracer_tpu import Renderer
from tinyraytracer_tpu.models import presets
from tinyraytracer_tpu.ops import tonemap
from tinyraytracer_tpu.ops.trace import render_image
from tinyraytracer_tpu.utils.image import Image, read_png


def test_render_deterministic_same_seed():
    world, cam, kw = presets.sphere_ground(32, 18)
    scene = world.build()
    a = np.asarray(
        render_image(scene, cam, spp=4, max_bounces=4,
                     background=jnp.asarray(kw["background"]), seed=1)
    )
    b = np.asarray(
        render_image(scene, cam, spp=4, max_bounces=4,
                     background=jnp.asarray(kw["background"]), seed=1)
    )
    np.testing.assert_array_equal(a, b)
    c = np.asarray(
        render_image(scene, cam, spp=4, max_bounces=4,
                     background=jnp.asarray(kw["background"]), seed=2)
    )
    assert not np.array_equal(a, c)


def test_render_structure_sphere_ground():
    world, cam, kw = presets.sphere_ground(64, 36)
    r = Renderer(samples_per_pixel=8, max_bounces=kw["max_bounces"],
                 background_color=kw["background"])
    img = r.render(cam, world).data
    assert img.shape == (36, 64, 3)
    assert np.isfinite(img).all()
    # sky at top: close to gamma(background)
    sky = img[0, 0]
    bg = np.asarray(kw["background"]) ** (1 / 2.2)
    np.testing.assert_allclose(sky, bg, atol=0.1)
    # ground (yellow albedo 0.8,0.8,0.0): blue channel much darker at bottom
    ground = img[-1].mean(axis=0)
    assert ground[0] > 2.0 * ground[2] and ground[1] > 2.0 * ground[2]


def test_progressbar_path_matches_plain_render():
    world, cam, kw = presets.sphere_ground(16, 9)
    plain = Renderer(samples_per_pixel=6, max_bounces=3,
                     background_color=kw["background"], seed=5)
    prog = Renderer(samples_per_pixel=6, max_bounces=3,
                    background_color=kw["background"], seed=5,
                    progressbar=True, spp_per_round=2)
    a = plain.render(cam, world).data
    b = prog.render(cam, world).data
    # same sample ids are consumed in both paths -> identical image
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_cornell_energy_comes_from_light():
    """With a near-black background the only energy source is the ceiling
    light; image mean must be positive and the light pixels saturated."""
    world, cam, kw = presets.cornell_box(48, 48)
    r = Renderer(samples_per_pixel=16, max_bounces=8,
                 background_color=kw["background"], seed=0)
    img = r.render(cam, world).data
    assert img.mean() > 0.05
    assert img.max() > 0.9  # the light itself (emission 15) saturates


def test_tonemap_roundtrip():
    x = jnp.asarray([[[0.0, 0.5, 1.2]]])
    g = np.asarray(tonemap.gamma_correct(x))
    np.testing.assert_allclose(g[0, 0, 1], 0.5 ** (1 / 2.2), atol=1e-6)
    u8 = np.asarray(tonemap.to_u8(jnp.asarray(g)))
    assert u8[0, 0, 2] == 254  # clamp 0.999 * 255 = 254.7 -> truncates to 254
    assert u8[0, 0, 0] == 0


def test_image_save_png(tmp_path):
    img = Image.from_linear(np.random.default_rng(0).random((8, 8, 3)).astype(np.float32))
    p = tmp_path / "t.png"
    img.save(str(p))
    loaded = read_png(str(p))
    assert loaded.shape == (8, 8, 3)
    np.testing.assert_array_equal(loaded, img.to_u8())


def test_image_save_native_failure_surfaces(tmp_path, monkeypatch):
    """A failing native encoder must raise, not silently fall back to the
    Python encoder (policy of ops/bvh.py:160-164: fallback covers MISSING
    bits only)."""
    from tinyraytracer_tpu.native import runtime

    monkeypatch.setattr(runtime, "available", lambda: True)

    def boom(path, rgb):
        raise RuntimeError("tinyrt_write_png failed: -1")

    monkeypatch.setattr(runtime, "write_png", boom)
    img = Image.from_linear(np.zeros((4, 4, 3), np.float32))
    p = tmp_path / "corrupt.png"
    with pytest.raises(RuntimeError, match="tinyrt_write_png"):
        img.save(str(p))
    assert not p.exists()


def test_render_batch_matches_individual():
    """Renderer.render_batch: every frame of a batch must be bit-identical
    to a single render with that seed (here via the per-seed plain route;
    the burst-program route is pinned bitwise in
    tests/test_megakernel.py::test_render_burst_matches_single)."""
    world, cam, kw = presets.sphere_ground(24, 16)
    scene = world.build()
    r = Renderer(samples_per_pixel=4, max_bounces=4,
                 background_color=kw["background"], seed=99)
    batch = np.asarray(r.render_batch_array(cam, scene, seeds=[3, 7]))
    assert batch.shape[0] == 2
    for i, s in enumerate((3, 7)):
        r.seed = s
        single = np.asarray(r.render_array(cam, scene))
        np.testing.assert_array_equal(batch[i], single)
    assert r.seed == 7  # loop fallback restores... (reset below)
    r.seed = 99
    imgs = r.render_batch(cam, world, seeds=[3, 7])
    assert len(imgs) == 2 and imgs[0].data.shape == (16, 24, 3)
    assert r.seed == 99  # render_batch restores the renderer's seed


def test_render_batch_routes_to_burst(monkeypatch):
    """On the megakernel route a batch must compile into ONE burst
    program (render_burst), not a per-seed render loop."""
    from tinyraytracer_tpu.ops import megakernel as mk

    calls = {}

    class FakeMk:
        def __init__(self, scene, camera, background, **kw):
            calls["init"] = True

        def render_burst(self, *, spp, max_bounces, seeds, **kw):
            calls["burst"] = (spp, max_bounces, tuple(seeds))
            return jnp.zeros((len(seeds), 4, 4, 3), jnp.float32)

    monkeypatch.setattr(mk, "MegakernelRenderer", FakeMk)
    world, cam, kw = presets.sphere_ground(4, 4)
    r = Renderer(samples_per_pixel=2, max_bounces=2,
                 background_color=kw["background"],
                 accelerator="megakernel", interpret=True)
    out = r.render_batch_array(cam, world.build(), seeds=[0, 5])
    assert calls["burst"] == (2, 2, (0, 5))
    assert out.shape == (2, 4, 4, 3)


def test_render_async_matches_render():
    """render_async (the reference's JoinHandle analog,
    renderer/renderer.rs:37-79): the handle's result must equal the
    synchronous render, and done() must report completion."""
    world, cam, kw = presets.sphere_ground(24, 16)
    r = Renderer(samples_per_pixel=4, max_bounces=4,
                 background_color=kw["background"])
    h = r.render_async(cam, world)
    img_async = h.result()
    assert h.done()
    img_sync = r.render(cam, world)
    np.testing.assert_array_equal(img_async.data, img_sync.data)


def test_world_build_cached_until_mutation():
    """World.build() returns the SAME SceneArrays for an unmodified
    world (keys the downstream compile caches by identity) and a fresh
    lowering after any mutation."""
    world, cam, kw = presets.sphere_ground(8, 6)
    s1 = world.build()
    s2 = world.build()
    assert s1 is s2
    from tinyraytracer_tpu.models.geometry import Sphere
    from tinyraytracer_tpu.models.materials import Lambertian

    world.add_material("extra", Lambertian((0.5, 0.5, 0.5)))
    world.add_geometry(Sphere((2.0, 0.0, -1.0), 0.25, "extra"))
    s3 = world.build()
    assert s3 is not s1
    assert int(np.asarray(s3.sph_valid).sum()) == int(
        np.asarray(s1.sph_valid).sum()) + 1
    # the cached object still renders (no stale internal state)
    r = Renderer(samples_per_pixel=2, max_bounces=2,
                 background_color=kw["background"])
    assert np.isfinite(np.asarray(r.render_array(cam, world.build()))).all()


def test_render_batch_reuses_burst_renderer(monkeypatch):
    """Repeated render_batch calls on an unmodified world must reuse the
    scene-bound burst renderer (the compiled N-seed program lives on
    it), not rebuild per call."""
    from tinyraytracer_tpu.ops import megakernel as mk

    inits = []

    class FakeMk:
        def __init__(self, scene, camera, background, **kw):
            inits.append(1)

        def render_burst(self, *, spp, max_bounces, seeds, **kw):
            return jnp.zeros((len(seeds), 4, 4, 3), jnp.float32)

    monkeypatch.setattr(mk, "MegakernelRenderer", FakeMk)
    world, cam, kw = presets.sphere_ground(4, 4)
    r = Renderer(samples_per_pixel=2, max_bounces=2,
                 background_color=kw["background"],
                 accelerator="megakernel", interpret=True)
    scene = world.build()
    r.render_batch_array(cam, scene, seeds=[0, 1])
    r.render_batch_array(cam, scene, seeds=[2, 3])
    assert sum(inits) == 1, "burst renderer rebuilt on the second call"
    # render_batch through the World goes through the build cache, so it
    # hits the same instance too
    r.render_batch(cam, world, seeds=[4])
    assert sum(inits) == 1


def test_megakernel_row_ceiling_routes_modular(monkeypatch):
    """On the GPU, "auto" renders with the megakernel up to
    MEGAKERNEL_MAX_PRIMS valid primitives and routes larger scenes to the
    plain path's BVH. (Platform faked to the GPU; only the scene's valid
    masks are read.)"""
    from tinyraytracer_tpu import renderer as rmod

    class FakeDev:
        platform = "gpu"

    monkeypatch.setattr(rmod.jax, "devices", lambda *a: [FakeDev()])

    class FakeScene:
        def __init__(self, n_sph, n_quad=8):
            self.sph_valid = np.ones((n_sph,), bool)
            self.quad_valid = np.ones((n_quad,), bool)

    r = rmod.Renderer(samples_per_pixel=1)
    assert r._route(FakeScene(500)) == "megakernel"
    limit = rmod.MEGAKERNEL_MAX_PRIMS
    assert r._route(FakeScene(limit - 8)) == "megakernel"
    assert r._route(FakeScene(limit - 7)) == "bvh"
