"""Differentiability gates (BASELINE.md acceptance):

  - analytic pixel gradients match central finite differences;
  - the sharded training step's gradients match the single-device ones;
  - a short inverse-rendering fit recovers a perturbed albedo;
  - optimizer checkpoint save/resume round-trips.

The FD scene is a large sphere filling the whole view (camera staring
straight down at it) so no silhouette crosses the image: visibility is
locally constant and the analytic gradient (which detaches the discrete
hit selection) equals the true derivative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinyraytracer_tpu.diff import inverse
from tinyraytracer_tpu.diff.params import apply_params, scene_params
from tinyraytracer_tpu.models.camera import Camera
from tinyraytracer_tpu.models.geometry import Sphere
from tinyraytracer_tpu.models.materials import (
    Dielectric, Lambertian, Light, Metal,
)
from tinyraytracer_tpu.models.world import World
from tinyraytracer_tpu.ops import trace as trace_ops


W, H = 12, 10
SPP = 2
BOUNCES = 3
BG = (0.7, 0.8, 1.0)


@pytest.fixture(scope="module")
def down_scene():
    world = World()
    world.add_material("ground", Lambertian((0.4, 0.5, 0.6)))
    world.add_geometry(Sphere((0.0, -100.0, 0.0), 100.0, "ground"))
    camera = Camera.new(
        focus_distance=1.0,
        defocus_angle=0.0,
        position=(0.0, 3.0, 0.0),
        look_at=(0.0, 0.0, 0.001),  # almost straight down
        up=(0.0, 0.0, 1.0),
        vertical_fov=60.0,
        width=W,
        height=H,
    )
    return world.build(), camera


def _mean_render(scene, camera):
    img = trace_ops.render_image(
        scene,
        camera,
        spp=SPP,
        max_bounces=BOUNCES,
        background=jnp.asarray(BG, jnp.float32),
        seed=7,
    )
    return jnp.mean(img)


@pytest.mark.parametrize(
    "field,idx,eps",
    [
        ("mat_albedo", (0, 1), 1e-2),
        ("sph_radius", (0,), 3e-2),
        ("sph_center", (0, 1), 3e-2),
    ],
)
def test_gradient_matches_finite_differences(down_scene, field, idx, eps):
    scene, camera = down_scene

    def loss_wrt(v):
        arr = getattr(scene, field).at[idx].set(v)
        return _mean_render(scene.replace(**{field: arr}), camera)

    v0 = getattr(scene, field)[idx]
    g = jax.grad(loss_wrt)(v0)
    f_plus = loss_wrt(v0 + eps)
    f_minus = loss_wrt(v0 - eps)
    fd = (float(f_plus) - float(f_minus)) / (2 * eps)
    assert np.isfinite(float(g))
    assert abs(float(g) - fd) <= 0.05 * max(abs(fd), 1e-3), (
        f"{field}{idx}: analytic {float(g):.6f} vs FD {fd:.6f}"
    )


def test_emission_gradient_matches_fd():
    """Gradient through the emission term (light-material path)."""
    world = World()
    world.add_material("ground", Lambertian((0.5, 0.5, 0.5)))
    world.add_material("lamp", Light((4.0, 4.0, 4.0)))
    world.add_geometry(Sphere((0.0, -100.0, 0.0), 100.0, "ground"))
    world.add_geometry(Sphere((0.0, 2.0, -1.0), 0.8, "lamp"))
    scene = world.build()
    camera = Camera.new(1.0, 0.0, (0.0, 1.0, 3.0), (0.0, 1.0, 0.0),
                        (0.0, 1.0, 0.0), 60.0, W, H)

    def loss_wrt(e):
        arr = scene.mat_emit.at[(1, 0)].set(e)
        return _mean_render(scene.replace(mat_emit=arr), camera)

    v0 = scene.mat_emit[1, 0]
    g = float(jax.grad(loss_wrt)(v0))
    eps = 1e-2
    fd = (float(loss_wrt(v0 + eps)) - float(loss_wrt(v0 - eps))) / (2 * eps)
    assert abs(g - fd) <= 0.03 * max(abs(fd), 1e-3)


@pytest.mark.parametrize(
    "field,material,eps",
    [
        ("mat_fuzz", Metal((0.8, 0.7, 0.6), 0.2), 3e-3),
        ("mat_ior", Dielectric((0.9, 0.9, 0.9), 1.5), 3e-3),
    ],
)
def test_material_gradient_matches_fd(field, material, eps):
    """FD gates for the scatter parameters on the modular path: a metal
    (fuzz) or glass (ior) ground sphere fills the view under a gradient
    sky, so the radiance depends smoothly on the scattered direction's y.
    The glass's reflect-vs-refract choice is a discrete event whose
    threshold moves with ior; eps is small enough that no sample of this
    seed flips, so the pathwise gradient is the true derivative."""
    world = World()
    world.add_material("m", material)
    world.add_geometry(Sphere((0.0, -100.0, 0.0), 100.0, "m"))
    scene = world.build()
    camera = Camera.new(1.0, 0.0, (0.0, 3.0, 0.0), (0.0, 0.0, 0.001),
                        (0.0, 0.0, 1.0), 60.0, W, H)
    sky = jnp.asarray([[1.0, 1.0, 1.0], [0.3, 0.5, 1.0]], jnp.float32)

    def loss_wrt(v):
        arr = getattr(scene, field).at[0].set(v)
        img = trace_ops.render_image(
            scene.replace(**{field: arr}), camera, spp=SPP,
            max_bounces=BOUNCES, background=sky, seed=7)
        return jnp.mean(img)

    v0 = getattr(scene, field)[0]
    g = float(jax.grad(loss_wrt)(v0))
    fd = (float(loss_wrt(v0 + eps)) - float(loss_wrt(v0 - eps))) / (2 * eps)
    assert np.isfinite(g) and abs(fd) > 1e-3
    assert abs(g - fd) <= 0.05 * abs(fd), (field, g, fd)


@pytest.mark.heavy
def test_sharded_grads_match_single_device(down_scene):
    scene, camera = down_scene
    target = np.zeros((H, W, 3), np.float32)
    from tinyraytracer_tpu.parallel.sharded import make_mesh

    kw = dict(spp=4, max_bounces=BOUNCES, background=BG, seed=3)
    step1, (p1, s1) = inverse.make_train_step(scene, camera, target, **kw)
    stepN, (pN, sN) = inverse.make_train_step(
        scene, camera, target, mesh=make_mesh(sample_parallel=2), **kw
    )
    p1b, _, l1 = step1(p1, s1, 0)
    pNb, _, lN = stepN(pN, sN, 0)
    assert abs(float(l1) - float(lN)) < 1e-5 * max(1.0, abs(float(l1)))
    for k in p1b:
        np.testing.assert_allclose(
            np.asarray(p1b[k]), np.asarray(pNb[k]), rtol=1e-3, atol=1e-6
        )


@pytest.mark.heavy
def test_inverse_fit_recovers_albedo(down_scene):
    scene, camera = down_scene
    target = trace_ops.render_image(
        scene, camera, spp=8, max_bounces=BOUNCES,
        background=jnp.asarray(BG, jnp.float32), seed=11,
    )
    # Perturb the ground albedo and fit it back. Same seed/spp as the
    # target and advance_samples=False make the target exactly achievable
    # (at tiny spp, fresh-sample SGD would also descend the estimator
    # variance and converge off the true albedo — see make_train_step).
    wrong = scene.replace(mat_albedo=scene.mat_albedo.at[0].set(
        jnp.asarray([0.9, 0.1, 0.2])))
    # trainable restricts the fit to the albedo: with every float field
    # free, geometry shifts can compensate for a wrong albedo and reach
    # near-zero loss at the wrong scene (see make_train_step docstring).
    step, (params, opt_state) = inverse.make_train_step(
        wrong, camera, target, spp=8, max_bounces=BOUNCES,
        background=BG, seed=11, learning_rate=5e-2, advance_samples=False,
        trainable=("mat_albedo",),
    )
    first = None
    for i in range(60):
        params, opt_state, loss = step(params, opt_state, i)
        if first is None:
            first = float(loss)
    assert float(loss) < 0.01 * first, (first, float(loss))
    fitted = np.asarray(params["mat_albedo"][0])
    np.testing.assert_allclose(fitted, [0.4, 0.5, 0.6], atol=0.05)


def test_silhouette_factor_is_value_preserving():
    """The silhouette ratio must be EXACTLY 1 in the forward pass.

    Regression: clamping only the denominator (p / max(sg(p), 1e-3))
    darkened rays whose segment starts deep inside a non-winner sphere
    (p < 1e-3, e.g. a small ball nested in a glass dome), silently biasing
    render_loss(silhouette=True)."""
    w = World()
    w.add_material("glass", Lambertian((0.9, 0.9, 0.9)))
    w.add_material("core", Lambertian((0.1, 0.2, 0.8)))
    w.add_geometry(Sphere((0.0, 0.0, 0.0), 2.0, "glass"))
    w.add_geometry(Sphere((0.0, 0.0, 0.0), 0.2, "core"))
    scene = w.build()
    rows = np.nonzero(np.asarray(scene.sph_valid))[0]
    inner = int(rows[1])
    # Segment starting inside the outer sphere, winner = the small core:
    # the outer sphere's pass-by probability p = 1 - cov is far below the
    # 1e-3 guard, the exact case the old clamp mishandled. The ray is
    # offset from the core's center so the silhouette gradient is nonzero.
    o = jnp.asarray([[0.15, 0.0, -1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    t_sel = jnp.asarray([0.95], jnp.float32)
    j = jnp.asarray([inner], jnp.int32)
    alive = jnp.asarray([True])
    factor = trace_ops._silhouette_factor(scene, o, d, t_sel, j, alive)
    np.testing.assert_array_equal(np.asarray(factor), 1.0)
    # ...while the backward pass still carries the boundary signal.
    g = jax.grad(
        lambda c: trace_ops._silhouette_factor(
            scene.replace(sph_center=c), o, d, t_sel, j, alive)[0]
    )(scene.sph_center)
    assert np.isfinite(np.asarray(g)).all()
    assert np.any(np.asarray(g)[inner] != 0.0)


@pytest.mark.slow
@pytest.mark.heavy
def test_silhouette_recovers_sphere_position():
    """BASELINE.md gate: sphere *position* recovery from a large offset.

    The pathwise estimator has zero geometry gradient a.e.; the silhouette
    surrogate (ops.trace._silhouette_factor) supplies the boundary term.
    A sphere offset 4 units (disjoint silhouettes) must recover to well
    under its own radius."""
    import optax

    def build(cx):
        w = World()
        w.add_material("white", Lambertian((0.73, 0.73, 0.73)))
        w.add_material("blue", Lambertian((0.1, 0.2, 0.8)))
        w.add_material("lamp", Light((15.0, 15.0, 15.0)))
        from tinyraytracer_tpu.models.geometry import Quad

        w.add_geometry(Quad((-50.0, -50.0, 10.0), (100.0, 0.0, 0.0),
                            (0.0, 100.0, 0.0), "white"))
        w.add_geometry(Quad((-4.0, 19.99, -4.0), (8.0, 0.0, 0.0),
                            (0.0, 0.0, 8.0), "lamp"))
        w.add_geometry(Sphere((cx, 0.0, 0.0), 3.0, "blue"))
        cam = Camera.new(20.0, 0.0, (0.0, 0.0, -20.0), (0.0, 0.0, 0.0),
                         (0.0, 1.0, 0.0), 40.0, 48, 48)
        return w.build(), cam

    scene_t, cam = build(0.0)
    bg = jnp.asarray((0.001,) * 3, jnp.float32)
    target = trace_ops.render_image(
        scene_t, cam, spp=48, max_bounces=3, background=bg, seed=1, nee=True
    )
    scene0, _ = build(4.0)
    s_row = int(np.nonzero(np.asarray(scene0.sph_valid))[0][0])

    # Hold the LR until the basin is reached (~45 steps from 4 units out),
    # then decay hard so SGD noise stops the weakly-constrained depth axis
    # from wandering.
    sched = optax.join_schedules(
        [optax.constant_schedule(0.15),
         optax.exponential_decay(0.15, transition_steps=10, decay_rate=0.4)],
        boundaries=[45],
    )
    step, (params, opt) = inverse.make_train_step(
        scene0, cam, target, spp=16, max_bounces=3, background=bg, seed=0,
        optimizer=optax.adam(sched), trainable=("sph_center",),
    )
    # 70 steps: the fit converges by ~60 (measured err trajectory 0.237 /
    # 0.228 / 0.243 / 0.255 at steps 60/70/80/100) — the last 30 steps
    # were pure wall-clock.
    for i in range(70):
        params, opt, _ = step(params, opt, i)
    err = float(np.linalg.norm(np.asarray(params["sph_center"])[s_row]))
    assert err < 0.5, f"center error {err:.3f} after 70 steps (started at 4.0)"


def test_quad_gradient_matches_fd():
    """Boundary-free quad FD gate: camera staring at a
    wall quad that fills the whole view, so no edge crosses the image and
    the pathwise derivative (through t, hit point, normal) is the true
    one. Perturb an in-plane corner component."""
    world = World()
    world.add_material("wall", Lambertian((0.4, 0.5, 0.6)))
    from tinyraytracer_tpu.models.geometry import Quad

    world.add_geometry(Quad((-50.0, -50.0, 3.0), (100.0, 0.0, 0.0),
                            (0.0, 100.0, 0.0), "wall"))
    scene = world.build()
    camera = Camera.new(1.0, 0.0, (0.0, 0.0, -2.0), (0.0, 0.0, 3.0),
                        (0.0, 1.0, 0.0), 50.0, W, H)
    q_row = int(np.nonzero(np.asarray(scene.quad_valid))[0][0])

    def loss_wrt(v):
        arr = scene.quad_corner.at[(q_row, 2)].set(v)  # push wall in z
        return _mean_render(scene.replace(quad_corner=arr), camera)

    v0 = scene.quad_corner[q_row, 2]
    g = float(jax.grad(loss_wrt)(v0))
    eps = 3e-2
    fd = (float(loss_wrt(v0 + eps)) - float(loss_wrt(v0 - eps))) / (2 * eps)
    assert np.isfinite(g)
    assert abs(g - fd) <= 0.05 * max(abs(fd), 1e-3), (g, fd)


@pytest.mark.slow
@pytest.mark.heavy
def test_fit_recovers_quad_occluder_position():
    """Gate: a NON-emissive quad occluder offset >2 units
    recovers to <0.5. The pathwise estimator's gradient w.r.t. the
    occluder's position is zero a.e.; the quad edge silhouette +
    soft-shadow surrogates (ops.trace._silhouette_factor quad branch)
    supply the boundary term — the quad analog of
    test_silhouette_recovers_sphere_position."""
    import optax

    def build(off):
        w = World()
        w.add_material("white", Lambertian((0.73, 0.73, 0.73)))
        w.add_material("blue", Lambertian((0.1, 0.2, 0.8)))
        w.add_material("lamp", Light((15.0, 15.0, 15.0)))
        from tinyraytracer_tpu.models.geometry import Quad

        w.add_geometry(Quad((-50.0, -50.0, 10.0), (100.0, 0.0, 0.0),
                            (0.0, 100.0, 0.0), "white"))
        w.add_geometry(Quad((-4.0, 19.99, -4.0), (8.0, 0.0, 0.0),
                            (0.0, 0.0, 8.0), "lamp"))
        w.add_geometry(Quad((-2.0 + off, -2.0, 0.0), (4.0, 0.0, 0.0),
                            (0.0, 4.0, 0.0), "blue"))
        cam = Camera.new(20.0, 0.0, (0.0, 0.0, -20.0), (0.0, 0.0, 0.0),
                         (0.0, 1.0, 0.0), 40.0, 48, 48)
        return w.build(), cam

    scene_t, cam = build(0.0)
    bg = jnp.asarray((0.001,) * 3, jnp.float32)
    target = trace_ops.render_image(
        scene_t, cam, spp=48, max_bounces=3, background=bg, seed=1, nee=True
    )
    scene0, _ = build(2.5)
    # World.build() lowers in BVH visit order, not add order: find the
    # occluder row by its corner value, pin the other quad rows each step
    # (trainable= is field-granular).
    qrows = np.nonzero(np.asarray(scene0.quad_valid))[0]
    corners0 = np.asarray(scene0.quad_corner)
    occ_row = int(qrows[np.argmin(np.linalg.norm(
        corners0[qrows] - np.array([0.5, -2.0, 0.0]), axis=-1))])
    true_corner = np.asarray(scene_t.quad_corner)[occ_row]
    fixed_rows = jnp.asarray([int(r) for r in qrows if r != occ_row])
    fixed_vals = jnp.asarray(
        corners0[[int(r) for r in qrows if r != occ_row]])

    sched = optax.join_schedules(
        [optax.constant_schedule(0.15),
         optax.exponential_decay(0.15, transition_steps=10, decay_rate=0.4)],
        boundaries=[45],
    )
    step, (params, opt) = inverse.make_train_step(
        scene0, cam, target, spp=16, max_bounces=3, background=bg, seed=0,
        optimizer=optax.adam(sched), trainable=("quad_corner",),
    )
    # 70 steps: same schedule/convergence profile as the sphere fit
    # above (decay boundary 45; converged by ~60).
    for i in range(70):
        params, opt, _ = step(params, opt, i)
        params["quad_corner"] = params["quad_corner"].at[fixed_rows].set(
            fixed_vals)
    got = np.asarray(params["quad_corner"])[occ_row]
    err = float(np.linalg.norm(got - true_corner))
    assert err < 0.5, f"occluder error {err:.3f} after 70 steps (started at 2.5)"


@pytest.mark.heavy
def test_fit_recovers_light_quad_position():
    """North-star "quad vertices": recover an out-of-view light quad's
    position purely from the shading it casts (NEE contribution is smooth
    in the emitter's corner — direction, falloff, cos terms — so this
    needs no boundary surrogate at all)."""
    import optax

    def build(off):
        w = World()
        w.add_material("ground", Lambertian((0.6, 0.5, 0.4)))
        w.add_material("ball", Lambertian((0.2, 0.3, 0.8)))
        w.add_material("lamp", Light((14.0, 14.0, 14.0)))
        from tinyraytracer_tpu.models.geometry import Quad

        w.add_geometry(Sphere((0.0, -100.0, 0.0), 100.0, "ground"))
        w.add_geometry(Sphere((0.0, 1.0, 0.0), 1.0, "ball"))
        # the scene's ONLY quad, overhead and out of frame
        w.add_geometry(Quad((-2.0 + off, 8.0, -2.0), (4.0, 0.0, 0.0),
                            (0.0, 0.0, 4.0), "lamp"))
        cam = Camera.new(1.0, 0.0, (0.0, 4.0, -8.0), (0.0, 1.0, 0.0),
                         (0.0, 1.0, 0.0), 45.0, 32, 32)
        return w.build(), cam

    scene_t, cam = build(0.0)
    bg = jnp.asarray((0.001,) * 3, jnp.float32)
    target = trace_ops.render_image(
        scene_t, cam, spp=32, max_bounces=3, background=bg, seed=1, nee=True
    )
    scene0, _ = build(2.5)
    q_row = int(np.nonzero(np.asarray(scene0.quad_valid))[0][0])
    true_corner = np.asarray(scene_t.quad_corner)[q_row]

    step, (params, opt) = inverse.make_train_step(
        scene0, cam, target, spp=8, max_bounces=3, background=bg, seed=0,
        optimizer=optax.adam(0.1), trainable=("quad_corner",),
    )
    for i in range(80):
        params, opt, _ = step(params, opt, i)
    got = np.asarray(
        apply_params(scene0, params).quad_corner)[q_row]
    err = float(np.linalg.norm(got - true_corner))
    assert err < 0.5, f"light corner error {err:.3f} after 80 steps (started at 2.5)"


def test_gradients_finite_across_seeds():
    """Regression guard for the round-1 NaN: raw render_loss gradients
    (no sanitizer) must be finite across many sample rounds on a geometry
    fit scene with spheres near walls (the degenerate-sample class that
    produced an accelerator NaN)."""
    world, camera, kw = __import__(
        "tinyraytracer_tpu.models.presets", fromlist=["presets"]
    ).cornell_spheres(width=20, height=20)
    scene = world.build()
    bg = jnp.asarray(kw["background"], jnp.float32)
    target = jnp.zeros((20, 20, 3), jnp.float32)
    params = scene_params(scene)
    grad_fn = jax.jit(
        lambda p, off: jax.grad(inverse.render_loss)(
            p, scene, camera, target, spp=2, max_bounces=4, background=bg,
            seed=jnp.uint32(17), spp_offset=off, nee=True, silhouette=True,
        )
    )
    for off in range(0, 40, 2):
        g = grad_fn(params, jnp.uint32(off))
        for k, v in g.items():
            assert bool(jnp.isfinite(v).all()), (k, off)


def test_checkpoint_roundtrip(tmp_path, down_scene):
    scene, camera = down_scene
    target = np.zeros((H, W, 3), np.float32)
    step, (params, opt_state) = inverse.make_train_step(
        scene, camera, target, spp=2, max_bounces=2, background=BG, seed=0,
    )
    params, opt_state, _ = step(params, opt_state, 0)
    path = os.path.join(tmp_path, "ckpt.pkl")
    inverse.save_checkpoint(path, params, opt_state, 1)
    p2, s2, step_idx = inverse.load_checkpoint(path, opt_state)
    assert step_idx == 1
    for k in params:
        np.testing.assert_array_equal(np.asarray(params[k]), np.asarray(p2[k]))
    # The restored state must be steppable.
    p3, s3, loss = step(p2, s2, 1)
    assert np.isfinite(float(loss))
