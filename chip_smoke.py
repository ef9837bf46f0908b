"""Smoke test on one NVIDIA GPU: the renderer's and the fit's main paths.

    python chip_smoke.py              # one card: phases (a)-(d)
    python chip_smoke.py --chips 4    # four cards: phases (a) and (e)

Phases, each of which must pass:

  (a) device   — JAX must see a GPU; prints its kind, the device count and
                 the card's name and power limit (nvidia-smi).
  (b) parity   — compiles the forward megakernel at real widths (Cornell
                 600x600, three_spheres 400x225, 512 random spheres at
                 1200x675), prints its memory analysis and compares each
                 image at spp 16 with the plain dense XLA path (exact
                 intersection, same seed): per-channel image means within
                 0.5 %, every 16x16 block mean within 6 standard errors of
                 the two block means' difference, and the share of
                 bit-identical pixels reported. Ulp-level differences
                 (FMA contraction, division/sqrt/transcendental lowering)
                 can flip individual path decisions — most of all in the
                 Cornell box, whose light is coplanar with the ceiling, so
                 every light hit is a z-fight decided by rounding — which
                 is why the comparison is statistical.
  (c) renders  — the CLI in-process at Cornell 600x600 spp 200, and
                 Renderer.render_batch_array at 400x225 spp 16 over 8
                 seeds: every burst frame must equal its single render.
  (d) fit      — 3 steps of diff.inverse.fit on cornell_spheres 600x600
                 spp 16 mb 20 (sphere centers + albedos): losses and
                 every field's raw gradient finite; prints peak device
                 memory.
  (e) 4 cards  — (--chips 4 only) tile-sharded renders equal one card
                 bitwise, sample-split renders and the sharded train step
                 agree with one card within summation rounding, and the
                 multi-device CLI writes the one-card image.

Exits non-zero, without the result line, on any failure or when there is
no GPU. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

PARITY_SPP = 16
MEAN_REL_TOL = 5e-3
BLOCK = 16
BLOCK_Z_TOL = 6.0

# (preset, width, height, max_bounces, preset kwargs)
PARITY_CASES = (
    ("cornell_box", 600, 600, 20, {}),
    ("three_spheres", 400, 225, 10, {}),
    ("random_spheres", 1200, 675, 50, {"n": 512}),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def phase_device() -> jax.Device:
    from tinyraytracer_tpu.utils.device import gpu_name_and_power_limit

    device = jax.devices()[0]
    check(device.platform == "gpu",
          f"no GPU: JAX's first device is {device.platform!r}")
    log(f"(a) device: {device.device_kind}, {len(jax.devices())} device(s)")
    log(gpu_name_and_power_limit())
    return device


def reference_image(scene, camera, *, spp, max_bounces, background, seed,
                    chunk=1 << 17):
    """Plain dense XLA render (exact intersection), in pixel chunks so the
    (rays, primitives) candidate tensors stay small."""
    from tinyraytracer_tpu.ops import trace as trace_ops

    render = jax.jit(lambda pid: trace_ops.render_pixels(
        scene, camera, pid, spp=spp, max_bounces=max_bounces,
        background=jnp.asarray(background, jnp.float32), seed=seed,
        exact=True))
    npix = camera.width * camera.height
    parts = [np.asarray(render(jnp.arange(s, min(s + chunk, npix),
                                          dtype=jnp.uint32)))
             for s in range(0, npix, chunk)]
    return np.concatenate(parts).reshape(camera.height, camera.width, 3)


def compare_images(img: np.ndarray, ref: np.ndarray) -> dict:
    """Image-mean and block-mean agreement of two renders of one scene."""
    m_img = img.reshape(-1, 3).mean(0)
    m_ref = ref.reshape(-1, 3).mean(0)
    h = img.shape[0] // BLOCK * BLOCK
    w = img.shape[1] // BLOCK * BLOCK

    def blocks(x):
        x = x[:h, :w].reshape(h // BLOCK, BLOCK, w // BLOCK, BLOCK, 3)
        return x.mean((1, 3)), x.var((1, 3))

    b_img, v_img = blocks(img)
    b_ref, v_ref = blocks(ref)
    se = np.sqrt((v_img + v_ref) / (BLOCK * BLOCK))
    z = np.abs(b_img - b_ref) / np.maximum(se, 1e-6)
    return dict(
        mean=m_img.tolist(), mean_ref=m_ref.tolist(),
        mean_rel=(np.abs(m_img - m_ref) / np.abs(m_ref)).tolist(),
        block_z_max=float(z.max()),
        block_absmax=float(np.abs(b_img - b_ref).max()),
        bit_identical=float((img == ref).all(-1).mean()),
    )


def phase_parity() -> None:
    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.ops import megakernel as mk

    for name, w, h, mb, extra in PARITY_CASES:
        world, camera, kw = presets.PRESETS[name](width=w, height=h, **extra)
        scene = world.build()
        r = mk.MegakernelRenderer(scene, camera, kw["background"])
        ctl = jnp.asarray([0, 0, 0, 0], jnp.uint32)
        t0 = time.perf_counter()
        compiled = mk._render.trace(
            r.ks, r.cam_vec, ctl, spp=PARITY_SPP, max_bounces=mb,
            width=w, height=h, has_met=r.has_met, has_die=r.has_die,
            sky=r.sky).lower().compile()
        log(f"(b) {name} {w}x{h}: compiled in "
            f"{time.perf_counter() - t0:.2f} s; "
            f"{compiled.memory_analysis()}")
        img = np.asarray(compiled(r.ks, r.cam_vec, ctl))
        ref = reference_image(scene, camera, spp=PARITY_SPP, max_bounces=mb,
                              background=kw["background"], seed=0)
        check(img.shape == (h, w, 3) and np.isfinite(img).all(),
              f"{name}: kernel image not finite / wrong shape")
        stats = compare_images(img, ref)
        log(f"(b) {name} parity: {json.dumps(stats)}")
        check(max(stats["mean_rel"]) <= MEAN_REL_TOL,
              f"{name}: image means differ by {stats['mean_rel']}")
        check(stats["block_z_max"] <= BLOCK_Z_TOL,
              f"{name}: block means differ by {stats['block_z_max']:.2f} "
              "standard errors")


def phase_renders() -> None:
    from tinyraytracer_tpu.__main__ import main as cli_main
    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.renderer import Renderer
    from tinyraytracer_tpu.utils.image import read_png

    cam = presets.cornell_box(600, 600)[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell600.png")
        rc = cli_main(["--preset", "cornell_box", "--width", "600",
                       "--height", "600", "--spp", "200", "--out", out])
        check(rc == 0, f"CLI exited {rc}")
        png = read_png(out)
        check(png.shape == (cam.height, cam.width, 3) and png.max() > 0,
              f"CLI image wrong: shape {png.shape}, max {png.max()}")
    log(f"(c) CLI cfg3 image: mean u8 {png.reshape(-1, 3).mean(0)}")

    world, camera, kw = presets.sphere_ground(400, 225)
    scene = world.build()
    r = Renderer(samples_per_pixel=16, max_bounces=8,
                 background_color=kw["background"])
    check(r._route(scene) == "megakernel",
          f"auto route on the GPU is {r._route(scene)!r}")
    seeds = list(range(8))
    burst = np.asarray(r.render_batch_array(camera, scene, seeds))
    for i, s in enumerate(seeds):
        r.seed = s
        single = np.asarray(r.render_array(camera, scene))
        check(np.array_equal(burst[i], single),
              f"burst frame {i} differs from its single render")
    log(f"(c) burst of {len(seeds)} frames equals the single renders")


def phase_fit(device: jax.Device) -> None:
    from tinyraytracer_tpu.diff import inverse
    from tinyraytracer_tpu.diff.params import scene_params
    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.ops import trace as trace_ops

    world, camera, kw = presets.cornell_spheres(600, 600)
    scene = world.build()
    bg = jnp.asarray(kw["background"], jnp.float32)
    target = trace_ops.render_image(scene, camera, spp=16, max_bounces=20,
                                    background=bg, seed=7, nee=True)
    start = scene.replace(sph_center=scene.sph_center + jnp.where(
        scene.sph_valid[:, None], jnp.asarray([[1.0, -0.5, 1.0]]), 0.0))
    trainable = ("sph_center", "mat_albedo")
    # same argument types as fit's step, so the two share compiled programs
    grads = jax.grad(inverse.render_loss)(
        scene_params(start), start, camera, target, spp=16, max_bounces=20,
        background=bg, seed=jnp.uint32(0), spp_offset=jnp.uint32(0))
    bad = {k: int((~jnp.isfinite(g)).sum()) for k, g in grads.items()}
    log(f"(d) non-finite raw gradient entries per field: {bad}")
    check(not any(bad.values()), f"non-finite raw gradients {bad}")
    t0 = time.perf_counter()
    fitted, losses = inverse.fit(
        start, camera, target, steps=3, spp=16, max_bounces=20,
        background=kw["background"], trainable=trainable)
    log(f"(d) fit: losses {losses} in {time.perf_counter() - t0:.1f} s")
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"non-finite fit losses {losses}")
    check(bool(jnp.isfinite(fitted.sph_center).all()),
          "non-finite fitted sphere centers")
    stats = device.memory_stats() or {}
    log(f"(d) peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def phase_four_cards() -> None:
    from tinyraytracer_tpu.__main__ import main as cli_main
    from tinyraytracer_tpu.diff.inverse import make_train_step
    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.parallel.sharded import make_mesh
    from tinyraytracer_tpu.renderer import Renderer
    from tinyraytracer_tpu.utils.image import Image, read_png

    devices = jax.devices()
    check(len(devices) == 4, f"--chips 4 needs 4 GPUs, found {len(devices)}")
    world, camera, kw = presets.cornell_box(600, 600)
    scene = world.build()
    common = dict(samples_per_pixel=16, max_bounces=20,
                  background_color=kw["background"], seed=3)
    one = np.asarray(Renderer(devices=devices[:1], **common).render_array(
        camera, scene))
    tiles = np.asarray(Renderer(devices=devices, **common).render_array(
        camera, scene))
    check(np.array_equal(tiles, one), "tile-sharded render differs from "
          "one card")
    split = np.asarray(Renderer(devices=devices, sample_parallel=2,
                                **common).render_array(camera, scene))
    err = float(np.abs(split - one).max())
    check(np.allclose(split, one, rtol=1e-5, atol=1e-6),
          f"sample-split render differs from one card by {err}")
    log(f"(e) renders: 4-card tiles bitwise equal, 2x2 sample split max "
        f"abs diff {err}")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli4.png")
        rc = cli_main(["--preset", "cornell_box", "--width", "600",
                       "--height", "600", "--spp", "16", "--seed", "3",
                       "--out", out])
        check(rc == 0, f"multi-device CLI exited {rc}")
        check(np.array_equal(read_png(out), Image.from_linear(one).to_u8()),
              "multi-device CLI image differs from one card")
    log("(e) multi-device CLI image equals one card")

    world, camera, kw = presets.cornell_spheres(128, 128)
    scene = world.build()
    target = np.zeros((camera.height, camera.width, 3), np.float32)
    kw_step = dict(spp=8, max_bounces=8, background=kw["background"], seed=0,
                   trainable=("sph_center", "mat_albedo"))
    step1, (p1, s1) = make_train_step(scene, camera, target, **kw_step)
    step4, (p4, s4) = make_train_step(
        scene, camera, target, mesh=make_mesh(devices, sample_parallel=2),
        **kw_step)
    p1, _, l1 = step1(p1, s1, 0)
    p4, _, l4 = step4(p4, s4, 0)
    check(abs(float(l1) - float(l4)) <= 1e-5 * max(1.0, abs(float(l1))),
          f"sharded loss {float(l4)} vs one card {float(l1)}")
    for k in p1:
        check(np.allclose(np.asarray(p1[k]), np.asarray(p4[k]), rtol=1e-3,
                          atol=1e-6), f"sharded step param {k} differs")
    log(f"(e) sharded train step: loss {float(l4)} vs one card {float(l1)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    device = phase_device()
    from tinyraytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.chips == 4:
        phase_four_cards()
    else:
        phase_parity()
        phase_renders()
        phase_fit(device)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
