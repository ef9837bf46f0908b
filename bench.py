"""Benchmark harness: the BASELINE.md render configs + fwd+bwd, one JSON line.

Headline metric (BASELINE.md north star): forward camera-rays/sec on
Cornell 600×600 spp=200 through the public Renderer (which routes to the
GPU megakernel, ops/megakernel.py). The other BASELINE configs (RTiOW
sphere, three-sphere materials, 500- and 8000-primitive random spheres)
and the inverse-rendering train step (make_train_step) are measured every
run so scale regressions are visible.

Runs on the GPU only: with no GPU it exits non-zero and prints no result.
Every number is printed beside the device it was measured on.

The reference publishes no numbers (BASELINE.md: two-line README, no
benchmarks dir), so vs_baseline uses an estimated 1e7 camera rays/sec for
the reference's 8-thread Rust CPU tracer on this scene class; the estimate
is recorded in "baseline_estimate".
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

from tinyraytracer_tpu.utils.compile_cache import enable_compile_cache
from tinyraytracer_tpu.utils.device import gpu_name_and_power_limit

BASELINE_RAYS_PER_SEC = 1.0e7  # estimated reference CPU throughput

# (key, preset, width, height, spp, max_bounces, preset kwargs) —
# BASELINE.md configs 1-4 and the 8000-sphere large-scene config.
FWD_CONFIGS = (
    ("cfg1_sphere_ground_400x225_spp16", "sphere_ground", 400, 225, 16, 8,
     {}),
    ("cfg2_three_spheres_400x225_spp100", "three_spheres", 400, 225, 100, 50,
     {}),
    ("cfg3_cornell_600x600_spp200", "cornell_box", 600, 600, 200, 20, {}),
    ("cfg4_random_spheres_1200x675_spp500", "random_spheres",
     1200, 675, 500, 50, {}),
    ("cfg4b_random8000_400x225_spp16", "random_spheres", 400, 225, 16, 50,
     {"n": 8000}),
)


def _best_of(f, n=3):
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        f(i + 1)
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> int:
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py measures the GPU; found {device.platform!r}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.renderer import Renderer

    card = gpu_name_and_power_limit()
    print(card)
    result = {"device": {"platform": device.platform,
                         "kind": device.device_kind,
                         "count": len(jax.devices())},
              "card": card}

    for key, preset, w, h, spp, mb, extra in FWD_CONFIGS:
        world, camera, kw = presets.PRESETS[preset](width=w, height=h,
                                                    **extra)
        scene = world.build()
        r = Renderer(samples_per_pixel=spp, max_bounces=mb,
                     background_color=kw["background"])
        result[key + "_route"] = r._route(scene)

        def once(s):
            r.seed = s
            jax.block_until_ready(r.render_array(camera, scene))

        once(0)
        dt = _best_of(once)
        result[key] = w * h * spp / dt
        result[key + "_wall_s"] = dt
        if key.startswith("cfg1"):
            # cfg1 is dispatch-bound: burst 8 seed-renders into one XLA
            # program and record the per-image rate and dispatch overhead.
            nb = 8
            jax.block_until_ready(r.render_batch_array(camera, scene,
                                                       range(nb)))
            bdt = _best_of(lambda s: jax.block_until_ready(
                r.render_batch_array(camera, scene, range(nb)))) / nb
            result[key + "_burst8_per_image"] = w * h * spp / bdt
            result["cfg1_dispatch_overhead_ms"] = (dt - bdt) * 1e3

    _bench_fwdbwd(result, "fwdbwd", "cornell_box", None)
    _bench_fwdbwd(result, "fwdbwd_cfg5", "cornell_spheres",
                  ("sph_center", "mat_albedo"))

    fwd_rays = result["cfg3_cornell_600x600_spp200"]
    result.update(
        metric="fwd_camera_rays_per_sec_cornell600_spp200",
        value=fwd_rays,
        unit="rays/sec",
        vs_baseline=fwd_rays / BASELINE_RAYS_PER_SEC,
        baseline_estimate=BASELINE_RAYS_PER_SEC,
    )
    print(json.dumps(result))
    return 0


def _bench_fwdbwd(result, key, preset, trainable) -> None:
    """Inverse-rendering train step (render + MSE + backward + Adam) at
    Cornell 300×300 spp=16 mb=8 through make_train_step."""
    from tinyraytracer_tpu.diff.inverse import make_train_step
    from tinyraytracer_tpu.models import presets

    w, h, spp, mb = 300, 300, 16, 8
    world, camera, kw = presets.PRESETS[preset](width=w, height=h)
    scene = world.build()
    target = jnp.zeros((h, w, 3), jnp.float32)
    step, (params, opt_state) = make_train_step(
        scene, camera, target, spp=spp, max_bounces=mb,
        background=kw["background"], seed=0, trainable=trainable,
    )
    params, opt_state, _ = step(params, opt_state, 0)
    jax.block_until_ready((params, opt_state))
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, i + 1)
        jax.block_until_ready((params, opt_state, loss))
        times.append(time.perf_counter() - t0)
    dt = min(times)
    result[key + "_rays_per_sec"] = w * h * spp / dt
    result[key + "_step_ms"] = dt * 1e3
    result[key + "_config"] = (
        f"{preset} {w}x{h} spp={spp} mb={mb} trainable={trainable}")


if __name__ == "__main__":
    raise SystemExit(main())
