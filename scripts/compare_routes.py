"""Time Renderer.render_array through each render route on the GPU.

    python scripts/compare_routes.py [--reps 3] [--slow-spp-cap 16]

For each BASELINE config it times the megakernel and the plain XLA route
("none" for small scenes, "bvh" for large ones) through the public
Renderer: one warm-up render, then the best of `--reps`, each ending in
block_until_ready. The plain routes are orders of magnitude slower, so
for them the spp is capped at `--slow-spp-cap` when the config's spp is
larger (rays/s is flat in spp for a fixed image: the sample rounds run
one after another). Prints the card's name and power limit first and one
JSON line per (config, route). Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# (name, preset, width, height, spp, max_bounces, preset kwargs, plain route)
CONFIGS = (
    ("cfg3", "cornell_box", 600, 600, 200, 20, {}, "none"),
    ("cfg4", "random_spheres", 1200, 675, 500, 50, {}, "bvh"),
    ("cfg4b", "random_spheres", 400, 225, 16, 50, {"n": 8000}, "bvh"),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--slow-spp-cap", type=int, default=16)
    ap.add_argument("--only", default=None, help="one config name")
    args = ap.parse_args()

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"needs a GPU; found {device.platform!r}", file=sys.stderr)
        return 1
    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.renderer import Renderer
    from tinyraytracer_tpu.utils.compile_cache import enable_compile_cache
    from tinyraytracer_tpu.utils.device import gpu_name_and_power_limit

    enable_compile_cache()
    print(gpu_name_and_power_limit(), flush=True)
    for name, preset, w, h, spp, mb, extra, plain in CONFIGS:
        if args.only and name != args.only:
            continue
        world, camera, kw = presets.PRESETS[preset](width=w, height=h,
                                                    **extra)
        scene = world.build()
        for route in ("megakernel", plain):
            r_spp = spp if route == "megakernel" else min(
                spp, args.slow_spp_cap)
            r = Renderer(samples_per_pixel=r_spp, max_bounces=mb,
                         background_color=kw["background"],
                         accelerator=route)
            t0 = time.perf_counter()
            jax.block_until_ready(r.render_array(camera, scene))
            first = time.perf_counter() - t0
            times = []
            for i in range(args.reps):
                r.seed = i + 1
                t0 = time.perf_counter()
                jax.block_until_ready(r.render_array(camera, scene))
                times.append(time.perf_counter() - t0)
            best = min(times)
            print(json.dumps({
                "config": name, "route": route, "width": w, "height": h,
                "spp": r_spp, "max_bounces": mb, "first_s": first,
                "times_s": times, "best_s": best,
                "rays_per_s": w * h * r_spp / best,
                "device_kind": device.device_kind}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
