"""Scene application / CLI — the reference binary's role (src/main.rs:5-125).

The reference hard-codes one Cornell scene in `main`; here the same scenes
are presets and the knobs the reference buries in constants are flags:

    python -m tinyraytracer_tpu                      # Cornell 300x300 spp=300
    python -m tinyraytracer_tpu --preset three_spheres --spp 100
    python -m tinyraytracer_tpu --width 600 --height 600 --spp 200 \
        --out output/cornell600.png --progress

Defaults reproduce the reference binary exactly: Cornell box, 300x300,
spp=300, max_bounces=20, background (0.001, 0.001, 0.001) (src/main.rs:6-21).
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tinyraytracer_tpu",
        description="Differentiable path tracer in JAX",
    )
    ap.add_argument("--preset", default="cornell_box",
                    help="scene preset (see models/presets.py)")
    ap.add_argument("--width", type=int, default=300)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--spp", type=int, default=300,
                    help="samples per pixel (src/main.rs:15)")
    ap.add_argument("--max-bounces", type=int, default=None,
                    help="bounce budget (default: preset's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="output/output.png",
                    help="PNG path (src/main.rs:20)")
    ap.add_argument("--progress", action="store_true",
                    help="progress bar (the indicatif analog)")
    ap.add_argument("--accelerator", default="auto",
                    choices=("auto", "megakernel", "bvh", "none"),
                    help="auto: the fused megakernel on the GPU, the "
                         "XLA wavefront (+BVH on large scenes) on the CPU; "
                         "or force a specific path")
    ap.add_argument("--sample-parallel", type=int, default=1,
                    help="devices cooperating on the same pixels")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a JAX/XLA profiler trace of the render "
                         "into DIR (view with TensorBoard or Perfetto)")
    args = ap.parse_args(argv)

    import jax

    from tinyraytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.renderer import Renderer

    if args.preset not in presets.PRESETS:
        ap.error(f"unknown preset {args.preset!r}; "
                 f"choose from {sorted(presets.PRESETS)}")
    world, camera, kw = presets.PRESETS[args.preset](
        width=args.width, height=args.height
    )
    max_bounces = (
        kw["max_bounces"] if args.max_bounces is None else args.max_bounces
    )
    if max_bounces < 1:
        ap.error("--max-bounces must be >= 1")
    devices = jax.devices()
    renderer = Renderer(
        samples_per_pixel=args.spp,
        max_bounces=max_bounces,
        progressbar=args.progress,
        background_color=kw["background"],
        seed=args.seed,
        devices=devices if len(devices) > 1 else None,
        accelerator=args.accelerator,
        sample_parallel=args.sample_parallel,
    )
    t0 = time.perf_counter()
    if args.profile:
        from tinyraytracer_tpu.utils.profiling import trace as profile_trace

        with profile_trace(args.profile):
            image = renderer.render(camera, world)
    else:
        image = renderer.render(camera, world)
    dt = time.perf_counter() - t0
    rays = args.width * args.height * args.spp
    print(f"{args.preset}: {args.width}x{args.height} spp={args.spp} "
          f"bounces={max_bounces} on {len(devices)} device(s) — "
          f"{dt:.2f}s, {rays / dt / 1e6:.2f} Mrays/s")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    image.save(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
