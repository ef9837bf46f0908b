"""Statistical golden-image comparison against the reference's renders.

The reference ships renders as de-facto golden artifacts (SURVEY.md §4):
  - output/output.png                  Cornell 300x300, spp=300, mb=20
                                       (src/main.rs:6-21)
  - raytracer/output/render_test.png   three-sphere scene 400x300, spp=3,
                                       mb=10 (renderer/renderer.rs:125-150)
  - raytracer/output/quad_test.png     five-quad scene 400x300, spp=10,
                                       mb=10 (hittable/quad.rs:98-151)

  - output.png                         RTiOW sphere+ground 400x225 under a
                                       GRADIENT sky — unreproducible under
                                       the surveyed snapshot's own
                                       constant-background semantics
                                       (renderer.rs:21-35), but round 4's
                                       (bottom, top) sky background
                                       reproduces it (presets.rtiow_sky;
                                       spp/mb unrecorded — RTiOW defaults
                                       assumed).

One further checked-in render is deliberately NOT a golden target:
  - output/output_highres.png (1920x1080 RTiOW cover) depends on the
    random sphere placement of a scene-generation routine that is not in
    the snapshot (main.rs builds only the Cornell box), so the layout
    cannot be reconstructed.
The camera test golden (test_ray_image_generation.png) is covered by
tests/test_golden.py::test_golden_camera_sky_gradient instead (it needs
raw get_ray access, not a Renderer).

Its RNG is unseedable (utils/random.rs:15-18), so parity is distributional,
not bitwise: we compare gamma-encoded u8 images on
  - per-channel image means (MC error of the mean is tiny at 10^5 pixels),
  - block means (image downsampled in BLOCK x BLOCK tiles — catches any
    geometry/camera misalignment immediately),
with tolerances scaled to the golden's own per-pixel MC noise at its spp.

Run:  python scripts/golden_check.py --reference DIR [--reps N] [--only NAME]
(DIR: a checkout of the reference repository). Exit code 0 = all pass.
Renders use the default Renderer (the megakernel on the GPU, the XLA
wavefront elsewhere).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (name, golden path, preset, width, height, spp, mb, mean_tol, block_tol)
#
# Cornell tolerance note: the scene's light quad is exactly coplanar with
# the ceiling quad (src/main.rs:42-59), so EVERY light-region hit is a
# z-fight decided by f32 rounding ulps. Storing primitives in the
# reference's BVH visit order (models/world.py) matches its tie semantics
# and brings the mean gap from ~24 u8 down to ~3.6 u8; the residual is the
# differing ulp statistics of the two implementations' t arithmetic (FMA
# fusion on the accelerator vs separate rounding in Rust), which cannot
# close without bit-level emulation. Tolerance is set just above that
# residual.
CONFIGS = [
    (
        # mean tol 4.5: the measured residual was [3.73 3.49 3.11],
        # leaving ~0.8 u8 of seed-to-seed headroom.
        "cornell300",
        "output/output.png",
        "cornell_box", 300, 300, 300, 20,
        4.5, 14.0,
    ),
    (
        # The 1000x1000 Cornell artifact (SURVEY.md §6 "largest
        # checked-in render"); its spp is unrecorded — the binary's
        # default (300, src/main.rs:15-17) assumed, like rtiow_sky.
        # Measured: mean diff [0.29 0.05 0.45], block p99 5.2 — MUCH
        # tighter than cornell300: at 11x the pixel count the z-fight ulp
        # statistics average out of the image mean, so the tolerance is
        # set tight (strong regression value).
        "cornell1000",
        "output/output_cornell_highres.png",
        "cornell_box", 1000, 1000, 300, 20,
        1.5, 8.0,
    ),
    (
        "render_test",
        "raytracer/output/render_test.png",
        "three_spheres", 400, 300, 3, 10,
        4.0, 18.0,
    ),
    (
        "quad_test",
        "raytracer/output/quad_test.png",
        "five_quads", 400, 300, 10, 10,
        3.0, 12.0,
    ),
    (
        # The artifact's spp/mb are unrecorded; RTiOW defaults (100, 50)
        # assumed. A wholly diffuse scene, so tolerances sit near the
        # other non-degenerate goldens'.
        # Measured: mean diff [0.03 0.03 0.02], block p99 0.5 — a fully
        # diffuse scene converges hard, so the tolerance is set tight
        # (regression value).
        "rtiow_sky",
        "output.png",
        "rtiow_sky", 400, 225, 100, 50,
        1.0, 2.5,
    ),
]

BLOCK = 20


def block_means(img: np.ndarray, block: int = BLOCK) -> np.ndarray:
    h, w, c = img.shape
    hb, wb = h // block, w // block
    img = img[: hb * block, : wb * block].astype(np.float64)
    return img.reshape(hb, block, wb, block, c).mean(axis=(1, 3))


def compare(name, golden_path, preset, width, height, spp, mb,
            mean_tol, block_tol, reps=1) -> bool:
    """Seed-averaged EQUAL-spp comparison.

    The u8 pipeline (clamp + gamma 2.2, image.rs:92-110) is concave, so a
    noisy render's u8 mean is inflated relative to the converged image
    (Jensen) — by several u8 at the goldens' low spp. Comparing a
    higher-spp render against a low-spp golden therefore diverges as OUR
    noise shrinks (measured: render_test mean gap 3.5 u8 at spp 2x, 8.6 at
    32x). The estimator that actually matches "statistically at equal
    sample counts" (BASELINE.md) renders at the golden's OWN spp — same
    per-pixel noise distribution, same gamma bias — and averages `reps`
    independent seeds of it in u8 domain to shrink our side of the MC
    error while leaving the per-render distribution untouched.
    """
    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.renderer import Renderer
    from tinyraytracer_tpu.utils.image import read_png

    golden = read_png(golden_path)[..., :3].astype(np.float64)
    world, camera, kw = presets.PRESETS[preset](width=width, height=height)
    acc = None
    for k in range(reps):
        r = Renderer(
            samples_per_pixel=spp,
            max_bounces=mb,
            background_color=kw["background"],
            seed=12345 + 977 * k,
        )
        img = r.render(camera, world).to_u8().astype(np.float64)
        acc = img if acc is None else acc + img
    ours = acc / reps
    assert ours.shape == golden.shape, (ours.shape, golden.shape)

    mean_diff = np.abs(ours.mean(axis=(0, 1)) - golden.mean(axis=(0, 1)))
    bdiff = np.abs(block_means(ours) - block_means(golden))
    # Allow the worst couple of blocks extra slack (specular/edge noise);
    # judge the 99th percentile of block means.
    b99 = np.percentile(bdiff, 99)
    ok = (mean_diff.max() <= mean_tol) and (b99 <= block_tol)
    status = "PASS" if ok else "FAIL"
    detail = (
        f"mean diff {np.round(mean_diff, 2)} (tol {mean_tol}), "
        f"block p99 {b99:.1f} max {bdiff.max():.1f} (tol {block_tol})"
    )
    print(f"{status} {name}: {detail}")
    return ok, detail


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", required=True,
                    help="checkout of the reference repository (holds the "
                         "golden renders)")
    ap.add_argument("--reps", type=int, default=3,
                    help="independent equal-spp renders averaged in u8 "
                         "domain (reduces our MC error without changing "
                         "the per-render noise distribution)")
    ap.add_argument("--only", default=None)
    ap.add_argument("--report", default=None,
                    help="write a markdown PASS table here")
    args = ap.parse_args()
    ok = True
    rows = []
    for cfg in CONFIGS:
        if args.only and cfg[0] != args.only:
            continue
        name, rel_path, *rest = cfg
        passed, detail = compare(
            name, os.path.join(args.reference, rel_path), *rest,
            reps=args.reps)
        ok &= passed
        rows.append((cfg[0], "PASS" if passed else "FAIL", detail))
    if args.report:
        import jax

        lines = [
            "# Golden parity vs reference renders",
            "",
            f"Device: {jax.devices()[0].device_kind}; equal-spp renders, "
            f"{args.reps} seed reps averaged in u8 domain; statistical "
            "comparison (the reference RNG is unseedable — see "
            "scripts/golden_check.py).",
            "",
            "| golden | result | detail |",
            "|---|---|---|",
        ]
        for name, st, detail in rows:
            lines.append(f"| {name} | {st} | {detail} |")
        with open(args.report, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {args.report}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
