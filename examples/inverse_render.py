"""Inverse rendering demo: recover Cornell sphere positions and albedos.

BASELINE.md config 5: render a target image of the cornell_spheres scene,
perturb scene parameters, then recover them by Adam on the photometric MSE
— the whole step (render with next-event estimation, backward through the
bounce loop, optimizer update, and on a mesh the gradient all-reduce) is
one jitted XLA program. Checkpoints let a long fit resume (SURVEY.md §5:
a capability the reference lacks entirely).

Material parameters (albedo, emission) enter the estimator continuously
and recover reliably. Sphere POSITIONS recover through two surrogate
boundary estimators (ops/trace.py): the NEE soft-shadow ratio and the
silhouette visibility ratio (a score-function stand-in for the edge
integral), which together pull a ~4.2-unit offset back to a fraction of
a radius (gated by tests/test_diff.py::test_silhouette_recovers_sphere_position).

Run (GPU ~minutes, CPU: lower --size/--spp/--steps):
    python examples/inverse_render.py --steps 150 --out output/inverse
    python examples/inverse_render.py --mesh 8 --sample-parallel 2  # sharded
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--refine-spp", type=int, default=128,
                    help="spp for the decay-phase steps (last 20%%): the "
                         "weakly-identified depth axis does a noise-"
                         "dominated random walk, so variance drops 4x "
                         "exactly when the LR anneals; 0 disables")
    ap.add_argument("--target-spp", type=int, default=64)
    ap.add_argument("--max-bounces", type=int, default=6)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=0.25)
    ap.add_argument("--albedo-lr", type=float, default=0.02)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over this many devices (0 = single)")
    ap.add_argument("--sample-parallel", type=int, default=1)
    ap.add_argument("--out", default="output/inverse")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--trainable", default="sph_center,mat_albedo",
                    help="comma-separated param fields to optimize "
                         "(default recovers both positions and albedos)")
    args = ap.parse_args()

    import optax

    from tinyraytracer_tpu.diff import inverse
    from tinyraytracer_tpu.diff.params import apply_params, scene_params
    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.ops import trace as trace_ops
    from tinyraytracer_tpu.utils.image import Image

    world, camera, kw = presets.cornell_spheres(width=args.size, height=args.size)
    scene = world.build()
    bg = jnp.asarray(kw["background"], jnp.float32)

    os.makedirs(args.out, exist_ok=True)

    def save(img, name):
        Image.from_linear(np.asarray(img)).save(os.path.join(args.out, name))

    # Ground-truth target — rendered with the SAME estimator family the
    # fit uses (nee=True): the training estimator clamps the NEE geometry
    # term (ops/trace.py), so a plain-path-traced target differs by a
    # small systematic residual near the light that the fit would
    # otherwise (wrongly) push geometry and albedo to chase.
    target = trace_ops.render_image(
        scene, camera, spp=args.target_spp, max_bounces=args.max_bounces,
        background=bg, seed=7, nee=True,
    )
    save(target, "target.png")

    # True parameter values to recover (sphere rows are stored in reference
    # visit order; look them up by validity mask).
    s_valid = np.asarray(scene.sph_valid)
    true_centers = np.asarray(scene.sph_center)[s_valid]
    print("true centers:\n", true_centers)

    # Perturb: nudge spheres, strongly tint albedos.
    pert = scene.replace(
        sph_center=scene.sph_center
        + jnp.where(
            jnp.asarray(s_valid)[:, None],
            jnp.asarray([[2.5, -1.5, 3.0]], jnp.float32),
            0.0,
        ),
        mat_albedo=scene.mat_albedo.at[4].set(jnp.asarray([0.6, 0.2, 0.3]))
        .at[5].set(jnp.asarray([0.3, 0.3, 0.7])),
    )
    save(
        trace_ops.render_image(
            pert, camera, spp=args.target_spp, max_bounces=args.max_bounces,
            background=bg, seed=7,
        ),
        "initial.png",
    )

    mesh = None
    if args.mesh:
        from tinyraytracer_tpu.parallel.sharded import make_mesh

        mesh = make_mesh(jax.devices()[: args.mesh],
                         sample_parallel=args.sample_parallel)
        print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")

    # Per-field learning rates: centers move tens of units, albedos are in
    # [0, 1] — a single global lr cannot serve both. Geometry holds its LR
    # for 80% of the run — the weakly-constrained depth axis converges as
    # a slow noisy drift and freezes wherever it sits once the LR decays,
    # so decaying at steps/2 (the old default) left ~1-2 units of z error
    # — then anneals so SGD noise stops the fit from wandering.
    geom_sched = optax.join_schedules(
        [optax.constant_schedule(args.lr),
         optax.exponential_decay(args.lr, transition_steps=20,
                                 decay_rate=0.5)],
        boundaries=[max(40, (args.steps * 4) // 5)],
    )
    # Geometry chain: adaptive_clip bounds the heavy-tailed boundary
    # score spikes to 4x the running gradient norm (a raw spike poisons
    # Adam's second moment and was observed kicking a sphere 5 units out
    # of its basin with no recovery); Adam runs b2=0.9 so whatever scale
    # inflation remains is forgotten in ~10 steps, not ~1000.
    optimizer = optax.multi_transform(
        {
            "geom": optax.chain(inverse.adaptive_clip(4.0),
                                optax.adam(geom_sched, b2=0.9)),
            "mat": optax.adam(args.albedo_lr),
        },
        {k: ("geom" if k.startswith(("sph_", "quad_")) else "mat")
         for k in scene_params(scene)},
    )

    def build_step(spp):
        return inverse.make_train_step(
            pert, camera, target,
            spp=spp,
            max_bounces=args.max_bounces,
            background=kw["background"],
            seed=13,
            optimizer=optimizer,
            mesh=mesh,
            trainable=tuple(args.trainable.split(",")),
        )

    step, (params, opt_state) = build_step(args.spp)

    start = 0
    ckpt = args.checkpoint
    if ckpt and os.path.exists(ckpt):
        params, opt_state, start = inverse.load_checkpoint(ckpt, opt_state)
        print(f"resumed from step {start}")

    # Refine phase: swap in a higher-spp step (same optimizer state, same
    # params) when the geometry LR starts decaying — 4x less gradient
    # noise exactly when the iterate should settle.
    refine_from = max(40, (args.steps * 4) // 5)

    # Tail-iterate (Polyak) averaging: the geometry SGD noise is heavy-
    # tailed (rare silhouette/shadow score-term spikes), so the iterate
    # random-walks ~a fraction of a radius around the optimum; averaging
    # the settled tail cancels the walk without touching the estimator.
    # The window must start AFTER the refine/anneal boundary: a window
    # spanning it mixes pre-anneal iterates (still walking at full LR and
    # 4x noise) into the mean — measured on the 2-sphere recovery, a
    # 750-start window with refine at 800 averaged to 0.54 max center
    # error while the settled iterates sat at ~0.30.
    avg_from = start + (args.steps - start) * 3 // 4
    if args.refine_spp > args.spp and refine_from < args.steps:
        avg_from = max(avg_from,
                       refine_from + (args.steps - refine_from) // 4)
    avg_params, avg_n = None, 0

    refine_step = None
    if args.refine_spp > args.spp:
        refine_step = lambda: build_step(args.refine_spp)[0]  # noqa: E731

    for i in range(start, args.steps):
        if refine_step is not None and i >= refine_from:
            step = refine_step()
            refine_step = None
            print(f"refine phase: spp -> {args.refine_spp}")
        params, opt_state, loss = step(params, opt_state, i)
        # Physical projection: albedos live in [0, 1] (keeps the fit from
        # wandering into energy-gaining materials).
        params["mat_albedo"] = jnp.clip(params["mat_albedo"], 0.0, 1.0)
        if i >= avg_from:
            avg_n += 1
            if avg_params is None:
                avg_params = dict(params)
            else:
                avg_params = {
                    k: v + (params[k] - v) / avg_n
                    for k, v in avg_params.items()
                }
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")
        if ckpt and (i + 1) % 50 == 0:
            inverse.save_checkpoint(ckpt, params, opt_state, i + 1)

    if avg_params is not None:
        params = avg_params
    fitted = apply_params(pert, params)
    save(
        trace_ops.render_image(
            fitted, camera, spp=args.target_spp, max_bounces=args.max_bounces,
            background=bg, seed=7,
        ),
        "fitted.png",
    )
    got_centers = np.asarray(fitted.sph_center)[s_valid]
    print("recovered centers:\n", got_centers)
    err = np.abs(got_centers - true_centers).max()
    print(f"max center error: {err:.3f} (initial offset ~4.2)")
    alb = np.asarray(fitted.mat_albedo)[4:6]
    print("recovered albedos (true 0.2,0.4,0.8 / 0.8,0.6,0.2):\n", alb)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
