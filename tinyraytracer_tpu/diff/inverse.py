"""Inverse rendering: gradient-descent recovery of scene parameters.

BASELINE.md config 5: recover Cornell sphere positions / albedos from a
target image by gradient descent, sharded across the device mesh. The
reference has no differentiability at all (SURVEY.md §5) — this is the
new-capability half of the north star.

Design notes:
  - The renderer is an expectation over (pixel jitter, scatter) randomness;
    the loss uses a *fresh sample round per step* (spp_offset advances with
    the step counter), so optimization is stochastic gradient descent over
    the true expected-loss landscape rather than overfitting one noise draw.
  - Discrete events (closest-hit argmin, dielectric reflect-vs-refract,
    light absorption) are detached by construction in ops/ — gradients flow
    through the continuous geometry/shading terms (reparameterized sampling:
    scatter directions are smooth functions of the surface normal).
  - The whole step (render → loss → backward → optimizer update, with the
    sample-axis pmean and the tile-axis gradient psum that shard_map's
    transpose inserts) is ONE jitted XLA program; the scene-gradient
    all-reduce overlaps with the backward bounce loop under XLA's scheduler.
  - Optimizer state checkpointing (save/restore) covers the reference's
    missing checkpoint/resume subsystem (SURVEY.md §5) for long fits.
"""

from __future__ import annotations

import os
import pickle
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P

from tinyraytracer_tpu.diff.params import Params, apply_params, scene_params
from tinyraytracer_tpu.models.camera import Camera
from tinyraytracer_tpu.models.world import SceneArrays
from tinyraytracer_tpu.ops import trace as trace_ops
from tinyraytracer_tpu.parallel import sharded


def image_mse(img, target):
    """Mean squared error in linear radiance."""
    return jnp.mean((img - target) ** 2)


def adaptive_clip(threshold: float = 4.0, decay: float = 0.9,
                  eps: float = 1e-12) -> optax.GradientTransformation:
    """Clip each gradient leaf to `threshold` x its own running RMS norm.

    The boundary surrogates (NEE soft shadow, silhouette ratio) are
    score-function estimators with heavy tails: a single near-tangent ray
    can contribute 10-100x the typical whole-image gradient. A fixed clip
    threshold can't serve fields whose scales differ by 10^4 (centers vs
    albedos), so the threshold adapts: an EMA of each leaf's gradient norm
    is tracked, and the leaf is rescaled whenever its norm exceeds
    threshold x EMA. The EMA updates with the CLIPPED norm, so one spike
    can't ratchet the gate open for the next.

    Unlike median-of-chunks aggregation this keeps 100% of the mean
    gradient direction — sparse boundary signal (a few informative rays
    per step) passes through; only the magnitude of outlier steps is
    bounded. Chain it in FRONT of Adam: what it protects is Adam's second
    moment, which one unclipped spike poisons for ~1/(1-b2) steps.
    """

    def init(params):
        return {"ema": jax.tree.map(lambda p: jnp.zeros((), jnp.float32),
                                    params),
                "count": jnp.zeros((), jnp.int32)}

    def update(updates, state, params=None):
        del params
        count = state["count"] + 1
        warm = count <= 3  # track-only warmup: no trusted scale yet

        def one(g, ema):
            n = jnp.sqrt(jnp.sum(g.astype(jnp.float32) ** 2) + eps)
            limit = threshold * ema
            scale = jnp.where(
                warm | (ema <= eps) | (n <= limit), 1.0, limit / n)
            g_clip = g * scale
            n_clip = jnp.minimum(n, jnp.where(warm | (ema <= eps),
                                              n, limit))
            new_ema = jnp.where(
                count == 1, n_clip, decay * ema + (1.0 - decay) * n_clip)
            return g_clip, new_ema

        leaves, treedef = jax.tree.flatten(updates)
        emas = treedef.flatten_up_to(state["ema"])
        out = [one(g, e) for g, e in zip(leaves, emas)]
        new_updates = treedef.unflatten([o[0] for o in out])
        new_ema = treedef.unflatten([o[1] for o in out])
        return new_updates, {"ema": new_ema, "count": count}

    return optax.GradientTransformation(init, update)


@partial(
    jax.jit,
    static_argnames=("spp", "max_bounces", "exact", "nee", "silhouette"),
)
def render_loss(
    params: Params,
    scene: SceneArrays,
    camera: Camera,
    target,
    *,
    spp: int,
    max_bounces: int,
    background,
    seed,
    spp_offset=0,
    exact: bool = False,
    nee: bool = True,
    silhouette: bool = True,
):
    """Single-device MSE between a fresh render and the target image.

    NEE is on by default: without explicit light sampling the pathwise
    gradient w.r.t. geometry is exactly zero a.e. (see ops.trace.trace).
    """
    s = apply_params(scene, params)
    w, h = camera.width, camera.height
    pixel_id = jnp.arange(w * h, dtype=jnp.uint32)
    img = trace_ops.render_pixels(
        s,
        camera,
        pixel_id,
        spp=spp,
        max_bounces=max_bounces,
        background=background,
        seed=seed,
        exact=exact,
        spp_offset=spp_offset,
        nee=nee,
        silhouette=silhouette,
        fuse_spp=True,
    )
    return image_mse(img, target.reshape(-1, 3))


def make_train_step(
    scene_template: SceneArrays,
    camera: Camera,
    target,
    *,
    spp: int,
    max_bounces: int,
    background,
    seed: int = 0,
    optimizer: Optional[optax.GradientTransformation] = None,
    learning_rate: float = 1e-2,
    mesh: Optional[Mesh] = None,
    advance_samples: bool = True,
    trainable: Optional[Tuple[str, ...]] = None,
    nee: bool = True,
    silhouette: bool = True,
    grad_chunks: int = 1,
) -> Tuple[Callable, Tuple[Params, optax.OptState]]:
    """Build an SGD step over the scene params (optionally sharded).

    grad_chunks > 1: elementwise-median-of-chunks robust gradient (split
    the step's spp into N chunks, take the median of the N chunk
    gradients). The boundary surrogates' score terms are heavy-tailed — a
    single near-tangent shadow/silhouette ray can contribute 10-100x the
    typical whole-image gradient, and one such spike poisons Adam's second
    moment for ~1/(1-b2) steps; a spike living in one chunk is voted out,
    while smooth components (identical in expectation across chunks) pass
    through. Single-device path only.

    Returns (step, (params0, opt_state0)); step(params, opt_state, step_idx)
    -> (params, opt_state, loss). When `mesh` is given, pixels shard over
    its "tile" axis and samples over its "sample" axis; shard_map's
    transpose inserts the cross-device psum on the replicated scene grads.

    `advance_samples` (default): each step draws a fresh sample round, i.e.
    true SGD over the expected loss. Note the estimator-variance bias this
    carries at tiny spp: E||X - t||^2 = ||EX - t||^2 + Var(X), so the
    optimizer also descends Var(X) and the minimizer shifts off the true
    scene. Use a generous spp for recovery tasks, or set
    advance_samples=False to fit the fixed sample estimator exactly (useful
    when the target was rendered with the same seed/spp).

    `trainable` restricts optimization to the named param fields (e.g.
    ("sph_center", "mat_albedo") for the config-5 recovery task); gradients
    of the other fields are zeroed. With every field free, the problem is
    badly under-determined — geometry changes can compensate for material
    changes and reach near-zero loss away from the true scene.
    """
    optimizer = optimizer or optax.adam(learning_rate)
    background = jnp.asarray(background, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    base_seed = jnp.uint32(seed)

    if mesh is not None:
        n_tile = mesh.shape[sharded.TILE_AXIS]
        n_sample = mesh.shape[sharded.SAMPLE_AXIS]
        if spp % n_sample != 0:
            raise ValueError(f"spp={spp} not divisible by sample axis {n_sample}")
        spp_local = spp // n_sample
        stride = jnp.uint32(spp if advance_samples else 0)
        w, h = camera.width, camera.height
        npix = w * h
        pixel_id = sharded._padded_pixel_ids(npix, n_tile)
        total = pixel_id.shape[0]
        # Pad the target the same way so pixel/target stay aligned per shard.
        tgt_flat = target.reshape(-1, 3)
        tgt_pad = jnp.take(tgt_flat, jnp.asarray(pixel_id, jnp.int32), axis=0)
        # Padded duplicate pixels would double-count in the loss; weight them 0.
        weight = (jnp.arange(total, dtype=jnp.uint32) < jnp.uint32(npix)).astype(
            jnp.float32
        )

        def loss_fn(params, step_idx):
            s = apply_params(scene_template, params)

            def body(scene, camera, background, tgt, wgt, pids):
                s_idx = jax.lax.axis_index(sharded.SAMPLE_AXIS).astype(jnp.uint32)
                img = trace_ops.render_pixels(
                    scene,
                    camera,
                    pids,
                    spp=spp_local,
                    max_bounces=max_bounces,
                    background=background,
                    seed=base_seed,
                    spp_offset=step_idx * stride
                    + s_idx * jnp.uint32(spp_local),
                    nee=nee,
                    silhouette=silhouette,
                    fuse_spp=True,
                )
                img = jax.lax.pmean(img, sharded.SAMPLE_AXIS)
                se = jnp.sum(wgt[:, None] * (img - tgt) ** 2)
                return jax.lax.psum(se, sharded.TILE_AXIS)

            f = jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(
                    P(),
                    P(),
                    P(),
                    P(sharded.TILE_AXIS),
                    P(sharded.TILE_AXIS),
                    P(sharded.TILE_AXIS),
                ),
                out_specs=P(),
                check_vma=False,  # see parallel/sharded.py
            )
            se = f(s, camera, background, tgt_pad, weight, pixel_id)
            return se / jnp.float32(npix * 3)

        loss_fn = jax.jit(loss_fn)

    else:
        stride = jnp.uint32(spp if advance_samples else 0)

        def make_loss(spp_eff):
            def loss_fn(params, step_idx, extra_off=jnp.uint32(0)):
                return render_loss(
                    params,
                    scene_template,
                    camera,
                    target,
                    spp=spp_eff,
                    max_bounces=max_bounces,
                    background=background,
                    seed=base_seed,
                    spp_offset=step_idx * stride + extra_off,
                    nee=nee,
                    silhouette=silhouette,
                )

            return loss_fn

        loss_fn = make_loss(spp)

    if grad_chunks < 1 or (grad_chunks > 1 and mesh is not None):
        raise ValueError("grad_chunks needs the single-device path")
    if spp % grad_chunks:
        raise ValueError(f"grad_chunks={grad_chunks} must divide spp={spp}")
    chunk_loss = make_loss(spp // grad_chunks) if grad_chunks > 1 else None

    trainset = None if trainable is None else frozenset(trainable)

    @jax.jit
    def update(params, opt_state, grads):
        # Gradient sanitization: a single degenerate sample (a device's
        # approximate transcendentals can hit edges the CPU path does not)
        # would otherwise NaN the optimizer state permanently. Zeroing the
        # rare non-finite entries keeps the fit unbiased in expectation.
        grads = {
            k: jnp.where(jnp.isfinite(g), g, 0.0) for k, g in grads.items()
        }
        if trainset is not None:
            grads = {
                k: g if k in trainset else jnp.zeros_like(g)
                for k, g in grads.items()
            }
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def step(params, opt_state, step_idx):
        # Not jitted as a whole: value_and_grad of the jitted loss compiles
        # its forward and its backward as two XLA programs. As one program
        # together with the update, the 600x600 NEE step did not finish
        # compiling on an H100 within 15 minutes; the two halves compile
        # in seconds.
        step_idx = jnp.uint32(step_idx)
        if grad_chunks == 1:
            loss, grads = jax.value_and_grad(loss_fn)(params, step_idx)
        else:
            cspp = spp // grad_chunks
            losses, gs = [], []
            for c in range(grad_chunks):
                cl, cg = jax.value_and_grad(chunk_loss)(
                    params, step_idx, jnp.uint32(c * cspp),
                )
                losses.append(cl)
                gs.append(cg)
            loss = sum(losses) / grad_chunks
            grads = {
                k: jnp.median(jnp.stack([g[k] for g in gs]), axis=0)
                for k in gs[0]
            }
        params, opt_state = update(params, opt_state, grads)
        return params, opt_state, loss

    params0 = scene_params(scene_template)
    return step, (params0, optimizer.init(params0))


# ---------------------------------------------------------------------------
# Checkpoint / resume (SURVEY.md §5: a capability the reference lacks).
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, params: Params, opt_state, step: int) -> None:
    """Persist optimizer progress; atomic rename so a crash never corrupts."""
    state = {
        "params": jax.tree.map(np.asarray, params),
        "opt_state": jax.tree.map(np.asarray, opt_state),
        "step": int(step),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)


def load_checkpoint(path: str, opt_state_template=None):
    """Returns (params, opt_state, step). opt_state arrays are re-hosted as
    jnp; the template (from optimizer.init) restores the pytree structure."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    params = jax.tree.map(jnp.asarray, state["params"])
    opt_state = state["opt_state"]
    if opt_state_template is not None:
        leaves = jax.tree.leaves(opt_state)
        treedef = jax.tree.structure(opt_state_template)
        opt_state = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    return params, opt_state, state["step"]


def fit(
    scene_template: SceneArrays,
    camera: Camera,
    target,
    *,
    steps: int,
    spp: int,
    max_bounces: int,
    background,
    seed: int = 0,
    learning_rate: float = 1e-2,
    optimizer: Optional[optax.GradientTransformation] = None,
    trainable: Optional[Tuple[str, ...]] = None,
    mesh: Optional[Mesh] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 50,
    log_every: int = 0,
    average_last: int = 0,
) -> Tuple[SceneArrays, list]:
    """Run `steps` of Adam on the scene params; returns (scene, loss curve).

    `trainable` names the free param fields (strongly recommended — with
    every field free the problem is under-determined, see make_train_step);
    `optimizer` overrides the default Adam. Resumes from `checkpoint_path`
    if it exists.

    `average_last`: if > 0, the returned scene uses the Polyak average of
    the final N iterates instead of the last one — geometry fits have
    heavy-tailed gradient noise (silhouette/shadow score-term spikes) and
    the iterate random-walks around the optimum; tail averaging cancels
    the walk.
    """
    step_fn, (params, opt_state) = make_train_step(
        scene_template,
        camera,
        target,
        spp=spp,
        max_bounces=max_bounces,
        background=background,
        seed=seed,
        learning_rate=learning_rate,
        optimizer=optimizer,
        trainable=trainable,
        mesh=mesh,
    )
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        params, opt_state, start = load_checkpoint(checkpoint_path, opt_state)
    losses = []
    avg_from = max(start, steps - average_last) if average_last else steps
    avg_params, avg_n = None, 0
    for i in range(start, steps):
        params, opt_state, loss = step_fn(params, opt_state, i)
        # Keep the device scalar: float(loss) here would sync every step
        # and serialize dispatch against execution. Materialized at
        # log/return boundaries only.
        losses.append(loss)
        if i >= avg_from:
            avg_n += 1
            if avg_params is None:
                avg_params = dict(params)
            else:
                avg_params = {
                    k: v + (params[k] - v) / avg_n
                    for k, v in avg_params.items()
                }
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps}  loss {float(loss):.6f}")
        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, params, opt_state, i + 1)
    if avg_params is not None:
        params = avg_params
    return apply_params(scene_template, params), [float(x) for x in losses]
