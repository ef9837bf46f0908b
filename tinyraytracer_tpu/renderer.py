"""User-facing Renderer, mirroring the reference API surface.

Reference: `Renderer::new(samples_per_pixel, num_sampler_threads, max_bounces,
progressbar, background_color)` + `render(camera, world) -> Image`
(renderer/renderer.rs:21-79). The three-stage channel pipeline
(pointgen -> sampler -> imager) is not load-bearing here: generation,
tracing, and accumulation fuse into one compiled program (the GPU
megakernel, ops/megakernel.py, or the XLA wavefront, ops/trace.py). What
remains of "num_sampler_threads" is the device mesh — pass `devices` to
shard pixels across devices (parallel/); on a single device it is ignored,
exactly as thread count never changed the reference's output.

Which program renders is decided in one place, `choose_route`, from the
device's platform and the scene's primitive count.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tinyraytracer_tpu.models.camera import Camera
from tinyraytracer_tpu.models.world import World, SceneArrays
from tinyraytracer_tpu.ops import trace as trace_ops
from tinyraytracer_tpu.ops import tonemap
from tinyraytracer_tpu.utils.image import Image
from tinyraytracer_tpu.utils.progress import ProgressBar

ACCELERATORS = ("auto", "megakernel", "bvh", "none")

# Valid-primitive count above which the plain path walks the BVH.
BVH_AUTO_THRESHOLD = 192

# Largest scene (valid primitives) for which "auto" picks the megakernel on
# the GPU. The kernel loops over every primitive per bounce, so its cost
# grows linearly with the scene while the BVH walk's grows slowly; it was
# measured faster than both XLA routes at every size tried, up to 8000
# spheres (PERF.md), and larger scenes keep the BVH until measured.
MEGAKERNEL_MAX_PRIMS = 8192


def choose_route(platform: str, n_prims: int, accelerator: str = "auto",
                 interpret: bool = False) -> str:
    """The render path for a device platform and scene size.

    Returns "megakernel" (the fused GPU kernel), "bvh" (the XLA wavefront
    with BVH traversal) or "none" (the XLA wavefront over all primitives).

      - `accelerator` forces a path; "auto" chooses: the megakernel on the
        GPU up to MEGAKERNEL_MAX_PRIMS primitives, else the plain path,
        with the BVH above BVH_AUTO_THRESHOLD primitives. On the CPU
        "auto" is always the plain path.
      - The megakernel compiles only for the GPU. On the CPU it runs only
        through the Pallas interpreter, and only when the caller (a test)
        asks for that with `interpret=True`; forcing it otherwise raises.
      - A platform this function does not know is an error.
    """
    if accelerator not in ACCELERATORS:
        raise ValueError(f"unknown accelerator {accelerator!r}")
    if platform not in ("cpu", "gpu"):
        raise ValueError(f"no render route for platform {platform!r}")
    if interpret and platform != "cpu":
        raise ValueError("interpret mode is for CPU tests only")
    if accelerator == "megakernel":
        if platform == "cpu" and not interpret:
            raise ValueError(
                "the megakernel compiles only for the GPU; on the CPU it "
                "runs only in interpret mode (interpret=True)")
        return "megakernel"
    if accelerator != "auto":
        return accelerator
    if platform == "gpu" and n_prims <= MEGAKERNEL_MAX_PRIMS:
        return "megakernel"
    return "bvh" if n_prims > BVH_AUTO_THRESHOLD else "none"


class RenderHandle:
    """Handle to an asynchronously dispatched render (the analog of the
    reference's `JoinHandle<Image>`, renderer/renderer.rs:37-79).
    XLA executes the dispatched program in the background; the host only
    blocks when `.result()` materializes the Image."""

    def __init__(self, fb: jax.Array):
        self._fb = fb

    def done(self) -> bool:
        """True once the device computation has finished (non-blocking)."""
        try:
            return bool(self._fb.is_ready())
        except AttributeError:  # pragma: no cover - older jax fallback
            return True

    def result(self) -> Image:
        """Block until the render finishes; returns the gamma-2.2 Image."""
        return Image.from_linear(np.asarray(self._fb), gamma=tonemap.GAMMA)


class Renderer:
    def __init__(
        self,
        samples_per_pixel: int,
        num_sampler_threads: int = 0,  # accepted for API parity; unused
        max_bounces: int = 20,
        progressbar: bool = False,
        background_color: Optional[Tuple[float, float, float]] = None,
        seed: int = 0,
        devices: Optional[Sequence[jax.Device]] = None,
        spp_per_round: int = 0,
        accelerator: str = "auto",
        sample_parallel: int = 1,
        interpret: bool = False,
    ):
        self.samples_per_pixel = int(samples_per_pixel)
        self.max_bounces = int(max_bounces)
        self.progressbar = bool(progressbar)
        # default background is black (renderer.rs:33). A ((r,g,b),
        # (r,g,b)) pair is a GRADIENT SKY [bottom, top], lerped on the
        # unit miss direction's y — the capability behind the reference's
        # checked-in output.png, which its surveyed snapshot (constant
        # background only) can no longer produce.
        self.background_color = (
            (0.0, 0.0, 0.0) if background_color is None else tuple(background_color)
        )
        self.seed = int(seed)
        self.devices = devices
        # Progress granularity: samples per jit call when progressbar is on.
        self.spp_per_round = int(spp_per_round) if spp_per_round else 0
        # "auto" | "megakernel" | "bvh" | "none" — see choose_route.
        if accelerator not in ACCELERATORS:
            raise ValueError(f"unknown accelerator {accelerator!r}")
        self.accelerator = accelerator
        # interpret=True runs a forced megakernel through the Pallas
        # interpreter on the CPU (tests only; see choose_route).
        self.interpret = bool(interpret)
        # Devices cooperating on the same pixels (splitting spp); the rest
        # of the mesh splits the pixel grid. spp must be divisible by it.
        self.sample_parallel = int(sample_parallel) if sample_parallel else 1
        if self.samples_per_pixel % self.sample_parallel:
            raise ValueError(
                f"samples_per_pixel={self.samples_per_pixel} not divisible "
                f"by sample_parallel={self.sample_parallel}"
            )

    # -- routing -------------------------------------------------------------

    def _multi_device(self) -> bool:
        return self.devices is not None and len(self.devices) > 1

    def _route(self, scene: SceneArrays) -> str:
        device = self.devices[0] if self.devices else jax.devices()[0]
        n_prims = int(np.asarray(scene.sph_valid).sum()) + int(
            np.asarray(scene.quad_valid).sum())
        return choose_route(device.platform, n_prims, self.accelerator,
                            self.interpret)

    def _mesh(self):
        if not self._multi_device():
            return None
        from tinyraytracer_tpu.parallel.sharded import make_mesh

        return make_mesh(self.devices, sample_parallel=self.sample_parallel)

    def _megakernel(self, camera: Camera, scene: SceneArrays):
        from tinyraytracer_tpu.ops.megakernel import MegakernelRenderer

        return MegakernelRenderer(scene, camera, self.background_color,
                                  interpret=self.interpret)

    @staticmethod
    def _bvh(route: str, scene: SceneArrays):
        if route != "bvh":
            return None
        from tinyraytracer_tpu.ops.bvh import build_bvh

        return build_bvh(scene)

    # -- core --------------------------------------------------------------

    def render_array(self, camera: Camera, scene: SceneArrays) -> jax.Array:
        """Linear-radiance (H, W, 3) framebuffer on device."""
        route = self._route(scene)
        if route == "megakernel":
            return self._megakernel(camera, scene).render(
                spp=self.samples_per_pixel,
                max_bounces=self.max_bounces,
                seed=self.seed,
                mesh=self._mesh(),
            )
        bvh = self._bvh(route, scene)
        if self._multi_device():
            from tinyraytracer_tpu.parallel.sharded import render_image_sharded

            return render_image_sharded(
                scene,
                camera,
                spp=self.samples_per_pixel,
                max_bounces=self.max_bounces,
                background=self.background_color,
                seed=self.seed,
                devices=self.devices,
                bvh=bvh,
                sample_parallel=self.sample_parallel,
            )
        return trace_ops.render_image(
            scene,
            camera,
            spp=self.samples_per_pixel,
            max_bounces=self.max_bounces,
            background=jnp.asarray(self.background_color, jnp.float32),
            seed=self.seed,
            bvh=bvh,
        )

    def render(self, camera: Camera, world: World) -> Image:
        """Full render to a gamma-2.2 Image (the reference's end product)."""
        scene = world.build() if isinstance(world, World) else world
        if self.progressbar:
            fb = self._render_with_progress(camera, scene)
        else:
            fb = self.render_array(camera, scene)
        return Image.from_linear(np.asarray(fb), gamma=tonemap.GAMMA)

    def render_async(self, camera: Camera, world: World) -> "RenderHandle":
        """Dispatch a render and return a handle; the reference's analog
        is `Renderer::render` returning a `JoinHandle<Image>` so the host
        can overlap work (raytracer/src/renderer/renderer.rs:37-79). XLA
        dispatch is already asynchronous — the returned handle wraps the
        undispatched device array; `.result()` blocks on the host copy,
        `.done()` polls without blocking."""
        scene = world.build() if isinstance(world, World) else world
        return RenderHandle(self.render_array(camera, scene))

    def render_batch_array(self, camera: Camera, scene: SceneArrays,
                           seeds) -> jax.Array:
        """len(seeds) independent linear-radiance frames -> (n, H, W, 3).

        On the megakernel route this bakes every seed-render into ONE
        XLA program (MegakernelRenderer.render_burst), paying the host
        dispatch once for the whole batch — small frames are
        dispatch-bound, so animation/batch workloads through the public
        API run at burst throughput instead of the single-image rate.
        Other routes render per seed and stack. Each frame is
        bit-identical to a single render with that seed."""
        seeds = tuple(int(s) for s in seeds)
        scene = scene.build() if isinstance(scene, World) else scene
        if self._route(scene) == "megakernel" and not self._multi_device():
            # Cache the scene-bound renderer across calls: render_burst's
            # compiled N-seed program lives on the instance, and repeated
            # batch calls (the animation use case) must reuse it rather
            # than recompile per call.
            cached = getattr(self, "_burst_mk", None)
            if (cached is None or cached[0] is not scene
                    or cached[1] is not camera):
                cached = (scene, camera, self._megakernel(camera, scene))
                self._burst_mk = cached
            return cached[2].render_burst(
                spp=self.samples_per_pixel,
                max_bounces=self.max_bounces,
                seeds=seeds,
            )
        frames = []
        old_seed = self.seed
        try:
            for s in seeds:
                self.seed = s
                frames.append(self.render_array(camera, scene))
        finally:
            self.seed = old_seed
        return jnp.stack(frames)

    def render_batch(self, camera: Camera, world: World, seeds) -> list:
        """len(seeds) full gamma-2.2 Images (one per seed) — the batch /
        animation form of render(). See render_batch_array for why this
        is much faster than a render() loop on the megakernel route."""
        scene = world.build() if isinstance(world, World) else world
        fb = np.asarray(self.render_batch_array(camera, scene, seeds))
        return [Image.from_linear(fb[i], gamma=tonemap.GAMMA)
                for i in range(fb.shape[0])]

    def _render_with_progress(self, camera: Camera, scene: SceneArrays):
        """Chunk samples into rounds so the host can tick a progress bar —
        the analog of the reference's per-pixel indicatif ticks
        (renderer/imager.rs:52-57), at per-sample-round granularity (per-ray
        callbacks would serialize the device)."""
        spp = self.samples_per_pixel
        chunk = self.spp_per_round or max(1, spp // 20)
        mesh = self._mesh()
        if mesh is not None:
            from tinyraytracer_tpu.parallel.sharded import SAMPLE_AXIS

            n_sample = mesh.shape[SAMPLE_AXIS]
            # spp chunks must stay divisible by the sample axis; the
            # __init__ divisibility check on spp itself guarantees the
            # tail round (spp - off) is a multiple of n_sample too.
            chunk = max(n_sample, (chunk // n_sample) * n_sample)
        rounds = [
            (off, min(chunk, spp - off)) for off in range(0, spp, chunk)
        ]
        w, h = camera.width, camera.height
        bar = ProgressBar(total=spp, label="spp")
        route = self._route(scene)
        if route == "megakernel":
            mk = self._megakernel(camera, scene)
            acc = jnp.zeros((h, w, 3), jnp.float32)
            for off, n in rounds:
                part = mk.render(
                    spp=n, max_bounces=self.max_bounces,
                    seed=self.seed, spp_offset=off, mesh=mesh,
                )
                acc = acc + part * (n / spp)
                bar.update(n)
            bar.close()
            return acc
        bvh = self._bvh(route, scene)
        if mesh is not None:
            # Plain path over the mesh: each progress round is a sharded
            # render of its sample slice (chunks partition [0, spp)).
            from tinyraytracer_tpu.parallel.sharded import render_image_sharded

            acc = jnp.zeros((h, w, 3), jnp.float32)
            for off, n in rounds:
                part = render_image_sharded(
                    scene, camera, spp=n, max_bounces=self.max_bounces,
                    background=self.background_color, seed=self.seed,
                    mesh=mesh, spp_offset=off, bvh=bvh,
                )
                acc = acc + part * (n / spp)
                bar.update(n)
            bar.close()
            return acc
        pixel_id = jnp.arange(w * h, dtype=jnp.uint32)
        acc = jnp.zeros((w * h, 3), jnp.float32)
        render_chunk = jax.jit(
            trace_ops.render_pixels,
            static_argnames=("spp", "max_bounces", "exact"),
        )
        for off, n in rounds:
            part = render_chunk(
                scene,
                camera,
                pixel_id,
                spp=n,
                max_bounces=self.max_bounces,
                background=jnp.asarray(self.background_color, jnp.float32),
                seed=jnp.uint32(self.seed),
                spp_offset=jnp.uint32(off),
                bvh=bvh,
            )
            acc = acc + part * (n / spp)
            bar.update(n)
        bar.close()
        return acc.reshape(h, w, 3)
