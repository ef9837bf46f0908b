"""Multi-device rendering over a 2-D (tile × sample) mesh via shard_map.

The reference's only parallelism is worker tasks over shared channels
(sampler/cpu.rs:76-83) and 10,240-ray GPU batches (metal/sampler.rs:11).
This formulation (SURVEY.md §2 parallelism table, §7 phase 9):

  - "tile" axis: the flat pixel grid is sharded across devices — data
    parallelism over rays, the analog of the reference's worker fan-out,
    except the partition is static so no work-stealing channel is needed;
  - "sample" axis: samples-per-pixel are split across devices and the
    partial framebuffers combined with a `pmean` across devices — the analog of
    the Imager's accumulation (renderer/imager.rs:46-51), except it is a
    single XLA collective instead of a consumer task.

Scene and camera are replicated (scenes are KBs; rays are the big tensor).
The per-ray counter RNG keys on (seed, pixel_id, global sample_id), so every
sample's radiance is bitwise placement-invariant; the final pixel differs
across mesh shapes only by f32 summation order in the sample reduction
(tile-only meshes are bitwise equal to one device; sample-split meshes are
within 1 ulp). This is the SURVEY.md §7 "multi-host determinism" gate.

For several hosts, call `jax.distributed.initialize()` first; everything
here is expressed over the global mesh, and XLA routes the sample-axis
`pmean` over the devices' interconnect (NVLink within a host, the network
across hosts).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tinyraytracer_tpu.models.camera import Camera
from tinyraytracer_tpu.models.world import SceneArrays
from tinyraytracer_tpu.ops import trace as trace_ops

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    *,
    sample_parallel: int = 1,
) -> Mesh:
    """A (tile × sample) mesh over `devices` (default: all devices).

    `sample_parallel` devices cooperate on the same pixels (splitting spp);
    the rest of the devices split the pixel grid.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % sample_parallel != 0:
        raise ValueError(f"{n} devices not divisible by sample_parallel={sample_parallel}")
    arr = np.asarray(devices, dtype=object).reshape(n // sample_parallel, sample_parallel)
    return Mesh(arr, (TILE_AXIS, SAMPLE_AXIS))


def _padded_pixel_ids(npix: int, n_tiles: int) -> jnp.ndarray:
    """Flat pixel ids padded to a multiple of the tile-axis size.

    Padding duplicates the last pixel (in-bounds, so the padded rays trace
    real geometry and stay finite); the pad is sliced off after the gather.
    """
    total = ((npix + n_tiles - 1) // n_tiles) * n_tiles
    ids = jnp.minimum(jnp.arange(total, dtype=jnp.uint32), jnp.uint32(npix - 1))
    return ids


@partial(
    jax.jit,
    static_argnames=("spp", "max_bounces", "exact", "mesh"),
)
def _render_flat_sharded(
    scene: SceneArrays,
    camera: Camera,
    pixel_id,
    *,
    spp: int,
    max_bounces: int,
    background,
    seed,
    mesh: Mesh,
    exact: bool = False,
    bvh=None,
    spp_offset=0,
):
    """Sharded flat render: pixel_id split over "tile", spp over "sample".

    `bvh` (a BVHArrays or None) is replicated like the scene. `spp_offset`
    (traced u32) shifts every shard's sample ids — chunked progress rounds
    partition [0, spp) across calls exactly like the single-device path."""
    n_sample = mesh.shape[SAMPLE_AXIS]
    if spp % n_sample != 0:
        raise ValueError(f"spp={spp} not divisible by sample axis size {n_sample}")
    spp_local = spp // n_sample

    def body(scene, camera, background, seed, spp_offset, bvh, pids):
        s_idx = jax.lax.axis_index(SAMPLE_AXIS).astype(jnp.uint32)
        img = trace_ops.render_pixels(
            scene,
            camera,
            pids,
            spp=spp_local,
            max_bounces=max_bounces,
            background=background,
            seed=seed,
            exact=exact,
            spp_offset=spp_offset + s_idx * jnp.uint32(spp_local),
            bvh=bvh,
        )
        # Mean of per-shard means over equal shards == global mean
        # (the Imager's ·1/spp accumulation, renderer/imager.rs:46-51).
        # Skip the collective outright on a trivial sample axis so a
        # tile-only mesh compiles to ZERO cross-chip traffic
        # (tests/test_scaling_evidence.py pins this).
        if n_sample == 1:
            return img
        return jax.lax.pmean(img, SAMPLE_AXIS)

    # check_vma=False: the trace's scan carries start as unvarying constants
    # and become device-varying, which the VMA type system rejects; the body
    # is a genuinely per-shard program, so skip the replication typing.
    f = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(TILE_AXIS)),
        out_specs=P(TILE_AXIS, None),
        check_vma=False,
    )
    return f(scene, camera, background, seed, jnp.uint32(spp_offset), bvh,
             pixel_id)


def render_image_sharded(
    scene: SceneArrays,
    camera: Camera,
    *,
    spp: int,
    max_bounces: int,
    background,
    seed: int = 0,
    devices: Optional[Sequence[jax.Device]] = None,
    mesh: Optional[Mesh] = None,
    sample_parallel: int = 1,
    exact: bool = False,
    bvh=None,
    spp_offset: int = 0,
) -> jax.Array:
    """Full-image render sharded over a device mesh.

    Matches single-chip ops.trace.render_image bitwise for tile-only meshes
    and within f32 summation rounding when spp is split (counter RNG keys on
    global ids). Returns (H, W, 3) linear radiance.
    """
    if mesh is None:
        mesh = make_mesh(devices, sample_parallel=sample_parallel)
    w, h = camera.width, camera.height
    npix = w * h
    pixel_id = _padded_pixel_ids(npix, mesh.shape[TILE_AXIS])
    img = _render_flat_sharded(
        scene,
        camera,
        pixel_id,
        spp=spp,
        max_bounces=max_bounces,
        background=jnp.asarray(background, jnp.float32),
        seed=jnp.uint32(seed),
        mesh=mesh,
        exact=exact,
        bvh=bvh,
        spp_offset=spp_offset,
    )
    return img[:npix].reshape(h, w, 3)
