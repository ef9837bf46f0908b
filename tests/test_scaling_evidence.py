"""HLO-level evidence for the multi-chip scaling claim (BASELINE gate:
>=80% linear rays/s scaling).

Multi-device hardware isn't reachable from CI, so instead of a prose
cost model these tests pin the *compiled communication structure* of every
sharded program: the optimized HLO must contain exactly the intended
all-reduces and nothing else (no all-gathers / all-to-alls /
collective-permutes that would signal an accidental resharding), and the
payloads must be the small, ray-count-independent tensors the cost model
assumes. With communication fixed at KBs per image/step against seconds
of per-device compute, scaling is compute-bound by construction.

Reference analog: the worker fan-out over shared channels this replaces
(raytracer/src/renderer/renderer.rs:62-78) has no collective at all; this
design's only cross-device traffic is the sample-axis mean and the
parameter-gradient reduction (SURVEY.md §2 parallelism table).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinyraytracer_tpu.models import presets
from tinyraytracer_tpu.parallel.sharded import make_mesh, render_image_sharded

_OP_RE = re.compile(
    r'"stablehlo\.(all_reduce|all_gather|all_to_all|collective_permute|'
    r"reduce_scatter)\""
)
_SIG_RE = re.compile(r"\) : \(([^)]*)\)")
_TENSOR_RE = re.compile(r"tensor<([0-9x]*?)x?(f32|f64|i32|u32|i64|bf16)>")
_DTYPE_BYTES = {"f32": 4, "i32": 4, "u32": 4, "f64": 8, "i64": 8, "bf16": 2}


def collectives(stablehlo_text):
    """[(kind, payload_bytes)] for every collective in lowered StableHLO.

    Parsed from `jit(f).lower(...).as_text()` — the program's OWN
    collectives, before any backend-specific lowering (XLA:CPU rewrites
    small all-reduces into collective-permute rings, which would make a
    compiled-HLO count a backend artifact rather than program evidence).
    Under shard_map partitioning is manual, so this is the complete
    cross-device communication of the program."""
    lines = stablehlo_text.splitlines()
    out = []
    for i, line in enumerate(lines):
        m = _OP_RE.search(line)
        if not m:
            continue
        nbytes = 0
        for j in range(i, min(i + 60, len(lines))):
            sig = _SIG_RE.search(lines[j])
            if sig:
                for tm in _TENSOR_RE.finditer(sig.group(1)):
                    n = 1
                    for d in tm.group(1).split("x"):
                        if d:
                            n *= int(d)
                    nbytes += n * _DTYPE_BYTES[tm.group(2)]
                break
        out.append((m.group(1), nbytes))
    return out


def _cornell(wh=64):
    world, cam, kw = presets.PRESETS["cornell_box"](wh, wh)
    return world.build(), cam, kw


def test_forward_sample_split_is_one_allreduce():
    """Sample-parallel forward: exactly ONE all-reduce per image — the
    sample-axis pmean — with a payload of one local framebuffer shard."""
    scene, cam, kw = _cornell(64)
    mesh = make_mesh(jax.devices(), sample_parallel=2)

    def f(s, c):
        return render_image_sharded(
            s, c, spp=8, max_bounces=4, background=kw["background"],
            seed=0, mesh=mesh)

    txt = jax.jit(f).lower(scene, cam).as_text()
    cols = collectives(txt)
    assert [k for k, _ in cols] == ["all_reduce"], cols
    npix_local = 64 * 64 // mesh.shape["tile"]
    assert cols[0][1] == npix_local * 3 * 4


def test_forward_tile_only_has_no_collectives():
    """Pure pixel sharding needs zero communication: every chip owns its
    framebuffer shard outright."""
    scene, cam, kw = _cornell(64)
    mesh = make_mesh(jax.devices())        # 8 x 1

    def f(s, c):
        return render_image_sharded(
            s, c, spp=8, max_bounces=4, background=kw["background"],
            seed=0, mesh=mesh)

    txt = jax.jit(f).lower(scene, cam).as_text()
    assert collectives(txt) == []


def test_modular_train_step_collectives_bounded():
    """Modular sharded train step: all-reduce only (loss psum + image
    pmean + their adjoints + gradient psums) — bounded count, no
    resharding collectives."""
    from tinyraytracer_tpu.diff.inverse import make_train_step

    scene, cam, kw = _cornell(32)
    mesh = make_mesh(jax.devices(), sample_parallel=2)
    target = jnp.zeros((32, 32, 3), jnp.float32)
    step, (params, opt_state) = make_train_step(
        scene, cam, target, spp=4, max_bounces=3,
        background=kw["background"], seed=0, mesh=mesh)

    txt = jax.jit(step).lower(params, opt_state, 0).as_text()
    cols = collectives(txt)
    kinds = {k for k, _ in cols}
    assert kinds <= {"all_reduce"}, cols
    # one per gradient field + loss psum + image pmean & adjoints:
    # a fixed, scene-structure-sized set, independent of rays/spp
    assert 1 <= len(cols) <= 16, cols
    npix_local = 32 * 32 // mesh.shape["tile"]
    fb_shard = npix_local * 3 * 4
    assert all(b <= 2 * fb_shard for _, b in cols), cols
