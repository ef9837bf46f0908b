"""Mesh-sharded rendering: placement invariance + the driver's dry run.

conftest.py provides 8 virtual CPU devices (the multi-chip test strategy of
SURVEY.md §4: `--xla_force_host_platform_device_count`-style simulation).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinyraytracer_tpu.models import presets
from tinyraytracer_tpu.ops import trace as trace_ops
from tinyraytracer_tpu.parallel.sharded import make_mesh, render_image_sharded


@pytest.fixture(scope="module")
def cornell_small():
    world, camera, kw = presets.cornell_box(width=24, height=20)
    scene = world.build()
    ref = trace_ops.render_image(
        scene,
        camera,
        spp=4,
        max_bounces=4,
        background=jnp.asarray(kw["background"], jnp.float32),
        seed=0,
    )
    return scene, camera, kw, np.asarray(ref)


def test_tile_sharding_bitwise_equal(cornell_small):
    scene, camera, kw, ref = cornell_small
    mesh = make_mesh(sample_parallel=1)  # 8-way tile sharding
    img = render_image_sharded(
        scene, camera, spp=4, max_bounces=4,
        background=kw["background"], seed=0, mesh=mesh,
    )
    np.testing.assert_array_equal(np.asarray(img), ref)


@pytest.mark.parametrize("sample_parallel", [2, 4])
def test_sample_sharding_within_rounding(cornell_small, sample_parallel):
    """Splitting spp across devices changes only the f32 summation order of
    the sample mean; every per-sample radiance is placement-invariant."""
    scene, camera, kw, ref = cornell_small
    mesh = make_mesh(sample_parallel=sample_parallel)
    img = render_image_sharded(
        scene, camera, spp=4, max_bounces=4,
        background=kw["background"], seed=0, mesh=mesh,
    )
    np.testing.assert_allclose(np.asarray(img), ref, rtol=0, atol=1e-6)


def test_uneven_pixel_count_pads_correctly():
    world, camera, kw = presets.cornell_box(width=23, height=17)  # 391 = 8*48+7
    scene = world.build()
    ref = trace_ops.render_image(
        scene, camera, spp=2, max_bounces=3,
        background=jnp.asarray(kw["background"], jnp.float32), seed=5,
    )
    img = render_image_sharded(
        scene, camera, spp=2, max_bounces=3,
        background=kw["background"], seed=5, mesh=make_mesh(sample_parallel=1),
    )
    np.testing.assert_array_equal(np.asarray(img), np.asarray(ref))


def test_renderer_sample_parallel_wiring(cornell_small):
    """Renderer(sample_parallel=N) reaches the sharded path: a (4 tile x 2
    sample) mesh render through the public API matches the single-device
    reference within summation-order rounding, in both the batch and the
    progress-bar paths."""
    from tinyraytracer_tpu.renderer import Renderer

    scene, camera, kw, ref = cornell_small
    for progressbar in (False, True):
        r = Renderer(
            samples_per_pixel=4, max_bounces=4,
            background_color=kw["background"], seed=0,
            devices=jax.devices(), sample_parallel=2,
            progressbar=progressbar, spp_per_round=2,
        )
        if progressbar:
            img = r._render_with_progress(camera, scene)
        else:
            img = r.render_array(camera, scene)
        np.testing.assert_allclose(np.asarray(img), ref, rtol=0, atol=1e-6)


@pytest.mark.heavy
def test_driver_dryrun_multichip():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_driver_entry_compiles():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    out.block_until_ready()
    assert out.shape == (128, 128, 3)
    assert bool(jnp.isfinite(out).all())


@pytest.mark.heavy
def test_multiprocess_distributed_executes():
    """The REAL multi-process path. Spawns 2 processes x
    4 CPU devices under jax.distributed.initialize (coordinator +
    cross-process collectives), renders the sharded Cornell forward on
    the global 8-device mesh, and gates (inside the workers): tile mesh
    bitwise-equal to the single-device oracle, cross-process spp split
    within 1 ulp, and both processes holding identical image bytes."""
    import json
    import subprocess
    import sys

    script = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts", "multiprocess_check.py")
    out = subprocess.run(
        [sys.executable, script], capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok"]
    assert summary["results"]["tile8"]["ok"]
    assert summary["results"]["tile8"]["max_abs_diff"] == 0.0
    assert summary["results"]["tile4_sample2"]["ok"]
    assert summary["results"]["cross_process_identical"]
    assert summary["results"]["train_step"]["ok"]
    assert summary["results"]["train_step"][
        "params_cross_process_identical"]
