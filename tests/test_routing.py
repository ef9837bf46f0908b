"""Route choice, the compile-cache helper, PNG I/O and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import struct
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest

from tinyraytracer_tpu import renderer as rmod
from tinyraytracer_tpu.models import presets
from tinyraytracer_tpu.utils import compile_cache
from tinyraytracer_tpu.utils.image import Image, encode_png, read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,n_prims,accelerator,interpret,route", [
    ("cpu", 23, "auto", False, "none"),
    ("cpu", rmod.BVH_AUTO_THRESHOLD + 1, "auto", False, "bvh"),
    ("cpu", 23, "auto", True, "none"),
    ("cpu", 23, "bvh", False, "bvh"),
    ("cpu", 23, "megakernel", True, "megakernel"),
    ("gpu", 23, "auto", False, "megakernel"),
    ("gpu", 8000, "auto", False, "megakernel"),
    ("gpu", rmod.MEGAKERNEL_MAX_PRIMS + 1, "auto", False, "bvh"),
    ("gpu", 23, "none", False, "none"),
    ("gpu", 23, "megakernel", False, "megakernel"),
])
def test_choose_route(platform, n_prims, accelerator, interpret, route):
    assert rmod.choose_route(platform, n_prims, accelerator,
                             interpret) == route


@pytest.mark.parametrize("platform,accelerator,interpret,match", [
    ("cpu", "megakernel", False, "compiles only for the GPU"),
    ("metal", "auto", False, "no render route for platform"),
    ("rocm", "none", False, "no render route for platform"),
    ("gpu", "megakernel", True, "CPU tests only"),
    ("cpu", "dense", False, "unknown accelerator"),
])
def test_choose_route_errors(platform, accelerator, interpret, match):
    with pytest.raises(ValueError, match=match):
        rmod.choose_route(platform, 23, accelerator, interpret)


def test_forced_megakernel_raises_on_cpu():
    """Forcing the kernel where it cannot compile is an error, never a
    silent interpret-mode fallback."""
    world, cam, kw = presets.sphere_ground(8, 6)
    r = rmod.Renderer(samples_per_pixel=1, max_bounces=2,
                      background_color=kw["background"],
                      accelerator="megakernel")
    with pytest.raises(ValueError, match="compiles only for the GPU"):
        r.render_array(cam, world.build())


def test_renderer_interpret_megakernel_matches_plain():
    """A test may ask for the interpreted kernel through the public API;
    it then renders what the plain path renders."""
    world, cam, kw = presets.three_spheres(16, 12)
    scene = world.build()
    common = dict(samples_per_pixel=2, max_bounces=3,
                  background_color=kw["background"], seed=4)
    mk_img = rmod.Renderer(accelerator="megakernel", interpret=True,
                           **common).render_array(cam, scene)
    plain = rmod.Renderer(accelerator="none", **common).render_array(
        cam, scene)
    np.testing.assert_allclose(np.asarray(mk_img), np.asarray(plain),
                               atol=1e-6)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_helper(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", None)
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself; nothing is set in code
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
            got = compile_cache.enable_compile_cache()
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_png_encoder_roundtrip(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    data = encode_png(rgb)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    p = tmp_path / "x.png"
    p.write_bytes(data)
    np.testing.assert_array_equal(read_png(str(p)), rgb)
    with pytest.raises(ValueError, match="expected"):
        encode_png(rgb[..., :2])


def _chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def test_png_reader_undoes_every_filter(tmp_path):
    """Rows filtered with each of the five PNG filter types (and RGBA) come
    back as the original pixels — the reader handles any encoder."""
    rng = np.random.default_rng(1)
    h, w, c = 5, 6, 4
    img = rng.integers(0, 256, (h, w, c), np.uint8)
    rows = img.reshape(h, w * c).astype(np.int64)
    raw = b""
    prev = np.zeros(w * c, np.int64)
    for y, ftype in enumerate([0, 1, 2, 3, 4]):
        cur = rows[y]
        out = np.zeros_like(cur)
        for i in range(w * c):
            a = cur[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (
                    b if pb <= pc else cc)
            out[i] = (cur[i] - pred) % 256
        raw += bytes([ftype]) + out.astype(np.uint8).tobytes()
        prev = cur
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    p = tmp_path / "filters.png"
    p.write_bytes(png)
    np.testing.assert_array_equal(read_png(str(p)), img)


def test_image_save_without_native_encoder(tmp_path, monkeypatch):
    """With no native library the stdlib encoder writes the PNG."""
    from tinyraytracer_tpu.native import runtime

    monkeypatch.setattr(runtime, "available", lambda: False)
    img = Image.from_linear(np.full((3, 4, 3), 0.25, np.float32))
    p = tmp_path / "fallback.png"
    img.save(str(p))
    np.testing.assert_array_equal(read_png(str(p)), img.to_u8())


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.gpu
def test_chip_smoke_parity_on_gpu(gpu_device):
    """The kernel-vs-XLA parity phase at real widths (needs the card)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.phase_parity()
