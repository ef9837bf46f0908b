"""Application-layer smoke test (the reference binary's role, src/main.rs)."""

import os

from tinyraytracer_tpu.__main__ import main


def test_cli_renders_png(tmp_path):
    out = os.path.join(tmp_path, "mini.png")
    rc = main([
        "--preset", "sphere_ground",
        "--width", "16", "--height", "12",
        "--spp", "2", "--max-bounces", "3",
        "--out", out,
    ])
    assert rc == 0
    assert os.path.exists(out)
    from tinyraytracer_tpu.utils.image import read_png

    img = read_png(out)
    assert img.shape == (12, 16, 3)
    assert img.max() > 0


def test_cli_rejects_unknown_preset(tmp_path, capsys):
    import pytest

    with pytest.raises(SystemExit):
        main(["--preset", "nope"])
