"""The port's CLI (diffusion_rs_tpu_torch/cli.py): tests/test_cli.py's two
cases with ``--device cpu`` on the same synthetic checkpoint, and
``--compile-cache`` reaching util/compile_cache.enable_compile_cache
before the load."""

import struct

import pytest

from diffusion_rs_tpu_torch.cli import main
from diffusion_rs_tpu_torch.util import compile_cache as cc

from synth import write_checkpoint


def _png_size(data: bytes):
    """(width, height) from a PNG's IHDR chunk."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    return struct.unpack(">II", data[16:24])


def test_cli_noninteractive(tmp_path, capsys):
    root = write_checkpoint(tmp_path / "ck", seed=0)
    out = tmp_path / "img.png"
    rc = main([
        "--model-id", str(root),
        "--num-steps", "2",
        "--scale", "0.0",
        "--height", "64", "--width", "48",
        "--seed", "1",
        "--silent",
        "--device", "cpu",
        "--prompt", "a photo of a cat",
        "-o", str(out),
    ])
    assert rc == 0
    assert _png_size(out.read_bytes()) == (48, 64)
    assert f"Saved to {out}" in capsys.readouterr().out


def test_cli_requires_source():
    with pytest.raises(SystemExit):
        main(["--num-steps", "2"])


def test_cli_compile_cache_reaches_enable(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(cc, "enable_compile_cache", lambda d=None: calls.append(d))
    empty = tmp_path / "empty-model-dir"
    empty.mkdir()  # no model_index.json: the load fails after the enable
    with pytest.raises(Exception):
        main(["--model-id", str(empty), "--device", "cpu", "--silent",
              "--compile-cache", str(tmp_path / "kernels"), "--prompt", "x"])
    assert calls == [str(tmp_path / "kernels")]
