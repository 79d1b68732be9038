"""Machine-dependent choices (ovr_tpu.platform) and the scripts that run
only on the card: the slice-loop kernel per platform, the compile cache's
placement, and `chip_smoke.py` / `bench.py` refusing to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest

from ovr_tpu import platform as plat
from ovr_tpu.io import image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name, kernel", [("gpu", "triton"), ("cpu", "xla")])
def test_slice_kernel_choice(name, kernel):
    assert plat.slice_kernel(name) == kernel


def test_slice_kernel_unknown_platform_raises():
    """No default: an unknown platform is an error, never a silent
    fallback (and never the interpreter)."""
    with pytest.raises(ValueError, match="metal"):
        plat.slice_kernel("metal")
    assert plat.slice_kernel() == "xla"  # this test process runs on the CPU


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path,
                                             cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert plat.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = plat.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run(args, cwd, env_extra=None, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """On the CPU, and in a directory holding chip_smoke.py and nothing
    else of the repo, the script exits non-zero and prints no ok line."""
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    r = _run(["chip_smoke.py"], cwd, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_fails_without_gpu():
    r = _run(["bench.py"], ROOT, {"JAX_PLATFORMS": "", "BENCH_GRID": "16"})
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr


def test_bench_on_explicit_cpu_says_cpu():
    r = _run(["bench.py"], ROOT, {
        "JAX_PLATFORMS": "cpu", "BENCH_GRID": "16", "BENCH_WIDTH": "24",
        "BENCH_HEIGHT": "16", "BENCH_RATE": "16", "BENCH_FRAMES": "1",
        "BENCH_WARMUP": "1", "BENCH_SHADING": "none"})
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] >= 1 and out["value"] > 0


def test_png_writer_needs_no_pil(tmp_path, monkeypatch):
    """PNG output is zlib + struct only: decodes by hand to the input."""
    monkeypatch.setitem(sys.modules, "PIL", None)  # any PIL import fails
    img = np.random.default_rng(1).uniform(size=(5, 7, 4)).astype(np.float32)
    path = tmp_path / "x.png"
    image.save_image(str(path), img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                               "big")
    assert (w, h) == (7, 5)
    idat = data.index(b"IDAT")
    n = int.from_bytes(data[idat - 4:idat], "big")
    raw = zlib.decompress(data[idat + 4:idat + 4 + n])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * 4)
    assert (rows[:, 0] == 0).all()  # filter byte
    got = rows[:, 1:].reshape(h, w, 4)[::-1]  # files are y-down
    np.testing.assert_array_equal(got, image.to_uint8(img))
