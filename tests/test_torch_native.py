"""The port's native decoders (``raft_stereo_tpu_torch/native``) against
the JAX package's (``raft_stereo_tpu/native``) and the Python readers, bit
for bit, on the cases of ``tests/test_native.py``; where the port builds
its library; and a build that fails.

Every comparison is exact (``assert_array_equal``): the two libraries
compile one source, and the Python readers are the semantics' reference.
"""

import os

import numpy as np
import pytest
from PIL import Image

from raft_stereo_tpu import native as jnative
from raft_stereo_tpu.data import frame_utils as jfu
from raft_stereo_tpu_torch import native
from raft_stereo_tpu_torch.data import frame_utils as fu
from raft_stereo_tpu_torch.kernels import _build


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        pytest.fail(f"the port's native decoders did not build here: "
                    f"{native.unavailable_reason()}")
    if not jnative.available():
        pytest.fail("the JAX package's native decoders did not build")


def _write_pfm_nch(path, arr, scale_line):
    h, w = arr.shape[:2]
    c = 3 if arr.ndim == 3 else 1
    with open(path, "wb") as f:
        f.write((b"PF\n" if c == 3 else b"Pf\n") + f"{w} {h}\n".encode()
                + scale_line)
        dt = "<f4" if b"-" in scale_line else ">f4"
        f.write(np.flipud(arr).astype(dt).tobytes())


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("scale_line", [b"-1.0\n", b"1.0\n"])
def test_pfm_equals_jax_and_python(tmp_path, rng, channels, scale_line):
    shape = (13, 17) if channels == 1 else (13, 17, 3)
    arr = rng.standard_normal(shape).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    _write_pfm_nch(p, arr, scale_line)
    got = native.read_pfm(p)
    np.testing.assert_array_equal(got, jnative.read_pfm(p))
    np.testing.assert_array_equal(got, fu._read_pfm_py(p))
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(fu.read_pfm(p), jfu.read_pfm(p))


def test_pfm_crlf_header_decodes_as_jax(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "crlf.pfm")
    with open(p, "wb") as f:
        f.write(b"Pf\r\n4 3\r\n-1.0\r\n")
        f.write(np.flipud(arr).astype("<f4").tobytes())
    np.testing.assert_array_equal(native.read_pfm(p), arr)
    np.testing.assert_array_equal(native.read_pfm(p), jnative.read_pfm(p))


def _space_separated(p):
    arr = np.arange(4, dtype=np.float32).reshape(2, 2)
    with open(p, "wb") as f:
        f.write(b"Pf\n2 2\n-1.0 ")
        f.write(np.flipud(arr).astype("<f4").tobytes())


def _garbage(p):
    with open(p, "wb") as f:
        f.write(b"P6\n3 3\n255\n" + b"\x00" * 27)


def _truncated(p):
    arr = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    _write_pfm_nch(p, arr, b"-1.0\n")
    with open(p, "r+b") as f:
        f.truncate(40)


@pytest.mark.parametrize("make", [_space_separated, _garbage, _truncated],
                         ids=["space_separator", "garbage", "truncated"])
def test_bad_pfm_rejected_as_jax(tmp_path, make):
    """A header the native reader refuses raises ValueError in both
    packages (the readers then take the Python path)."""
    p = str(tmp_path / "bad.pfm")
    make(p)
    for mod in (native, jnative):
        with pytest.raises(ValueError):
            mod.read_pfm(p)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_png8_equals_jax_and_pil(tmp_path, rng, mode):
    channels = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    shape = (11, 9) if channels == 1 else (11, 9, channels)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "t.png")
    Image.fromarray(arr, mode=mode).save(p)
    got = native.read_png_rgb8(p)
    ref = np.asarray(Image.open(p))
    if ref.ndim == 2:
        ref = np.repeat(ref[..., None], 3, axis=-1)
    np.testing.assert_array_equal(got, ref[..., :3])
    np.testing.assert_array_equal(got, jnative.read_png_rgb8(p))
    np.testing.assert_array_equal(fu.read_image(p), jfu.read_image(p))


def test_png16_kitti_equals_jax(tmp_path, rng):
    disp = rng.uniform(0, 192, (7, 23)).astype(np.float32)
    disp[rng.uniform(size=disp.shape) < 0.3] = 0.0
    p = str(tmp_path / "d.png")
    fu.write_disp_kitti(p, disp)
    raw = native.read_png_gray16(p)
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(raw, jnative.read_png_gray16(p))
    np.testing.assert_array_equal(raw, np.asarray(Image.open(p)))
    got, valid = fu.read_disp_kitti(p)
    want, jvalid = jfu.read_disp_kitti(p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(got, np.floor(disp * 256) / 256)


def test_png16_rgb_refused_by_gray16_as_jax(tmp_path, rng):
    arr = rng.integers(0, 256, (5, 5, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    Image.fromarray(arr).save(p)
    for mod in (native, jnative):
        with pytest.raises(ValueError):
            mod.read_png_gray16(p)


def test_png16_rgb_image_keeps_the_high_byte(tmp_path, rng):
    """A 16-bit gray PNG as an image: the native decoder strips to the
    high byte, as the Python path does (and as the JAX package does)."""
    arr = rng.integers(0, 2 ** 16, (6, 7), dtype=np.uint16)
    p = str(tmp_path / "g16.png")
    Image.fromarray(arr).save(p)
    got = fu.read_image(p)
    np.testing.assert_array_equal(got, jfu.read_image(p))
    np.testing.assert_array_equal(
        got, np.repeat((arr >> 8).astype(np.uint8)[..., None], 3, axis=-1))


def test_the_library_builds_under_the_build_dir_with_a_hash():
    lib = native.library_path()
    assert lib.parent == _build.BUILD_DIR
    assert lib.exists() and lib.name.startswith("stereo_native-")
    digest = lib.stem.split("-", 1)[1]
    assert len(digest) == 16 and int(digest, 16) >= 0
    # not beside the source, where the JAX package builds its own
    assert not any(n.endswith(".so") for n in
                   os.listdir(os.path.dirname(native.SOURCE)))


def test_a_failed_build_is_stated_and_the_readers_stay_pil(
        tmp_path, rng, monkeypatch, caplog):
    """A compiler that does not exist: ``available()`` is False with the
    reason, the loader's line names the Python readers, and ``read_image``
    still equals PIL's decode."""
    monkeypatch.setattr(native, "CXX", "g++-that-does-not-exist")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    with caplog.at_level("WARNING"):
        assert not native.available()
    reason = native.unavailable_reason()
    assert "g++-that-does-not-exist" in reason
    assert any("native decoders unavailable" in r.getMessage()
               for r in caplog.records)
    assert not native.library_path().exists()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.read_pfm(str(tmp_path / "x.pfm"))

    from raft_stereo_tpu_torch.data import loader
    monkeypatch.setattr(loader, "_readers_logged", False)
    caplog.clear()
    with caplog.at_level("WARNING"):
        loader._log_readers()
    assert any("Python readers" in r.getMessage() and reason in r.getMessage()
               for r in caplog.records)

    arr = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    Image.fromarray(arr).save(p)
    np.testing.assert_array_equal(fu.read_image(p), np.asarray(Image.open(p)))
    pfm = str(tmp_path / "t.pfm")
    _write_pfm_nch(pfm, arr[..., 0].astype(np.float32), b"-1.0\n")
    np.testing.assert_array_equal(fu.read_pfm(pfm), fu._read_pfm_py(pfm))
