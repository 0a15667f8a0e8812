"""The port's image codec (``mxnet_tpu_torch/_imgcodec.py``) against PIL
and the JAX package (CPU). Every comparison is exact (tolerance 0):

* the plain JPEG decoder gives PIL's pixels on seeded images at 1x1,
  7x9, 16x16, 17x33, 40x56 and 64x48: gray, RGB at 4:4:4, 4:2:2 and
  4:2:0, qualities 50, 75, 92 and 95, restart markers and optimized
  Huffman tables; 4:4:0 (which PIL does not write) through the port's
  encoder; progressive and CMYK streams raise and name the mode;
* the plain encoder writes PIL's bytes for the same array, quality and
  sampling (so PIL decodes them to the pixels of its own encoding), and
  the JAX package's ``imdecode``/``imencode`` interoperate with the
  port's;
* the resample is Pillow's ``Image.resize(..., BILINEAR)`` for
  downscales and upscales, gray and RGB;
* where a host C++ compiler is present, the host library
  (``ops/csrc/imgcodec.cc``) is built and equals the plain version:
  decode and resample pixel for pixel, encode byte for byte.
"""
import io
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, _imgcodec, image

REPO = Path(__file__).resolve().parent.parent
SIZES = [(1, 1), (7, 9), (16, 16), (17, 33), (40, 56), (64, 48)]
QUALITIES = (50, 75, 92, 95)
PIL_SUB = {"444": 0, "422": 1, "420": 2}


def _smooth(rs, h, w, c):
    """Seeded smooth patterns plus noise: JPEG-like content."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = []
    for _ in range(c):
        f1, f2, ph = rs.uniform(0.05, 0.4, 3)
        chans.append(127 + 90 * np.sin(f1 * xx + 7 * ph) * np.cos(f2 * yy)
                     + rs.normal(0, 25, (h, w)))
    return np.clip(np.stack(chans, 2), 0, 255).astype(np.uint8)


def _pil_jpeg(arr, **kw):
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format="JPEG", **kw)
    return bio.getvalue()


def _corpus(h, w, seed):
    """(name, JPEG bytes) PIL wrote for one size: every mode and quality."""
    rs = np.random.RandomState(seed)
    out = []
    for q in QUALITIES:
        out.append(("gray q%d" % q, _pil_jpeg(_smooth(rs, h, w, 1)[..., 0],
                                               quality=q)))
        for sub, code in PIL_SUB.items():
            out.append(("%s q%d" % (sub, q),
                        _pil_jpeg(_smooth(rs, h, w, 3), quality=q,
                                  subsampling=code)))
    out.append(("restart", _pil_jpeg(_smooth(rs, h, w, 3), quality=90,
                                     restart_marker_blocks=1)))
    out.append(("optimize", _pil_jpeg(_smooth(rs, h, w, 3), quality=85,
                                      optimize=True)))
    return out


def _pil_pixels(buf):
    img = np.asarray(Image.open(io.BytesIO(buf)))
    return img[..., None] if img.ndim == 2 else img


@pytest.mark.parametrize("size", SIZES)
def test_plain_decoder_equals_pil(size):
    for name, buf in _corpus(*size, seed=size[0] * 100 + size[1]):
        got = _imgcodec.decode_plain(buf)
        want = _pil_pixels(buf)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("size", SIZES)
def test_plain_encoder_writes_pils_bytes(size):
    rs = np.random.RandomState(size[0] * 7 + size[1])
    for q in QUALITIES:
        gray = _smooth(rs, *size, 1)[..., 0]
        mine = _imgcodec.encode_plain(gray, q)
        theirs = _pil_jpeg(gray, quality=q)
        assert mine == theirs
        np.testing.assert_array_equal(_pil_pixels(mine), _pil_pixels(theirs))
        for sub, code in PIL_SUB.items():
            rgb = _smooth(rs, *size, 3)
            mine = _imgcodec.encode_plain(rgb, q, sampling=sub)
            theirs = _pil_jpeg(rgb, quality=q, subsampling=code)
            assert mine == theirs, (sub, q)
            np.testing.assert_array_equal(_pil_pixels(mine),
                                          _pil_pixels(theirs))
    rgb = _smooth(rs, *size, 3)
    assert _imgcodec.encode_plain(rgb, 90, restart=1) == \
        _pil_jpeg(rgb, quality=90, restart_marker_blocks=1)


def test_440_sampling_decodes_as_pil():
    rs = np.random.RandomState(5)
    for h, w in SIZES:
        buf = _imgcodec.encode_plain(_smooth(rs, h, w, 3), 92,
                                     sampling="440")
        np.testing.assert_array_equal(_imgcodec.decode_plain(buf),
                                      _pil_pixels(buf))


def test_unsupported_modes_raise_and_name_the_mode():
    rs = np.random.RandomState(6)
    rgb = _smooth(rs, 16, 16, 3)
    prog = _pil_jpeg(rgb, progressive=True)
    with pytest.raises(MXNetError, match="progressive"):
        _imgcodec.decode_plain(prog)
    cmyk = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(cmyk, format="JPEG")
    with pytest.raises(MXNetError, match="CMYK"):
        _imgcodec.decode_plain(cmyk.getvalue())
    with pytest.raises(MXNetError, match="SOI"):
        _imgcodec.decode_plain(b"\x89PNG" + bytes(20))
    with pytest.raises(MXNetError, match="truncated"):
        buf = _pil_jpeg(rgb)
        _imgcodec.decode_plain(buf[:-30])
    with mx.cpu(), pytest.raises(MXNetError, match="progressive"):
        image.imdecode(prog)


def test_image_entry_points_interoperate_with_the_jax_package():
    rs = np.random.RandomState(8)
    rgb = _smooth(rs, 21, 30, 3)
    with mx.cpu():
        buf = image.imencode(rgb, ".jpg", quality=90)
        assert buf == _pil_jpeg(rgb, quality=90)
        want = jmx.image.imdecode(buf, to_numpy=True)
        np.testing.assert_array_equal(image.imdecode(buf, to_numpy=True),
                                      want)
        jbuf = jmx.image.imencode(rgb, ".jpg", quality=75)
        for flag in (0, 1):
            np.testing.assert_array_equal(
                image.imdecode(jbuf, flag=flag, to_numpy=True),
                jmx.image.imdecode(jbuf, flag=flag, to_numpy=True))
        np.testing.assert_array_equal(
            image.imdecode(jbuf, to_rgb=0).asnumpy(),
            jmx.image.imdecode(jbuf, to_rgb=0).asnumpy())
        gray = image.imencode(rgb[..., :1], ".jpg")
        assert gray == jmx.image.imencode(rgb[..., :1], ".jpg")


@pytest.mark.parametrize("c", [1, 3])
def test_resample_equals_pillow_bilinear(c):
    rs = np.random.RandomState(9 + c)
    for h, w in SIZES + [(375, 500)]:
        img = _smooth(rs, h, w, c)
        pil = Image.fromarray(img[..., 0] if c == 1 else img)
        for ow, oh in [(1, 1), (3, 5), (2 * w + 1, 3 * h), (224, 224),
                       (max(1, w // 2), max(1, h // 3)), (w, h + 1),
                       (w + 7, h)]:
            want = np.asarray(pil.resize((ow, oh), Image.BILINEAR))
            got = _imgcodec.resize_plain(img, ow, oh)
            np.testing.assert_array_equal(got, want.reshape(oh, ow, c),
                                          err_msg=str((h, w, ow, oh)))


@pytest.fixture(scope="module")
def host_library():
    """The built host library, or a skip where no C++ compiler is."""
    if not (shutil.which("c++") or shutil.which("g++")):
        pytest.skip("no host C++ compiler to build ops/csrc/imgcodec.cc")
    return _imgcodec.library()


@pytest.mark.parametrize("size", SIZES + [(375, 500)])
def test_host_library_equals_plain(host_library, size):
    rs = np.random.RandomState(size[0] + 3 * size[1])
    big = size[0] * size[1] > 64 * 64  # the plain coder's seconds
    streams = [] if big else [b for _, b in _corpus(*size,
                                                    seed=size[0] + size[1])]
    for q in (95,) if big else (50, 75, 95):
        for sub in (None, "420") if big else (None, "444", "422", "420",
                                              "440"):
            img = _smooth(rs, *size, 1 if sub is None else 3)
            for restart in (0,) if big else (0, 2):
                plain = _imgcodec.encode_plain(img, q, sub, restart)
                assert _imgcodec.encode(img, q, sampling=sub,
                                        restart=restart, lib=True) == plain
                streams.append(plain)
    for buf in streams:
        np.testing.assert_array_equal(_imgcodec.decode(buf, lib=True),
                                      _imgcodec.decode_plain(buf))
    img = _smooth(rs, *size, 3)
    for ow, oh in [(1, 1), (2 * size[1] + 1, 3 * size[0]), (224, 224),
                   (max(1, size[1] // 2), max(1, size[0] // 3))]:
        np.testing.assert_array_equal(
            _imgcodec.resize_bilinear(img, ow, oh, lib=True),
            _imgcodec.resize_plain(img, ow, oh))


def test_host_library_raises_where_the_plain_version_does(host_library):
    rs = np.random.RandomState(12)
    rgb = _smooth(rs, 16, 16, 3)
    for bad, what in ((_pil_jpeg(rgb, progressive=True), "progressive"),
                      (_pil_jpeg(rgb)[:-30], "truncated"),
                      (b"\x00\x01" + bytes(10), "SOI")):
        with pytest.raises(MXNetError, match=what):
            _imgcodec.decode(bad, lib=True)
    with pytest.raises(MXNetError, match="JPEG takes"):
        _imgcodec.encode(np.zeros((4, 4, 2), np.uint8), lib=True)
    calls = dict(_imgcodec.LIB_CALLS)
    _imgcodec.decode(_pil_jpeg(rgb), lib=True)
    assert _imgcodec.LIB_CALLS["decode"] == calls["decode"] + 1


def test_codec_follows_the_context(monkeypatch):
    used = []
    monkeypatch.setattr(_imgcodec, "_lib_decode",
                        lambda buf: used.append("lib") or np.zeros((1, 1, 3)))
    buf = _pil_jpeg(np.zeros((8, 8, 3), np.uint8))
    with mx.cpu():
        image.imdecode(buf)
    assert used == []
    assert _imgcodec.use_library(mx.cpu()) is False
    _imgcodec.decode(buf, lib=True)
    assert used == ["lib"]


def test_host_library_first_call_a_decode(host_library, tmp_path):
    """In a fresh process whose first library call is a decode (as in a
    pipeline worker), the library gives the plain decoder's pixels."""
    import subprocess
    import sys

    from conftest import subprocess_env

    rs = np.random.RandomState(13)
    buf = _pil_jpeg(_smooth(rs, 40, 56, 3), quality=95)
    (tmp_path / "a.jpg").write_bytes(buf)
    code = ("import sys, numpy as np\n"
            "from mxnet_tpu_torch import _imgcodec as C\n"
            "buf = open(sys.argv[1], 'rb').read()\n"
            "got = C.decode(buf, lib=True)\n"
            "assert np.array_equal(got, C.decode_plain(buf))\n"
            "assert np.array_equal(C.decode(buf, lib=True), got)\n"
            "print('same')\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "a.jpg")],
                          cwd=str(REPO), env=subprocess_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "same" in proc.stdout
