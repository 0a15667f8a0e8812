"""The port's RecordIO, image codec, resize and iterators against the
JAX package (CPU).

* a .rec written by the JAX example's ``make_dataset`` (PIL's PNG) reads
  in the port's ``ImageDetIter``, and one written by the port's (its own
  PNG encoder) reads in the JAX one; with ``shuffle=False,
  rand_mirror=False`` and with both on (after ``mx.random.seed(0)`` in
  each package) the batches and labels are exactly equal, epoch after
  epoch;
* the PNG decoder gives PIL's pixels on PNGs that PIL wrote (every row
  filter PIL picks; gray, RGB, RGBA; gray from RGB by PIL's formula), and
  the encoder's PNGs decode in PIL to the same pixels; ``imencode`` to
  '.jpg' writes PIL's JPEG bytes and ``imdecode`` gives PIL's pixels
  (the JPEG codec itself: ``test_torch_imgcodec.py``);
* ``imresize`` against the JAX package's (``jax.image.resize``) within
  one uint8 level, the identity at the same size;
* records that embed the RecordIO magic word round-trip between the
  packages; ``NDArrayIter`` gives the JAX package's batches.
"""
import importlib.util
import io
import os
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, image, recordio
from mxnet_tpu_torch.example.ssd import train_ssd as port_ssd

REPO = Path(__file__).resolve().parent.parent


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_ssd", REPO / "example" / "ssd" / "train_ssd.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _iters(rec, shuffle, mirror):
    kw = dict(batch_size=4, data_shape=(3, 32, 32), path_imgrec=rec,
              shuffle=shuffle, mean=True, std=True, rand_mirror=mirror)
    jmx.random.seed(0)
    jit = jmx.image.ImageDetIter(**kw)
    mx.random.seed(0)
    with mx.cpu():
        tit = image.ImageDetIter(**kw)
    return jit, tit


def _assert_same_batches(jit, tit, epochs=2):
    assert tit.provide_label[0].shape == jit.provide_label[0].shape
    assert tit.provide_data[0].shape == jit.provide_data[0].shape
    n = 0
    for _ in range(epochs):
        jit.reset()
        tit.reset()
        for jb, tb in zip(jit, tit):
            np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                          jb.data[0].asnumpy())
            np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                          jb.label[0].asnumpy())
            assert tb.pad == jb.pad
            n += 1
    assert n == 2 * epochs


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("shuffle,mirror", [(False, False), (True, True)])
def test_detection_rec_reads_alike_in_both(tmp_path, writer, shuffle,
                                           mirror):
    maker = _jax_example().make_dataset if writer == "jax" \
        else port_ssd.make_dataset
    rec = maker(str(tmp_path / "shapes"), n=8, side=32)
    _assert_same_batches(*_iters(rec, shuffle, mirror))


def test_make_dataset_writes_the_same_records(tmp_path):
    jrec_path = _jax_example().make_dataset(str(tmp_path / "j"), n=6,
                                            side=32)
    trec_path = port_ssd.make_dataset(str(tmp_path / "t"), n=6, side=32)
    jr = jrec.MXIndexedRecordIO(jrec_path[:-4] + ".idx", jrec_path, "r")
    tr = recordio.MXIndexedRecordIO(trec_path[:-4] + ".idx", trec_path, "r")
    assert tr.keys == jr.keys
    for k in jr.keys:
        jh, jimg = jrec.unpack_img(jr.read_idx(k))
        th, timg = recordio.unpack_img(tr.read_idx(k))
        np.testing.assert_array_equal(th.label, jh.label)
        assert (th.id, th.id2) == (jh.id, jh.id2)
        np.testing.assert_array_equal(timg, jimg)
    jr.close()
    tr.close()


def _pil_png(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("shape", [(17, 23, 3), (9, 31, 4), (12, 5)])
def test_png_decoder_matches_pil(shape):
    rs = np.random.RandomState(sum(shape))
    # smooth ramps plus noise: PIL's adaptive filter picks every type
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 7
    arr = (ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
           + rs.randint(0, 40, shape)).astype(np.uint8)
    buf = _pil_png(arr)
    pil = Image.open(io.BytesIO(buf))
    for flag, mode in ((1, "RGB"), (0, "L")):
        want = np.asarray(pil.convert(mode))
        got = image.imdecode(buf, flag=flag, to_numpy=True)
        np.testing.assert_array_equal(got.reshape(want.shape), want)
    bgr = image.imdecode(buf, flag=1, to_rgb=0, to_numpy=True)
    np.testing.assert_array_equal(bgr, np.asarray(pil.convert("RGB"))[...,
                                                                      ::-1])
    nd = image.imdecode(buf)
    assert nd.context == mx.cpu() and nd.dtype == np.uint8


def test_png_encoder_decodes_in_pil_and_jpeg_raises():
    arr = np.random.RandomState(2).randint(0, 256, (13, 7, 3)).astype(
        np.uint8)
    for a in (arr, arr[..., :1], arr[..., 0]):
        buf = image.imencode(a, ".png")
        got = np.asarray(Image.open(io.BytesIO(buf)))
        np.testing.assert_array_equal(got, a.reshape(got.shape))
        np.testing.assert_array_equal(
            image.imdecode(buf, flag=0 if a.ndim == 2 or a.shape[2] == 1
                           else 1, to_numpy=True).reshape(got.shape), got)
    # JPEG: the port's encoder writes PIL's bytes, its decoder gives
    # PIL's pixels (tolerance 0); anything else raises
    pil = io.BytesIO()
    Image.fromarray(arr).save(pil, format="JPEG", quality=95)
    with mx.cpu():
        assert image.imencode(arr, ".jpg") == pil.getvalue()
        np.testing.assert_array_equal(
            image.imdecode(pil.getvalue(), to_numpy=True),
            np.asarray(Image.open(io.BytesIO(pil.getvalue()))))
    with pytest.raises(MXNetError, match="neither a JPEG nor a PNG"):
        image.imdecode(b"GIF89a" + bytes(20))


@pytest.mark.parametrize("size,interp", [((48, 40), 2), ((20, 12), 2),
                                         ((33, 17), 1), ((25, 25), 0),
                                         ((16, 40), 4)])
def test_imresize_matches_jax(size, interp):
    arr = np.random.RandomState(3).randint(0, 256, (32, 24, 3)).astype(
        np.uint8)
    want = jmx.image.imresize(jmx.nd.array(arr, dtype=np.uint8), *size,
                              interp=interp).asnumpy()
    got = image.imresize(arr, *size, interp=interp).asnumpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    same = image.imresize(arr, 24, 32, interp=2).asnumpy()
    np.testing.assert_array_equal(same, arr)


def test_records_with_the_magic_word_round_trip(tmp_path):
    magic = struct.pack("<I", 0xCED7230A)
    payloads = [b"plain", magic + b"head", b"mid" + magic + b"dle" + magic,
                b"", bytes(range(256)) * 3]
    path = str(tmp_path / "x.rec")
    w = recordio.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()
    jr = jrec.MXRecordIO(path, "r")
    assert [jr.read() for _ in payloads] == payloads
    jr.close()
    path2 = str(tmp_path / "y.rec")
    jw = jrec.MXRecordIO(path2, "w")
    for p in payloads:
        jw.write(p)
    jw.close()
    tr = recordio.MXRecordIO(path2, "r")
    assert [tr.read() for _ in payloads] + [tr.read()] == payloads + [None]
    tr.close()
    h = recordio.IRHeader(0, 2.5, 7, 0)
    assert recordio.unpack(recordio.pack(h, b"ab")) == jrec.unpack(
        jrec.pack(h, b"ab"))


def test_ndarray_iter_matches_jax():
    rs = np.random.RandomState(0)
    data, label = rs.rand(10, 3).astype(np.float32), np.arange(10.0)
    for last in ("pad", "discard"):
        jmx.random.seed(1)
        jit = jmx.io.NDArrayIter(data, label, batch_size=4, shuffle=True,
                                 last_batch_handle=last)
        mx.random.seed(1)
        with mx.cpu():
            tit = mx.io.NDArrayIter(data, label, batch_size=4, shuffle=True,
                                    last_batch_handle=last)
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in tit]
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in jit]
        assert len(got) == len(want) == (3 if last == "pad" else 2)
        for (d, lab, p), (jd, jl, jp) in zip(got, want):
            np.testing.assert_array_equal(d, jd)
            np.testing.assert_array_equal(lab, jl)
            assert p == jp
        assert tit.provide_data[0].shape == (4, 3)


def test_iterators_hand_out_batches_on_their_context(tmp_path):
    rec = port_ssd.make_dataset(str(tmp_path / "s"), n=4, side=16)
    with mx.cpu():
        it = image.ImageDetIter(batch_size=4, data_shape=(3, 16, 16),
                                path_imgrec=rec)
    batch = next(iter(it))  # outside the scope: still the host
    assert batch.data[0].context == mx.cpu()
    assert os.path.isfile(rec[:-4] + ".idx")
