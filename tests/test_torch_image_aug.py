"""The port's augmenters (``mxnet_tpu_torch/image.py``) against the JAX
package's under one seed (CPU): ``random_crop``, ``random_size_crop``,
``SequentialAug``, ``RandomOrderAug``, ``RandomCropAug``,
``RandomSizedCropAug``, the four jitters, ``ColorJitterAug``,
``LightingAug``, ``RandomGrayAug``, ``DetRandomCropAug``,
``DetRandomPadAug``, ``scale_down``, every branch of ``CreateAugmenter``
and ``CreateDetAugmenter``, and ``ImageIter``/``ImageDetIter`` with the
random branches on.

Both packages draw from ``mx.random.np_rng()`` in the same order, so one
seed gives the same crops, flips and jitters. Tolerances: equal where the
JAX augmenter is numpy (crops, flips, pads, boxes, draws); within 1e-5 of
the largest magnitude where it runs a JAX op (jitters, sums, dots, float
resizes); where a uint8 image is resized (``imresize`` rounds, the JAX
package's ``jax.image.resize`` and the port's numpy differ by at most one
level, as ``test_torch_image_io.py::test_imresize_matches_jax`` holds)
within one level times the gain of what follows.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image, recordio

REL = 1e-5
EIGVAL = [55.46, 4.794, 1.148]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


def _both(fn_j, fn_t, seed=11):
    """Run each package's call after seeding it alike."""
    jmx.random.seed(seed)
    want = fn_j()
    mx.random.seed(seed)
    with mx.cpu():
        got = fn_t()
    return got, want


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _img(h=30, w=40, dtype=np.float32, seed=0):
    a = np.random.RandomState(seed).rand(h, w, 3) * 255
    return a.astype(dtype)


@pytest.mark.parametrize("size", [(16, 12), (40, 30), (50, 50)])
def test_random_crop(size):
    a = _img()
    got, want = _both(lambda: jmx.image.random_crop(jmx.nd.array(a), size),
                      lambda: image.random_crop(image._to_nd(a), size))
    assert got[1] == want[1]
    _close(_np(got[0]), _np(want[0]))


@pytest.mark.parametrize("area", [0.3, (0.08, 1.0), (2.0, 3.0)])
def test_random_size_crop(area):
    a = _img()
    size, ratio = (20, 16), (3.0 / 4.0, 4.0 / 3.0)
    for seed in range(4):
        got, want = _both(
            lambda: jmx.image.random_size_crop(jmx.nd.array(a), size, area,
                                               ratio),
            lambda: image.random_size_crop(image._to_nd(a), size, area,
                                           ratio), seed=seed)
        assert got[1] == want[1]
        _close(_np(got[0]), _np(want[0]))


def _pair(name, *args):
    return getattr(jmx.image, name)(*args), getattr(image, name)(*args)


SINGLE = [("BrightnessJitterAug", (0.4,)), ("ContrastJitterAug", (0.4,)),
          ("SaturationJitterAug", (0.4,)), ("HueJitterAug", (0.3,)),
          ("LightingAug", (0.1, EIGVAL, EIGVEC)), ("RandomGrayAug", (0.5,)),
          ("RandomCropAug", ((24, 20),)),
          ("RandomSizedCropAug", ((24, 20), (0.08, 1.0), (0.75, 1.333))),
          ("ColorJitterAug", (0.4, 0.4, 0.4)),
          ("ColorJitterAug", (0.0, 0.3, 0.0))]


@pytest.mark.parametrize("name,args", SINGLE,
                         ids=[n + str(i) for i, (n, _) in enumerate(SINGLE)])
def test_augmenter_matches_jax(name, args):
    a = _img()
    jaug, taug = _pair(name, *args)
    for seed in range(3):
        got, want = _both(lambda: jaug(jmx.nd.array(a)),
                          lambda: taug(image._to_nd(a)), seed=seed)
        _close(_np(got), _np(want))


def test_sequential_and_random_order_aug():
    a = _img()
    specs = [("BrightnessJitterAug", (0.4,)), ("HueJitterAug", (0.2,)),
             ("RandomGrayAug", (0.5,))]
    js = [getattr(jmx.image, n)(*x) for n, x in specs]
    ts = [getattr(image, n)(*x) for n, x in specs]
    for cls in ("SequentialAug", "RandomOrderAug"):
        jaug = getattr(jmx.image, cls)(js)
        taug = getattr(image, cls)(ts)
        for seed in range(4):
            got, want = _both(lambda: jaug(jmx.nd.array(a)),
                              lambda: taug(image._to_nd(a)), seed=seed)
            _close(_np(got), _np(want))


def test_scale_down():
    for src, size in [((640, 480), (224, 224)), ((100, 50), (224, 224)),
                      ((50, 100), (80, 160)), ((30, 30), (10, 20))]:
        assert image.scale_down(src, size) == jmx.image.scale_down(src, size)


CREATE = [dict(), dict(resize=36), dict(rand_crop=True),
          dict(rand_crop=True, rand_resize=True), dict(rand_mirror=True),
          dict(mean=True, std=True), dict(mean=np.array([1.0, 2.0, 3.0])),
          dict(brightness=0.3, contrast=0.3, saturation=0.3),
          dict(hue=0.2), dict(pca_noise=0.1), dict(rand_gray=0.5),
          dict(rand_crop=True, rand_mirror=True, brightness=0.2, hue=0.1,
               pca_noise=0.05, rand_gray=0.3, mean=True, std=True)]


@pytest.mark.parametrize("kw", CREATE, ids=[",".join(sorted(k)) or "plain"
                                            for k in CREATE])
def test_create_augmenter_branches(kw):
    a = _img(40, 48)
    jl = jmx.image.CreateAugmenter((3, 24, 20), **kw)
    tl = image.CreateAugmenter((3, 24, 20), **kw)
    assert [type(x).__name__ for x in tl] == [type(x).__name__ for x in jl]

    def run(augs, src):
        for aug in augs:
            src = aug(src)
        return src

    for seed in range(3):
        got, want = _both(lambda: run(jl, jmx.nd.array(a)),
                          lambda: run(tl, image._to_nd(a)), seed=seed)
        _close(_np(got), _np(want))


def _label():
    return np.array([[0, 0.1, 0.2, 0.5, 0.6], [1, 0.4, 0.3, 0.9, 0.95],
                     [2, 0.0, 0.0, 0.2, 0.1]], np.float32)


@pytest.mark.parametrize("name,kw", [
    ("DetRandomCropAug", dict(min_object_covered=0.5, min_crop_size=0.4)),
    ("DetRandomCropAug", dict(min_object_covered=0.95, max_attempts=3)),
    ("DetRandomPadAug", dict(max_pad_scale=2.5)),
    ("DetRandomPadAug", dict(max_pad_scale=1.05, pad_val=0))])
def test_det_augmenters_match_jax(name, kw):
    a = _img(30, 40, np.uint8)
    jaug = getattr(jmx.image, name)(**kw)
    taug = getattr(image, name)(**kw)
    for seed in range(5):
        got, want = _both(lambda: jaug(jmx.nd.array(a, dtype=np.uint8),
                                       _label()),
                          lambda: taug(image._to_nd(a), _label()), seed=seed)
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
        np.testing.assert_array_equal(got[1], want[1])


DET_CREATE = [dict(), dict(rand_crop=1), dict(rand_pad=1),
              dict(rand_mirror=True), dict(resize=40),
              dict(brightness=0.3, contrast=0.2, saturation=0.1),
              dict(mean=True), dict(std=True),
              dict(rand_crop=1, rand_pad=1, rand_mirror=True,
                   brightness=0.2, mean=True, std=True)]


@pytest.mark.parametrize("kw", DET_CREATE,
                         ids=[",".join(sorted(k)) or "plain"
                              for k in DET_CREATE])
def test_create_det_augmenter_branches(kw):
    a = _img(30, 40, np.float32)
    jl = jmx.image.CreateDetAugmenter((3, 24, 20), **kw)
    tl = image.CreateDetAugmenter((3, 24, 20), **kw)
    names = lambda augs: [type(getattr(x, "augmenter", x)).__name__  # noqa
                          for x in augs]
    assert names(tl) == names(jl)

    def run(augs, src):
        label = _label()
        for aug in augs:
            src, label = aug(src, label)
        return src, label

    for seed in range(3):
        got, want = _both(lambda: run(jl, jmx.nd.array(a)),
                          lambda: run(tl, image._to_nd(a)), seed=seed)
        _close(_np(got[0]), _np(want[0]))
        np.testing.assert_array_equal(got[1], want[1])


def _det_header(objs):
    flat = [2.0, 5.0]
    for o in objs:
        flat += list(o)
    return np.asarray(flat, np.float32)


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    """A classification and a detection .rec of JPEGs (the port's
    encoder, PIL's bytes)."""
    d = tmp_path_factory.mktemp("aug_recs")
    rs = np.random.RandomState(3)
    paths = {}
    for kind in ("cls", "det"):
        rec, idx = str(d / (kind + ".rec")), str(d / (kind + ".idx"))
        w = recordio.MXIndexedRecordIO(idx, rec, "w")
        for i in range(10):
            img = (rs.rand(36, 44, 3) * 255).astype(np.uint8)
            label = float(i % 4) if kind == "cls" else _det_header(
                [[i % 3, 0.1, 0.2, 0.6, 0.7]] + ([[1, 0.3, 0.3, 0.9, 0.9]]
                                                  if i % 2 else []))
            with mx.cpu():
                w.write_idx(i, recordio.pack_img(
                    recordio.IRHeader(0, label, i, 0), img, quality=90))
        w.close()
        paths[kind] = rec
    return paths


def _iter_batches(it, n=3):
    out = []
    for _ in range(n):
        b = it.next()
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def test_image_iter_random_branches(recs):
    kw = dict(batch_size=4, data_shape=(3, 24, 28), path_imgrec=recs["cls"],
              shuffle=True, rand_crop=True, rand_mirror=True, brightness=0.3,
              contrast=0.3, saturation=0.3, hue=0.1, pca_noise=0.1,
              rand_gray=0.3, mean=True, std=True)
    got, want = _both(lambda: _iter_batches(jmx.image.ImageIter(**kw)),
                      lambda: _iter_batches(image.ImageIter(**kw)), seed=5)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        _close(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


def test_image_iter_random_sized_crop(recs):
    """RandomSizedCropAug resizes the uint8 crop: one level of the
    resize, divided by the std, is the tolerance."""
    kw = dict(batch_size=4, data_shape=(3, 20, 20), path_imgrec=recs["cls"],
              shuffle=True, rand_crop=True, rand_resize=True,
              rand_mirror=True, mean=True, std=True)
    got, want = _both(lambda: _iter_batches(jmx.image.ImageIter(**kw)),
                      lambda: _iter_batches(image.ImageIter(**kw)), seed=6)
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        assert np.abs(gd - wd).max() <= 1.0 / 57.12 + 1e-5
        np.testing.assert_array_equal(gl, wl)


def test_image_det_iter_random_branches(recs):
    """DetForceResizeAug resizes the uint8 crop (one level), then the
    jitter scales by at most 1.2 and the std divides by 57.12."""
    kw = dict(batch_size=3, data_shape=(3, 24, 20), path_imgrec=recs["det"],
              shuffle=True, rand_crop=1, rand_pad=1, rand_mirror=True,
              brightness=0.2, mean=True, std=True)
    got, want = _both(lambda: _iter_batches(jmx.image.ImageDetIter(**kw)),
                      lambda: _iter_batches(image.ImageDetIter(**kw)),
                      seed=7)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert np.abs(gd - wd).max() <= 1.2 / 57.12 + 1e-5
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp
