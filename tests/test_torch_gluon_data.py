"""The port's ``gluon.data`` against the JAX package (CPU).

* The vision datasets under ``MXNET_TPU_FAKE_DATA=1`` (the same
  synthetic images and labels), and on files the test writes: MNIST idx
  files (plain and ``.gz``), CIFAR10/100 pickled batches, a RecordIO file
  of PNGs (``ImageRecordDataset``) and class folders of PNG, JPEG and
  ``.npy`` images (``ImageFolderDataset``); a missing file raises in both, and
  ``HOME`` points at the test's directory, so nothing is written outside
  it. Images are kept on the host (uint8, HWC).
* The samplers and ``DataLoader``'s index order under one seed
  (``RandomSampler``'s shuffle, ``BatchSampler``'s keep, discard and
  rollover), and ``DataLoader`` with 0 and 2 worker threads giving equal
  batches in order, ``batch_sampler``, ``transform_first``, tuple
  samples, and the prefetch counter.
* All 15 transforms on the same image, the random ones under one seed:
  equal within 2e-5 (fp32; the resizes are ``jax.image.resize``'s
  weights in numpy).
"""
import gzip
import io
import os
import pickle
import struct

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, image, recordio
from mxnet_tpu_torch.gluon import data as gdata
from mxnet_tpu_torch.gluon.data.dataloader import _T_PREFETCH
from mxnet_tpu_torch.gluon.data.vision import transforms as T

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("MXNET_TPU_FAKE_DATA", raising=False)


def _samples(ds, idx=(0, 1, 7)):
    out = []
    for i in idx:
        img, label = ds[i]
        out.append((np.asarray(img.asnumpy()), int(label)))
    return out


def _same_samples(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        assert gl == wl


@pytest.mark.parametrize("name,kw", [("MNIST", {}), ("FashionMNIST", {}),
                                     ("CIFAR10", {}), ("CIFAR100", {}),
                                     ("CIFAR100", {"fine_label": True}),
                                     ("MNIST", {"train": False})])
def test_fake_datasets_equal_the_jax_package(monkeypatch, name, kw):
    monkeypatch.setenv("MXNET_TPU_FAKE_DATA", "1")
    got = getattr(gdata.vision, name)(**kw)
    want = getattr(jmx.gluon.data.vision, name)(**kw)
    assert len(got) == len(want) == 1024
    _same_samples(_samples(got), _samples(want))
    assert got._data.context == mx.cpu()  # kept on the host
    assert os.path.isdir(got._root)


@pytest.mark.parametrize("name", ["MNIST", "CIFAR10", "CIFAR100"])
def test_missing_files_raise_in_both(name):
    for pkg in (jmx, mx):
        with pytest.raises(Exception, match="not found"):
            getattr(pkg.gluon.data.vision, name)()


def _write_idx(d, prefix, imgs, labels, gz):
    opener = gzip.open if gz else open
    ext = ".gz" if gz else ""
    with opener(os.path.join(d, prefix + "-images-idx3-ubyte" + ext),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, len(imgs), 28, 28))
        f.write(imgs.tobytes())
    with opener(os.path.join(d, prefix + "-labels-idx1-ubyte" + ext),
                "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.tobytes())


@pytest.mark.parametrize("gz", [True, False])
def test_mnist_reads_idx_files(tmp_path, gz):
    rng = np.random.RandomState(1)
    for prefix, n in (("train", 12), ("t10k", 5)):
        _write_idx(str(tmp_path), prefix, rng.randint(
            0, 256, (n, 28, 28)).astype(np.uint8),
            rng.randint(0, 10, n).astype(np.uint8), gz)
    for train, n in ((True, 12), (False, 5)):
        got = gdata.vision.MNIST(root=str(tmp_path), train=train)
        want = jmx.gluon.data.vision.MNIST(root=str(tmp_path), train=train)
        assert len(got) == len(want) == n
        _same_samples(_samples(got, range(n)), _samples(want, range(n)))


def _cifar_batch(rng, n, key):
    return {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
            key: list(rng.randint(0, 10, n))}


def test_cifar_reads_pickled_batches(tmp_path):
    rng = np.random.RandomState(2)
    c10 = tmp_path / "c10" / "cifar-10-batches-py"
    c10.mkdir(parents=True)
    for f in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        with open(c10 / f, "wb") as fh:
            pickle.dump(_cifar_batch(rng, 3, b"labels"), fh)
    c100 = tmp_path / "c100" / "cifar-100-python"
    c100.mkdir(parents=True)
    for f in ("train", "test"):
        d = _cifar_batch(rng, 4, b"fine_labels")
        d[b"coarse_labels"] = list(rng.randint(0, 20, 4))
        with open(c100 / f, "wb") as fh:
            pickle.dump(d, fh)
    for cls, root, kw, n in (("CIFAR10", "c10", {}, 15),
                             ("CIFAR10", "c10", {"train": False}, 3),
                             ("CIFAR100", "c100", {}, 4),
                             ("CIFAR100", "c100", {"fine_label": True}, 4)):
        got = getattr(gdata.vision, cls)(root=str(tmp_path / root), **kw)
        want = getattr(jmx.gluon.data.vision, cls)(
            root=str(tmp_path / root), **kw)
        _same_samples(_samples(got, range(n)), _samples(want, range(n)))


def _pngs(rng, n, shape=(9, 7, 3)):
    return [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]


def test_image_record_dataset_reads_a_rec_of_pngs(tmp_path):
    rng = np.random.RandomState(3)
    imgs = _pngs(rng, 4)
    rec = recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                                     str(tmp_path / "d.rec"), "w")
    for i, img in enumerate(imgs):
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i % 3),
                                                         i, 0),
                                       image.imencode(img, ".png")))
    rec.close()
    got = gdata.vision.ImageRecordDataset(str(tmp_path / "d.rec"))
    want = jmx.gluon.data.vision.ImageRecordDataset(str(tmp_path / "d.rec"))
    assert len(got) == len(want) == 4
    _same_samples(_samples(got, range(4)), _samples(want, range(4)))
    gray = gdata.vision.ImageRecordDataset(str(tmp_path / "d.rec"), flag=0)
    jgray = jmx.gluon.data.vision.ImageRecordDataset(
        str(tmp_path / "d.rec"), flag=0)
    _same_samples(_samples(gray, range(4)), _samples(jgray, range(4)))


def test_image_folder_dataset_reads_pngs_and_npy(tmp_path):
    rng = np.random.RandomState(4)
    for cls in ("b_dogs", "a_cats"):
        (tmp_path / "f" / cls).mkdir(parents=True)
        for i, img in enumerate(_pngs(rng, 2)):
            (tmp_path / "f" / cls / ("%d.png" % i)).write_bytes(
                image.imencode(img, ".png"))
    np.save(tmp_path / "f" / "a_cats" / "z.npy",
            rng.rand(5, 4, 3).astype(np.float32))
    (tmp_path / "f" / "a_cats" / "notes.txt").write_text("skipped")
    got = gdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    want = jmx.gluon.data.vision.ImageFolderDataset(str(tmp_path / "f"))
    assert got.synsets == want.synsets == ["a_cats", "b_dogs"]
    assert [os.path.basename(f) for f, _ in got.items] == \
        [os.path.basename(f) for f, _ in want.items]
    _same_samples(_samples(got, range(5)), _samples(want, range(5)))
    # a JPEG among them decodes to PIL's pixels, as in the JAX package
    jpg = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (7, 5, 3)).astype(np.uint8)).save(
        jpg, format="JPEG", quality=90)
    (tmp_path / "f" / "a_cats" / "y.jpg").write_bytes(jpg.getvalue())
    got = gdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    want = jmx.gluon.data.vision.ImageFolderDataset(str(tmp_path / "f"))
    i = [os.path.basename(f) for f, _ in got.items].index("y.jpg")
    with mx.cpu():  # the plain JPEG codec
        _same_samples(_samples(got, [i]), _samples(want, [i]))


def test_transform_first_and_lazy_transform():
    for pkg in (jmx, mx):
        with pkg.cpu():
            ds = pkg.gluon.data.ArrayDataset(np.arange(6).reshape(3, 2),
                                             [10, 11, 12])
            t = ds.transform_first(lambda x: x * 2)
            assert [(list(a), b) for a, b in t] == \
                [([0, 2], 10), ([4, 6], 11), ([8, 10], 12)]
            eager = ds.transform(lambda x, y: y, lazy=False)
            assert list(eager) == [10, 11, 12]
            assert len(ds.filter(lambda s: s[1] > 10)) == 2


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_give_the_jax_order(last):
    orders = []
    for pkg in (jmx, mx):
        pkg.random.seed(13)
        s = pkg.gluon.data.BatchSampler(pkg.gluon.data.RandomSampler(10), 4,
                                        last)
        orders.append(([list(map(int, b)) for b in s],
                       [list(map(int, b)) for b in s], len(s)))
        assert list(pkg.gluon.data.SequentialSampler(3)) == [0, 1, 2]
    assert orders[1] == orders[0]
    with pytest.raises(ValueError, match="last_batch"):
        list(gdata.BatchSampler(gdata.SequentialSampler(3), 2, "nope"))


def _loader_batches(pkg, **kw):
    rng = np.random.RandomState(5)
    x = rng.rand(11, 3, 4).astype(np.float32)
    y = rng.randint(0, 5, 11).astype(np.int32)
    with pkg.cpu():
        pkg.random.seed(21)
        ds = pkg.gluon.data.ArrayDataset(pkg.nd.array(x), y)
        loader = pkg.gluon.data.DataLoader(ds, **kw)
        return [[b.asnumpy() for b in batch] for batch in loader], \
            len(loader)


@pytest.mark.parametrize("kw", [
    {"batch_size": 4},
    {"batch_size": 4, "shuffle": True, "last_batch": "discard"},
    {"batch_size": 3, "shuffle": True, "last_batch": "rollover"}])
@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_gives_the_jax_batches_in_order(kw, workers):
    got, n = _loader_batches(mx, num_workers=workers, **kw)
    want, jn = _loader_batches(jmx, num_workers=workers, **kw)
    assert n == jn and len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_dataloader_batch_sampler_tuples_and_target():
    sampler = gdata.BatchSampler(gdata.SequentialSampler(5), 2, "keep")
    ds = gdata.SimpleDataset([(np.float32(i), i * 2) for i in range(5)])
    with pytest.raises(ValueError, match="batch_sampler"):
        gdata.DataLoader(ds, batch_size=2, batch_sampler=sampler)
    with pytest.raises(MXNetError, match="CUDA"):
        gdata.DataLoader(ds, batch_sampler=sampler, sharding="cuda")
    for target in (mx.cpu(), "cpu",
                   mx.parallel.device_mesh(1, devices=[mx.cpu()])):
        loader = gdata.DataLoader(ds, batch_sampler=sampler, sharding=target)
        batches = [[b.asnumpy().tolist() for b in batch]
                   for batch in loader]
        assert batches == [[[0.0, 1.0], [0, 2]], [[2.0, 3.0], [4, 6]],
                           [[4.0], [8]]]
        assert all(b.context == mx.cpu() for b in next(iter(loader)))


def test_prefetch_counter_counts_batches_built_ahead():
    before = _T_PREFETCH.value(pipeline="gluon.DataLoader")
    got, _ = _loader_batches(mx, batch_size=4, num_workers=2, prefetch=1)
    assert _T_PREFETCH.value(pipeline="gluon.DataLoader") - before == \
        len(got) == 3


IMG = np.random.RandomState(6).randint(0, 256, (12, 10, 3)).astype(np.uint8)

TRANSFORMS = [
    ("Cast", lambda T: T.Cast("float16"), False),
    ("ToTensor", lambda T: T.ToTensor(), False),
    ("Normalize", lambda T: T.Compose([T.ToTensor(), T.Normalize(
        (0.4, 0.5, 0.6), (0.2, 0.3, 0.25))]), False),
    ("Resize", lambda T: T.Resize((6, 5)), False),
    ("Resize_up", lambda T: T.Resize(15), False),
    ("Resize_keep", lambda T: T.Resize(7, keep_ratio=True), False),
    ("CenterCrop", lambda T: T.CenterCrop((6, 4)), False),
    ("CenterCrop_up", lambda T: T.CenterCrop(14), False),
    ("RandomResizedCrop", lambda T: T.RandomResizedCrop(8), True),
    ("RandomResizedCrop_scale", lambda T: T.RandomResizedCrop(
        (5, 7), scale=(0.5, 0.9)), True),
    ("RandomFlipLeftRight", lambda T: T.RandomFlipLeftRight(), True),
    ("RandomFlipTopBottom", lambda T: T.RandomFlipTopBottom(), True),
    ("RandomBrightness", lambda T: T.RandomBrightness(0.4), True),
    ("RandomContrast", lambda T: T.RandomContrast(0.4), True),
    ("RandomSaturation", lambda T: T.RandomSaturation(0.4), True),
    ("RandomHue", lambda T: T.RandomHue(0.3), True),
    ("RandomColorJitter", lambda T: T.RandomColorJitter(0.3, 0.3, 0.3, 0.1),
     True),
    ("RandomLighting", lambda T: T.RandomLighting(0.1), True),
    ("Compose_lambda", lambda T: T.Compose([
        T.RandomResizedCrop(6), lambda x: x * 0.5, T.RandomFlipLeftRight(),
        T.ToTensor()]), True),
]


@pytest.mark.parametrize("case", TRANSFORMS, ids=[c[0] for c in TRANSFORMS])
def test_transforms_equal_the_jax_package(case):
    _, make, random = case
    outs = []
    for pkg, tmod in ((jmx, jmx.gluon.data.vision.transforms), (mx, T)):
        with pkg.cpu():
            pkg.random.seed(31)
            t = make(tmod)
            res = [t(pkg.nd.array(IMG, dtype="uint8")).asnumpy()
                   for _ in range(4 if random else 1)]
        outs.append(res)
    for g, w in zip(outs[1], outs[0]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32), **TOL)


RESIZING = [
    ("Resize_nhwc", lambda T: T.Resize((6, 5)), (2, 12, 10, 3), "float32"),
    ("Resize_f16", lambda T: T.Resize(7), (12, 10, 3), "float16"),
    ("CenterCrop_up", lambda T: T.CenterCrop(14), (12, 10, 3), "uint8"),
    ("RandomResizedCrop", lambda T: T.RandomResizedCrop(8), (12, 10, 3),
     "uint8"),
]


@pytest.mark.parametrize("case", RESIZING, ids=[c[0] for c in RESIZING])
def test_resizing_transforms_stay_on_the_device(case, monkeypatch):
    """The resizing transforms compute on the image's device: no copy to
    the host (``asnumpy`` is barred while they run), the output on the
    input's context, and the JAX package's values and dtype."""
    _, make, shape, dtype = case
    img = np.random.RandomState(8).randint(0, 256, shape).astype(dtype)
    with jmx.cpu():
        jmx.random.seed(5)
        want = make(jmx.gluon.data.vision.transforms)(
            jmx.nd.array(img, dtype=dtype)).asnumpy()
    with mx.cpu():
        mx.random.seed(5)
        x = mx.nd.array(img, dtype=dtype)
        t = make(T)

        def no_host_copy(self):
            raise AssertionError("a host copy in a resizing transform")

        with monkeypatch.context() as m:
            m.setattr(mx.nd.NDArray, "asnumpy", no_host_copy)
            out = t(x)
    assert out.context == x.context
    got = out.asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **TOL)


def test_transforms_cover_the_jax_names():
    assert set(T.__all__) == set(jmx.gluon.data.vision.transforms.__all__)
    assert len(T.__all__) == 15


def test_totensor_and_normalize_on_a_batch():
    batch = np.random.RandomState(7).randint(0, 256, (2, 5, 4, 3)).astype(
        np.uint8)
    outs = []
    for pkg, tmod in ((jmx, jmx.gluon.data.vision.transforms), (mx, T)):
        with pkg.cpu():
            x = tmod.ToTensor()(pkg.nd.array(batch, dtype="uint8"))
            outs.append(x.asnumpy())
    assert outs[1].shape == (2, 3, 5, 4)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_dataloader_threads_under_stress():
    """More worker threads than cores and a short switch interval: the
    batches come in the sampler's order, each once, and the prefetch
    counter counts every batch (no lost update)."""
    import sys

    x = np.arange(128, dtype=np.float32).reshape(64, 2)
    before = _T_PREFETCH.value(pipeline="gluon.DataLoader")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with mx.cpu():
            loader = gdata.DataLoader(gdata.ArrayDataset(x), batch_size=2,
                                      num_workers=16, prefetch=32)
            got = [b.asnumpy() for b in loader]
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == 32
    np.testing.assert_array_equal(np.concatenate(got), x)
    assert _T_PREFETCH.value(pipeline="gluon.DataLoader") - before == 32
