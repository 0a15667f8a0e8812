"""The port's ``io.MNISTIter`` against the JAX package's (CPU), over idx
files written to ``tmp_path`` from the example's synthetic set, plain
and ``.gz``: the same batches (pad included), ``flat`` and
``input_shape`` layouts, and the same seeded shuffle; the batches are
the arrays the files were written from.
"""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.example.image_classification import train_mnist

N, BATCH = 150, 32


def write_idx(tmp_path, suffix, n=N, seed=7):
    """The synthetic set as MNIST idx files; returns the paths and the
    arrays (images as uint8, labels as uint8)."""
    img, lab = train_mnist._synthetic_mnist(n, seed)
    img8 = np.clip(img[:, 0] / img.max() * 255.0, 0, 255).astype(np.uint8)
    lab8 = lab.astype(np.uint8)
    opener = gzip.open if suffix == ".gz" else open
    paths = (str(tmp_path / ("images-idx3-ubyte" + suffix)),
             str(tmp_path / ("labels-idx1-ubyte" + suffix)))
    with opener(paths[0], "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(img8.tobytes())
    with opener(paths[1], "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(lab8.tobytes())
    return paths, img8, lab8


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


@pytest.mark.parametrize("layout", [{}, {"flat": True},
                                    {"input_shape": (784,)},
                                    {"input_shape": (1, 28, 28)}],
                         ids=["nchw", "flat", "shape_784", "shape_1x28x28"])
@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_batches_match_jax_and_the_files(tmp_path, suffix, layout):
    (img_p, lab_p), img8, lab8 = write_idx(tmp_path, suffix)
    with mx.cpu():
        mine = _batches(mx.io.MNISTIter(image=img_p, label=lab_p,
                                        batch_size=BATCH, shuffle=False,
                                        **layout))
    theirs = _batches(jmx.io.MNISTIter(image=img_p, label=lab_p,
                                       batch_size=BATCH, shuffle=False,
                                       **layout))
    assert len(mine) == len(theirs) == -(-N // BATCH)
    want = img8.astype(np.float32) / 255.0
    for k, ((d, l, pad), (jd, jl, jpad)) in enumerate(zip(mine, theirs)):
        assert pad == jpad
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(l, jl)
        rows = np.arange(k * BATCH, (k + 1) * BATCH) % N
        np.testing.assert_array_equal(d.reshape(BATCH, 28, 28), want[rows])
        np.testing.assert_array_equal(l, lab8[rows].astype(np.float32))
    shape = {"flat": (BATCH, 784)}.get(next(iter(layout), None))
    if "input_shape" in layout:
        shape = (BATCH,) + layout["input_shape"]
    assert mine[0][0].shape == (shape or (BATCH, 1, 28, 28))


def test_seeded_shuffle_matches_jax(tmp_path):
    (img_p, lab_p), _, _ = write_idx(tmp_path, ".gz")
    mx.random.seed(9)
    with mx.cpu():
        mine = _batches(mx.io.MNISTIter(image=img_p, label=lab_p,
                                        batch_size=BATCH, shuffle=True))
    jmx.random.seed(9)
    theirs = _batches(jmx.io.MNISTIter(image=img_p, label=lab_p,
                                       batch_size=BATCH, shuffle=True))
    for (d, l, _), (jd, jl, _) in zip(mine, theirs):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(l, jl)
    with mx.cpu():
        plain = _batches(mx.io.MNISTIter(image=img_p, label=lab_p,
                                         batch_size=BATCH, shuffle=False))
    assert not np.array_equal(mine[0][1], plain[0][1])


def test_the_example_reads_idx_files(tmp_path):
    """``get_mnist_iter`` takes the idx files when all four are there."""
    for name, n, seed in (("train", 128, 7), ("t10k", 64, 8)):
        (img_p, lab_p), _, _ = write_idx(tmp_path, ".gz", n, seed)
        import os
        os.rename(img_p, str(tmp_path / ("%s-images-idx3-ubyte.gz" % name)))
        os.rename(lab_p, str(tmp_path / ("%s-labels-idx1-ubyte.gz" % name)))
    args = train_mnist.parse_args(["--data-dir", str(tmp_path),
                                   "--batch-size", "32"])
    with mx.cpu():
        train, val = train_mnist.get_mnist_iter(args, None)
    assert isinstance(train, mx.io.MNISTIter)
    assert train.num_data == 128 and val.num_data == 64
