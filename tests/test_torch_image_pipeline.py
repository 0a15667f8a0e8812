"""The port's record pipeline against the JAX package's (CPU):
``image_pipeline.MPImageRecordIter`` (worker processes, the plain codec
under ``mx.cpu()``), ``io.ImageRecordIter``'s single process and its
choice between the two, and ``tools/im2rec.py``.

* the port's counterparts of ``tests/test_image_pipeline.py``: epochs
  hand out every record once across workers, the last batch wraps
  around with ``pad`` set, and the wiring follows the rule as
  ``mxnet_tpu/io.py`` codes it (an ``.idx``, more than one worker, a
  spawnable ``__main__``, no ``force_single_process``);
* with one worker and a seed, the port's MPImageRecordIter gives the JAX
  package's batches bit for bit (PIL decode and BILINEAR resize there,
  the port's codec here), both in the stretch and the crop-and-mirror
  configuration;
* the single-process iterator equals the JAX package's within one uint8
  level (``imresize``, the tolerance of
  ``test_torch_image_io.py::test_imresize_matches_jax``);
* the port's ``im2rec`` lists the JAX tool's ``.lst`` and writes the
  same records: equal headers, and JPEG payloads byte for byte (PNG
  payloads decode to equal pixels; with
  ``--resize``, whose ``imresize`` may differ by one level before the
  encode, equal headers and shapes and decoded pixels within 2 levels on
  average);
* ``tools/pipeline_bench.py`` prints the JAX tool's keys;
* the input path's rules: without a card and without ``mx.cpu()`` the
  record iterators and the codec raise; no module of the port imports
  PIL, OpenCV, torchvision, jax or mxnet_tpu; ``im2rec``, the worker
  processes, ``ImageIter``'s random branches and ``train_resnet.py
  --rec`` run where those cannot be imported.
"""
import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import io as mxio
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.image_pipeline import MPImageRecordIter
from mxnet_tpu_torch.tools import im2rec

REPO = Path(__file__).resolve().parent.parent
N_REC = 48


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    """48 noise images 40x56 at quality 92, written by the port's encoder
    (PIL's bytes)."""
    d = tmp_path_factory.mktemp("port_recs")
    rec, idx = str(d / "toy.rec"), str(d / "toy.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rs = np.random.RandomState(0)
    with mx.cpu():
        for i in range(N_REC):
            img = (rs.rand(40, 56, 3) * 255).astype(np.uint8)
            w.write_idx(i, recordio.pack_img(
                recordio.IRHeader(0, float(i), i, 0), img, quality=92))
    w.close()
    return rec


def test_mp_pipeline_epochs_cover_dataset(rec_file):
    with mx.cpu():
        it = MPImageRecordIter(rec_file, data_shape=(3, 32, 32),
                               batch_size=16, shuffle=True, rand_crop=True,
                               rand_mirror=True, preprocess_threads=2,
                               prefetch_buffer=3)
    try:
        seen = []
        for epoch in range(2):
            if epoch:
                it.reset()
            for batch in it:
                assert batch.data[0].shape == (16, 3, 32, 32)
                assert batch.label[0].shape == (16,)
                assert batch.data[0]._data.device.type == "cpu"
                seen += batch.label[0].asnumpy()[:16 - batch.pad].tolist()
        assert collections.Counter(seen) == collections.Counter(
            [float(i) for i in range(N_REC)] * 2)
        m = batch.data[0].asnumpy().mean()
        assert 100 < m < 155, m
        assert it.lib_calls == {"decode": 0, "encode": 0, "resize": 0}
    finally:
        it.close()


def test_mp_pipeline_padding(rec_file):
    with mx.cpu():
        it = MPImageRecordIter(rec_file, data_shape=(3, 32, 32),
                               batch_size=20, preprocess_threads=2)
    try:
        assert [b.pad for b in it] == [0, 0, 12]
    finally:
        it.close()
    with mx.cpu():
        it = MPImageRecordIter(rec_file, data_shape=(3, 32, 32),
                               batch_size=20, preprocess_threads=1,
                               round_batch=False)
    try:
        assert [b.pad for b in it] == [0, 0]
    finally:
        it.close()


def test_io_wiring_follows_the_rule(rec_file, monkeypatch, tmp_path):
    kw = dict(path_imgrec=rec_file, data_shape=(3, 32, 32), batch_size=8,
              prefetch_buffer=2)
    monkeypatch.setattr(mxio, "_spawnable", lambda: True)
    with mx.cpu():
        it = mxio.ImageRecordIter(preprocess_threads=2, **kw)
        try:
            assert isinstance(it, MPImageRecordIter)
            assert it.next().data[0].shape == (8, 3, 32, 32)
        finally:
            it.close()
        for extra in (dict(preprocess_threads=1),
                      dict(preprocess_threads=2, force_single_process=True)):
            it = mxio.ImageRecordIter(**kw, **extra)
            assert isinstance(it, mxio.PrefetchingIter)
            assert it.next().data[0].shape == (8, 3, 32, 32)
        it = mxio.ImageRecordIter(preprocess_threads=0, **kw)
        assert isinstance(it, mxio._RecordIter)
        monkeypatch.setattr(mxio, "_spawnable", lambda: False)
        it = mxio.ImageRecordIter(preprocess_threads=2, **kw)
        assert not isinstance(it, MPImageRecordIter)
        noidx = tmp_path / "noidx.rec"
        noidx.write_bytes(Path(rec_file).read_bytes())
        monkeypatch.setattr(mxio, "_spawnable", lambda: True)
        it = mxio.ImageRecordIter(path_imgrec=str(noidx),
                                  data_shape=(3, 32, 32), batch_size=8,
                                  preprocess_threads=2, prefetch_buffer=0)
        assert isinstance(it, mxio._RecordIter)
        assert it.next().data[0].shape == (8, 3, 32, 32)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(shuffle=True, rand_crop=True, rand_mirror=True, resize=36,
         mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
         std_g=57.12, std_b=57.375)], ids=["stretch", "crop_mirror"])
def test_mp_one_worker_equals_jax(rec_file, cfg):
    from mxnet_tpu.image_pipeline import MPImageRecordIter as JaxMP

    kw = dict(data_shape=(3, 32, 28), batch_size=20, preprocess_threads=1,
              prefetch_buffer=2, seed=7, **cfg)
    jit = JaxMP(rec_file, **kw)
    with mx.cpu():
        tit = MPImageRecordIter(rec_file, **kw)
    try:
        for _ in range(2):
            for jb, tb in zip(jit, tit):
                np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                              jb.data[0].asnumpy())
                np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                              jb.label[0].asnumpy())
                assert tb.pad == jb.pad
            jit.reset()
            tit.reset()
    finally:
        jit.close()
        tit.close()


def test_single_process_equals_jax(rec_file):
    kw = dict(path_imgrec=rec_file, data_shape=(3, 24, 30), batch_size=10,
              shuffle=True, preprocess_threads=0, prefetch_buffer=0)
    jmx.random.seed(4)
    jit = jmx.io.ImageRecordIter(**kw)
    mx.random.seed(4)
    with mx.cpu():
        tit = mxio.ImageRecordIter(**kw)
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in tit]
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in jit]
    assert len(got) == len(want) == 5
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.shape == wd.shape and gp == wp
        assert np.abs(gd - wd).max() <= 1.0
        np.testing.assert_array_equal(gl, wl)


def _jax_im2rec():
    spec = importlib.util.spec_from_file_location(
        "jax_im2rec", REPO / "tools" / "im2rec.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Two class folders of PIL-written JPEGs and PNGs, some gray."""
    from PIL import Image

    root = tmp_path_factory.mktemp("im2rec_src")
    rs = np.random.RandomState(9)
    for cls in ("cats", "dogs"):
        (root / cls).mkdir()
        for i in range(4):
            h, w = rs.randint(20, 60, 2)
            img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
            pil = Image.fromarray(img if i != 1 else img[..., 0])
            if i % 2:
                pil.save(root / cls / ("%d.png" % i))
            else:
                pil.save(root / cls / ("%d.jpg" % i), quality=85)
    return root


def _records(prefix):
    r = jrec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    out = {k: jrec.unpack(r.read_idx(k)) for k in r.keys}
    r.close()
    return out


@pytest.mark.parametrize("extra", [[], ["--quality", "80", "--color", "0"],
                                   ["--center-crop", "--encoding", ".png"]],
                         ids=["default", "gray_q80", "crop_png"])
def test_im2rec_writes_the_jax_tools_records(image_dir, tmp_path, extra):
    jtool = _jax_im2rec()
    jpre, tpre = str(tmp_path / "j"), str(tmp_path / "t")
    jtool.main([jpre, str(image_dir), "--list", "--recursive"])
    im2rec.main([tpre, str(image_dir), "--list", "--recursive"])
    assert Path(jpre + ".lst").read_text() == Path(tpre + ".lst").read_text()
    jtool.main([jpre, str(image_dir)] + extra)
    im2rec.main([tpre, str(image_dir), "--device", "cpu"] + extra)
    want, got = _records(jpre), _records(tpre)
    assert sorted(got) == sorted(want) and len(got) == 8
    for k in want:
        assert got[k][0] == want[k][0]
        if want[k][1][:2] == b"\xff\xd8":
            assert got[k][1] == want[k][1]
        else:  # PNG: the port's encoder filters differently, same pixels
            np.testing.assert_array_equal(
                jmx.image.imdecode(got[k][1], to_numpy=True),
                jmx.image.imdecode(want[k][1], to_numpy=True))


def test_im2rec_resize_and_threads(image_dir, tmp_path):
    jtool = _jax_im2rec()
    jpre, tpre = str(tmp_path / "j"), str(tmp_path / "t")
    jtool.main([jpre, str(image_dir), "--list", "--recursive"])
    im2rec.main([tpre, str(image_dir), "--list", "--recursive"])
    jtool.main([jpre, str(image_dir), "--resize", "24"])
    im2rec.main([tpre, str(image_dir), "--resize", "24", "--device", "cpu",
                 "--num-thread", "3"])
    want, got = _records(jpre), _records(tpre)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k][0] == want[k][0]
        with mx.cpu():
            g = mx.image.imdecode(got[k][1], to_numpy=True)
        w = jmx.image.imdecode(want[k][1], to_numpy=True)
        assert g.shape == w.shape
        assert np.abs(g.astype(int) - w.astype(int)).mean() <= 2.0


def test_input_path_defaults_to_the_card(rec_file):
    """Without a card and without ``mx.cpu()``, the record iterators and
    the codec raise instead of quietly using the host."""
    import torch

    from mxnet_tpu_torch import MXNetError, _imgcodec

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(MXNetError, match="no CUDA device"):
        MPImageRecordIter(rec_file, data_shape=(3, 8, 8), batch_size=4)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mxio.ImageRecordIter(path_imgrec=rec_file, data_shape=(3, 8, 8),
                             batch_size=4, preprocess_threads=0)
    with pytest.raises(MXNetError, match="no CUDA device"):
        _imgcodec.decode(recordio.unpack(open(rec_file, "rb").read()[8:])[1])
    assert im2rec.parse_args(["p", "r"]).device == "gpu"


def _port_sources():
    return sorted((REPO / "mxnet_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_port_imports_no_image_library():
    """The card's machine has no PIL, OpenCV or torchvision: no module of
    the port imports one (an AST scan)."""
    import ast

    banned = {"PIL", "cv2", "torchvision", "jax", "jaxlib", "mxnet_tpu"}
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not banned & set(roots), (path, roots)


def test_input_path_runs_with_pil_jax_and_mxnet_tpu_blocked(tmp_path):
    """im2rec, the worker processes (which inherit the blocking
    PYTHONPATH), ImageIter's random branches and the --rec example run
    where PIL, jax and mxnet_tpu cannot be imported."""
    import os
    import subprocess
    import sys

    from conftest import subprocess_env

    fake = tmp_path / "blocked"
    for name in ("PIL", "jax", "jaxlib", "mxnet_tpu", "cv2", "torchvision"):
        (fake / name).mkdir(parents=True)
        (fake / name / "__init__.py").write_text(
            "raise ImportError('%s is blocked')\n" % name)
    script = tmp_path / "drive.py"
    script.write_text(r'''
import os, sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image
from mxnet_tpu_torch.example.gluon import train_resnet
from mxnet_tpu_torch.image_pipeline import MPImageRecordIter
from mxnet_tpu_torch.tools import im2rec

if __name__ == "__main__":
    tmp = sys.argv[1]
    src = os.path.join(tmp, "src", "a")
    os.makedirs(src)
    rs = np.random.RandomState(1)
    with mx.cpu():
        for i in range(8):
            img = (rs.rand(40, 48, 3) * 255).astype(np.uint8)
            with open(os.path.join(src, "%d.jpg" % i), "wb") as f:
                f.write(image.imencode(img, ".jpg", quality=90))
    pre = os.path.join(tmp, "data")
    im2rec.main([pre, os.path.join(tmp, "src"), "--list", "--recursive"])
    im2rec.main([pre, os.path.join(tmp, "src"), "--device", "cpu"])
    with mx.cpu():
        it = MPImageRecordIter(pre + ".rec", data_shape=(3, 32, 32),
                               batch_size=4, rand_crop=True, rand_mirror=True,
                               resize=36, preprocess_threads=2)
        n = sum(4 - b.pad for b in it)
        it.close()
        ii = image.ImageIter(4, (3, 24, 24), path_imgrec=pre + ".rec",
                             rand_crop=True, rand_resize=True, hue=0.1,
                             brightness=0.2, pca_noise=0.1, rand_gray=0.5)
        b = ii.next()
    res = train_resnet.run(train_resnet.parse_args(
        ["--device", "cpu", "--model", "resnet18_v1", "--batch-size", "4",
         "--image-size", "32", "--num-classes", "2", "--rec", pre + ".rec"]))
    assert not any(k.split(".")[0] in ("jax", "mxnet_tpu", "PIL")
                   for k, v in sys.modules.items() if v is not None)
    print("ran", n, b.data[0].shape, len(res["losses"]))
''')
    env = subprocess_env()
    env["PYTHONPATH"] = os.pathsep.join([str(fake), str(REPO)])
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ran 8 (4, 3, 24, 24) 2" in proc.stdout


def test_pipeline_bench_on_the_host():
    """tools/pipeline_bench.py's three readings (here two: no --train),
    under the JAX tool's keys, on the CPU with the plain codec."""
    from mxnet_tpu_torch.tools import pipeline_bench

    res = pipeline_bench.run(pipeline_bench.parse_args(
        ["--device", "cpu", "--images", "24", "--side", "48", "--crop",
         "40", "--batch-size", "8", "--workers", "2", "--seconds", "0.5"]))
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert set(res["extra"]) == {"single_process_img_s", "speedup_vs_single",
                                 "batch"}
    assert res["value"] > 0 and res["extra"]["single_process_img_s"] > 0
