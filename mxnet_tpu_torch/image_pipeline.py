"""The throughput image input pipeline: the port of
``mxnet_tpu/image_pipeline.py`` (the counterpart of the reference's C++
``ImageRecordIter2``, ``src/io/iter_image_recordio_2.cc``).

Worker processes, not threads: each worker opens the ``.rec`` on its
own, decodes JPEG, resizes with Pillow's ``BILINEAR`` (the port's
codec, ``_imgcodec``), crops, mirrors and normalizes, and writes finished
float32 batches into POSIX shared memory. The master hands out batch
assignments over a task queue, restores their order with a reorder
buffer, and gives :class:`~mxnet_tpu_torch.io.DataBatch` objects on its
context: to the card in one copy of a pinned host buffer (data and
labels together), on the host as CPU NDArrays.

The codec is the one the master's context picks: the host library
(``ops/csrc/imgcodec.cc``, built by the master before the workers
start, so they never race a build) on the card, the plain numpy version
under ``mx.cpu()``. Workers are ``spawn``ed and import this package
fresh; they must not touch the card, so the master hides it from them
(``CUDA_VISIBLE_DEVICES`` empty) around ``start()``.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .base import MXNetError
from .context import current_context
from .io import DataBatch, DataDesc, DataIter

__all__ = ["MPImageRecordIter"]


# ---------------------------------------------------------------------------
# worker side: numpy and the port's codec only
# ---------------------------------------------------------------------------

def _decode_augment(raw: bytes, cfg: dict, rng: np.random.RandomState,
                    lib: bool):
    """One record -> (CHW float32 image, label vector)."""
    from . import _imgcodec, recordio
    from .image import decode_pixels

    header, img_bytes = recordio.unpack(raw)
    label = np.atleast_1d(np.asarray(header.label, np.float32))
    img = decode_pixels(bytes(img_bytes), 1, 1, lib=lib)  # RGB
    c, th, tw = cfg["data_shape"]
    h, w = img.shape[:2]
    if not cfg.get("rand_crop") and not cfg.get("resize"):
        # plain configuration: stretch straight to the target shape
        if (w, h) != (tw, th):
            img = _imgcodec.resize_bilinear(img, tw, th, lib=lib)
    else:
        # augmenting configuration: short side, then a crop (the
        # reference's default augmenter geometry, image_aug_default.cc)
        short = cfg.get("resize") or max(th, tw)
        scale = short / min(w, h)
        if scale != 1.0:
            img = _imgcodec.resize_bilinear(
                img, max(tw, int(w * scale + 0.5)),
                max(th, int(h * scale + 0.5)), lib=lib)
        h, w = img.shape[:2]
        if cfg.get("rand_crop"):
            x0 = rng.randint(0, w - tw + 1)
            y0 = rng.randint(0, h - th + 1)
        else:
            x0, y0 = (w - tw) // 2, (h - th) // 2
        img = img[y0:y0 + th, x0:x0 + tw]
    arr = np.asarray(img, np.float32)
    if cfg.get("rand_mirror") and rng.randint(2):
        arr = arr[:, ::-1]
    mean = cfg.get("mean")
    if mean is not None:
        arr -= mean
    std = cfg.get("std")
    if std is not None:
        arr /= std
    chw = np.transpose(arr, (2, 0, 1))
    if c == 1:
        chw = chw.mean(axis=0, keepdims=True)
    return chw, label


def _worker_main(task_q, result_q, rec_path, idx_path, cfg, seed, lib):
    """Worker loop: take (seq, shm_name, keys, pad), write the batch into
    the shared memory, report (seq, shm_name, pad, error, library calls).
    Runs in a spawned process."""
    from multiprocessing import shared_memory

    from . import _imgcodec, recordio

    rec = recordio.MXIndexedRecordIO(idx_path, rec_path, "r")
    rng = np.random.RandomState(seed)
    c, h, w = cfg["data_shape"]
    label_width = cfg["label_width"]
    batch_size = cfg["batch_size"]
    img_bytes = batch_size * c * h * w * 4
    opened = {}
    try:
        while True:
            task = task_q.get()
            if task is None:
                break
            seq, shm_name, keys, pad = task
            before = dict(_imgcodec.LIB_CALLS)
            try:
                shm = opened.get(shm_name)
                if shm is None:
                    shm = shared_memory.SharedMemory(name=shm_name)
                    opened[shm_name] = shm
                data = np.ndarray((batch_size, c, h, w), np.float32,
                                  buffer=shm.buf[:img_bytes])
                labels = np.ndarray((batch_size, label_width), np.float32,
                                    buffer=shm.buf[img_bytes:])
                for slot, key in enumerate(keys):
                    img, lab = _decode_augment(rec.read_idx(key), cfg, rng,
                                               lib)
                    data[slot] = img
                    labels[slot, :label_width] = lab[:label_width]
                err = None
            except Exception as exc:  # noqa: BLE001 - raised at next()
                err = "%s: %s" % (type(exc).__name__, exc)
            calls = {k: v - before[k] for k, v in _imgcodec.LIB_CALLS.items()}
            result_q.put((seq, shm_name, pad, err, calls))
    finally:
        for shm in opened.values():
            shm.close()


# ---------------------------------------------------------------------------
# master side
# ---------------------------------------------------------------------------

class MPImageRecordIter(DataIter):
    """Multiprocess ImageRecordIter (reference iter_image_recordio_2.cc),
    the JAX package's parameters: ``path_imgrec`` (its ``.idx`` is
    required), ``data_shape`` (C, H, W), ``batch_size``, ``shuffle``,
    ``rand_crop``, ``rand_mirror``, ``resize`` (short side),
    ``mean_r/g/b``, ``std_r/g/b``, ``label_width``, ``preprocess_threads``
    (worker processes), ``prefetch_buffer`` (batches in flight), ``seed``
    (else drawn from ``mx.random``), ``round_batch`` (wrap the last batch
    around, ``pad`` set; else drop it).

    ``lib_calls`` sums the workers' host-library calls (decode, resize)
    since construction."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 resize=0, label_width=1, preprocess_threads=4,
                 prefetch_buffer=4, seed=None, round_batch=True,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, **kwargs):
        super().__init__(batch_size)
        import multiprocessing as mp
        from multiprocessing import shared_memory

        from . import _imgcodec, recordio

        self._closed = True  # until the workers exist
        self._ctx = current_context()
        idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
        if not os.path.exists(idx_path):
            raise MXNetError(
                "MPImageRecordIter requires %s (workers address records by "
                "key); build it with tools/im2rec.py" % idx_path)
        index = recordio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
        self._keys: List[int] = list(index.keys)
        index.close()
        if not self._keys:
            raise MXNetError("empty record file %s" % path_imgrec)

        self.data_shape = tuple(data_shape)
        self._label_width = label_width
        self._shuffle = shuffle
        if seed is None:
            from . import random as _random

            seed = int(_random.np_rng().randint(0, 2 ** 31 - 1))
        self._rng = np.random.RandomState(seed)
        self._round_batch = round_batch

        mean = None
        if mean_r or mean_g or mean_b:
            mean = np.asarray([mean_r, mean_g, mean_b], np.float32)
        std = None
        if (std_r, std_g, std_b) != (1.0, 1.0, 1.0):
            std = np.asarray([std_r, std_g, std_b], np.float32)
        cfg = {"data_shape": self.data_shape, "batch_size": batch_size,
               "label_width": label_width, "rand_crop": rand_crop,
               "rand_mirror": rand_mirror, "resize": resize,
               "mean": mean, "std": std}
        self._lib = _imgcodec.use_library(self._ctx)
        if self._lib:
            _imgcodec.library()  # built here, once, before any worker
        self.lib_calls = {"decode": 0, "encode": 0, "resize": 0}

        n_workers = max(1, int(preprocess_threads))
        depth = max(2, int(prefetch_buffer))
        c, h, w = self.data_shape
        self._img_floats = batch_size * c * h * w
        self._img_bytes = self._img_floats * 4
        shm_bytes = self._img_bytes + batch_size * label_width * 4

        spawn = mp.get_context("spawn")
        self._task_q = spawn.Queue()
        self._result_q = spawn.Queue()
        self._shms = [shared_memory.SharedMemory(create=True, size=shm_bytes)
                      for _ in range(depth + n_workers)]
        self._free = [s.name for s in self._shms]
        self._shm_by_name = {s.name: s for s in self._shms}
        self._workers = [
            spawn.Process(target=_worker_main,
                          args=(self._task_q, self._result_q, path_imgrec,
                                idx_path, cfg, seed + 101 * (i + 1),
                                self._lib),
                          daemon=True)
            for i in range(n_workers)]
        # a spawned child reads the environment at start: hide the card,
        # so no worker makes a CUDA context
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for p in self._workers:
                p.start()
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        self._closed = False

        self._seq_next = 0        # next sequence number to hand out
        self._seq_yield = 0       # next sequence number to yield
        self._pending = {}        # seq -> (shm_name, pad, err), done early
        self._epoch_batches: List = []
        self._dispatch_pos = 0
        self.reset()

    # -- epoch plan ---------------------------------------------------------
    def _plan_epoch(self):
        order = list(self._keys)
        if self._shuffle:
            self._rng.shuffle(order)
        batches = []
        bs = self.batch_size
        for start in range(0, len(order), bs):
            chunk = order[start:start + bs]
            pad = bs - len(chunk)
            if pad and not self._round_batch:
                break
            if pad:
                chunk = chunk + order[:pad]  # wrap-around fill, pad set
            batches.append((chunk, pad))
        self._epoch_batches = batches
        self._dispatch_pos = 0

    def _dispatch(self):
        while self._free and self._dispatch_pos < len(self._epoch_batches):
            keys, pad = self._epoch_batches[self._dispatch_pos]
            shm_name = self._free.pop()
            self._task_q.put((self._seq_next, shm_name, keys, pad))
            self._seq_next += 1
            self._dispatch_pos += 1

    # -- DataIter interface -------------------------------------------------
    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 \
            else (self.batch_size, self._label_width)
        return [DataDesc("softmax_label", shape)]

    def _get_result(self):
        """A worker's report; fails loudly when every worker has died."""
        import queue as _queue

        while True:
            try:
                seq, shm_name, pad, err, calls = self._result_q.get(
                    timeout=10)
            except _queue.Empty:
                if not any(p.is_alive() for p in self._workers):
                    raise MXNetError(
                        "image pipeline workers died (exitcodes %s); "
                        "note: multiprocessing 'spawn' requires a real "
                        "__main__ module (not stdin/interactive)"
                        % [p.exitcode for p in self._workers]) from None
                continue
            for k, v in calls.items():
                self.lib_calls[k] += v
            return seq, shm_name, pad, err

    def reset(self):
        # drain what is still in flight from the previous epoch
        while self._seq_yield < self._seq_next:
            if self._seq_yield in self._pending:
                shm_name = self._pending.pop(self._seq_yield)[0]
            else:
                seq, shm_name, pad, err = self._get_result()
                if seq != self._seq_yield:
                    self._pending[seq] = (shm_name, pad, err)
                    continue
            self._free.append(shm_name)
            self._seq_yield += 1
        self._plan_epoch()
        self._dispatch()

    def _to_context(self, flat: np.ndarray):
        """The batch's floats (data then labels) on the iterator's
        context: to the card in one copy of one pinned buffer."""
        if self._ctx.device_type != "gpu":
            return torch.from_numpy(flat.copy())
        pinned = torch.empty(flat.size, dtype=torch.float32, pin_memory=True)
        np.copyto(pinned.numpy(), flat)
        return pinned.to(self._ctx.torch_device(), non_blocking=True)

    def next(self):
        from .ndarray.ndarray import NDArray

        if self._seq_yield >= self._seq_next \
                and self._dispatch_pos >= len(self._epoch_batches):
            raise StopIteration
        want = self._seq_yield
        while want not in self._pending:
            seq, shm_name, pad, err = self._get_result()
            self._pending[seq] = (shm_name, pad, err)
        shm_name, pad, err = self._pending.pop(want)
        self._seq_yield += 1
        if err is not None:
            self._free.append(shm_name)
            self._dispatch()
            raise MXNetError("image pipeline worker failed: %s" % err)
        shm = self._shm_by_name[shm_name]
        n = self._img_floats + self.batch_size * self._label_width
        flat = self._to_context(np.ndarray((n,), np.float32, buffer=shm.buf))
        self._free.append(shm_name)
        self._dispatch()
        data = flat[:self._img_floats].view((self.batch_size,)
                                            + self.data_shape)
        label = flat[self._img_floats:].view(self.batch_size,
                                             self._label_width)
        if self._label_width == 1:
            label = label[:, 0]
        return DataBatch(data=[NDArray(data)], label=[NDArray(label)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    # -- teardown -----------------------------------------------------------
    def close(self):
        if self._closed:
            return
        self._closed = True
        for _ in self._workers:
            self._task_q.put(None)
        for p in self._workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for s in self._shms:
            try:
                s.close()
                s.unlink()
            except FileNotFoundError:
                pass

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
