#!/usr/bin/env python
"""Pack an image dataset into RecordIO (.rec/.idx): the port of
``tools/im2rec.py``, with the same arguments and files.

``.lst`` = ``idx\\tlabel[\\tlabel...]\\tpath``; ``.rec`` = RecordIO of
``recordio.pack_img`` records, readable by ``ImageIter``,
``ImageRecordIter`` and ``ImageRecordDataset``. Images are read and
written by the port's codecs (``image.imread``, ``image.imencode``: the
JPEG codec's host library on the card's context, its plain version with
``--device cpu``); ``--resize`` goes through ``image.imresize``.
``--num-thread`` packs on that many threads (the host library releases
the GIL) and writes the records in list order.

Modes:
  --list  : walk an image directory and write a .lst file
  (default): read a .lst file and write .rec + .idx

Examples:
  python -m mxnet_tpu_torch.tools.im2rec --list --recursive data/train data/images
  python -m mxnet_tpu_torch.tools.im2rec --resize 256 data/train data/images
"""
from __future__ import annotations

import argparse
import os
import random
import sys
import time

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def list_images(root, recursive, exts):
    """Yield (index, relative path, label), labels by sorted subfolder
    (reference im2rec.py list_image)."""
    i = 0
    if recursive:
        cat = {}
        for path, dirs, files in os.walk(root, followlinks=True):
            dirs.sort()
            files.sort()
            for fname in files:
                fpath = os.path.join(path, fname)
                suffix = os.path.splitext(fname)[1].lower()
                if os.path.isfile(fpath) and suffix in exts:
                    if path not in cat:
                        cat[path] = len(cat)
                    yield (i, os.path.relpath(fpath, root), cat[path])
                    i += 1
    else:
        for fname in sorted(os.listdir(root)):
            fpath = os.path.join(root, fname)
            suffix = os.path.splitext(fname)[1].lower()
            if os.path.isfile(fpath) and suffix in exts:
                yield (i, fname, 0)
                i += 1


def write_list(path_out, image_list):
    with open(path_out, "w") as fout:
        for idx, rel, label in image_list:
            fout.write("%d\t%f\t%s\n" % (idx, float(label), rel))


def read_list(path_in):
    """(idx, labels, relative path) of each line of a .lst file."""
    with open(path_in) as fin:
        for lineno, line in enumerate(fin):
            parts = line.strip().split("\t")
            if len(parts) < 3:
                print("lst line %d malformed: %r" % (lineno, line),
                      file=sys.stderr)
                continue
            idx = int(float(parts[0]))
            labels = [float(x) for x in parts[1:-1]]
            yield idx, labels, parts[-1]


def pack_one(args, idx, labels, rel_path):
    from mxnet_tpu_torch import image, recordio

    fullpath = os.path.join(args.root, rel_path)
    header = recordio.IRHeader(0, labels[0] if len(labels) == 1 else labels,
                               idx, 0)
    if args.pass_through:
        with open(fullpath, "rb") as fin:
            return recordio.pack(header, fin.read())
    img = image.imread(fullpath, flag=1 if args.color != 0 else 0,
                       to_numpy=True)
    if args.resize:
        h, w = img.shape[:2]
        if min(h, w) > args.resize:
            if h > w:
                img = image.imresize(img, args.resize,
                                     int(h * args.resize / w))
            else:
                img = image.imresize(img, int(w * args.resize / h),
                                     args.resize)
            img = img.asnumpy()
    if args.center_crop:
        h, w = img.shape[:2]
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        img = img[y0:y0 + s, x0:x0 + s]
    return recordio.pack_img(header, img, quality=args.quality,
                             img_fmt=args.encoding)


def make_rec(args, lst_path, ctx):
    from mxnet_tpu_torch import recordio

    prefix = os.path.splitext(lst_path)[0]
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    count = errors = 0
    tic = time.time()
    entries = list(read_list(lst_path))

    def job(entry):
        idx, labels, rel = entry
        try:
            with ctx:  # every thread packs with the context's codec
                return idx, pack_one(args, idx, labels, rel), None
        except Exception as exc:  # noqa: BLE001 - an unreadable image
            return idx, None, "skipping %s: %s" % (rel, exc)

    if args.num_thread > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=args.num_thread)
        results = pool.map(job, entries)
    else:
        pool = None
        results = map(job, entries)
    for idx, packed, err in results:
        if err is not None:
            errors += 1
            print(err, file=sys.stderr)
            continue
        rec.write_idx(idx, packed)
        count += 1
        if count % 1000 == 0:
            print("packed %d images (%.1f img/s)"
                  % (count, count / (time.time() - tic)))
    if pool is not None:
        pool.shutdown()
    rec.close()
    print("wrote %s.rec: %d records, %d errors" % (prefix, count, errors))
    return count


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("prefix", help=".lst/.rec path prefix (or a .lst "
                        "file)")
    parser.add_argument("root", help="image root directory")
    parser.add_argument("--list", action="store_true",
                        help="create a .lst instead of packing a .rec")
    parser.add_argument("--recursive", action="store_true",
                        help="walk subdirectories; each subdir is a class")
    parser.add_argument("--exts", nargs="+", default=list(IMG_EXTS))
    parser.add_argument("--chunks", type=int, default=1,
                        help="split the .lst into N chunks (train on "
                        "shards)")
    parser.add_argument("--train-ratio", type=float, default=1.0)
    parser.add_argument("--test-ratio", type=float, default=0.0)
    parser.add_argument("--shuffle", type=int, default=1)
    parser.add_argument("--pass-through", action="store_true",
                        help="pack raw file bytes without re-encoding")
    parser.add_argument("--resize", type=int, default=0,
                        help="resize the shorter edge to this many pixels")
    parser.add_argument("--center-crop", action="store_true")
    parser.add_argument("--quality", type=int, default=95)
    parser.add_argument("--encoding", default=".jpg",
                        choices=[".jpg", ".png"])
    parser.add_argument("--color", type=int, default=1, choices=[-1, 0, 1])
    parser.add_argument("--num-thread", type=int, default=1,
                        help="pack on this many threads")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                        help="the context whose JPEG codec packs: the card "
                        "(host library, default) or the host (plain)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.list:
        images = list(list_images(args.root, args.recursive,
                                  tuple(args.exts)))
        if args.shuffle:
            random.seed(100)
            random.shuffle(images)
            images = [(i, rel, lab) for i, (_, rel, lab) in
                      enumerate(images)]
        n_test = int(len(images) * args.test_ratio)
        n_train = int(len(images) * args.train_ratio)
        if args.test_ratio:
            write_list(args.prefix + "_test.lst", images[:n_test])
        if args.train_ratio < 1.0 or args.test_ratio:
            write_list(args.prefix + "_train.lst",
                       images[n_test:n_test + n_train])
        else:
            write_list(args.prefix + ".lst", images)
        print("listed %d images" % len(images))
        return 0

    lst = args.prefix if args.prefix.endswith(".lst") \
        else args.prefix + ".lst"
    if not os.path.isfile(lst):
        print("no such .lst file: %s (run with --list first)" % lst,
              file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx

    make_rec(args, lst, mx.gpu(0) if args.device == "gpu" else mx.cpu())
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))
    sys.exit(main())
