"""SSD object detection trained through the symbolic Module API: the port
of ``example/ssd/train_ssd.py``.

The same synthetic shapes dataset (colored rectangles with exact box
labels, written to a .rec), the same multi-loss symbol
(``contrib.MultiBoxPrior`` anchors over two feature maps,
``contrib.MultiBoxTarget`` matching with hard-negative mining,
``SoftmaxOutput`` and ``smooth_l1`` + ``MakeLoss`` losses, and the
``contrib.MultiBoxDetection`` monitoring head), the same
``ImageDetIter`` and ``Module`` loop and the same defaults (3 epochs,
batch 8, side 64, SGD lr 0.01, momentum 0.9, wd 5e-4). At side 64 the
detection head decodes and suppresses N = 3 x (32 x 32 + 16 x 16) = 3840
anchors per image on every forward pass, training ones included: on the
card through the hand-written CUDA NMS kernel (``ops/csrc/nms.cu``), on
the host through its plain PyTorch version.

``--device`` picks the context (the card by default, ``cpu`` for the
host). The dataset goes to ``--data-dir`` (a directory under the system's
temporary directory by default) unless ``--rec`` names one.

Run:  python -m mxnet_tpu_torch.example.ssd.train_ssd [--device cpu]
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as img_mod
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch import symbol as sym

NUM_CLASSES = 3  # foreground classes; class 0 in cls_prob is background


def make_dataset(path_prefix, n=64, side=64, seed=0):
    """``n`` images of 1-2 colored rectangles on gray, with their boxes,
    as ``<path_prefix>.rec`` / ``.idx`` (kept if the .rec exists)."""
    rec_path = path_prefix + ".rec"
    if os.path.isfile(rec_path):
        return rec_path
    rs = np.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(path_prefix + ".idx", rec_path, "w")
    colors = [(220, 40, 40), (40, 220, 40), (40, 40, 220)]
    for i in range(n):
        img = np.full((side, side, 3), 30, np.uint8)
        objs = []
        for _ in range(rs.randint(1, 3)):
            cls = rs.randint(0, NUM_CLASSES)
            bw = rs.randint(side // 5, side // 2)
            bh = rs.randint(side // 5, side // 2)
            x0 = rs.randint(0, side - bw)
            y0 = rs.randint(0, side - bh)
            img[y0:y0 + bh, x0:x0 + bw] = colors[cls]
            objs.append([cls, x0 / side, y0 / side,
                         (x0 + bw) / side, (y0 + bh) / side])
        flat = [2.0, 5.0]
        for o in objs:
            flat.extend(o)
        header = recordio.IRHeader(0, np.asarray(flat, np.float32), i, 0)
        w.write_idx(i, recordio.pack_img(header, img, img_fmt=".png"))
    w.close()
    return rec_path


# ---------------------------------------------------------------------------
# SSD symbol (reference symbol/symbol_builder.py:get_symbol_train)
# ---------------------------------------------------------------------------

def conv_act(data, name, num_filter, stride=(1, 1)):
    c = sym.Convolution(data, num_filter=num_filter, kernel=(3, 3),
                        stride=stride, pad=(1, 1), name=name)
    return sym.Activation(c, act_type="relu", name=name + "_relu")


def multi_layer_feature(data):
    """A small VGG-like body with two detection scales."""
    x = conv_act(data, "conv1", 16)
    x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="pool1")
    x = conv_act(x, "conv2", 32)
    scale1 = conv_act(x, "conv3", 32)                      # side/2
    scale2 = conv_act(scale1, "conv4", 64, stride=(2, 2))  # side/4
    return [scale1, scale2]


def multibox_layer(features, num_classes, sizes, ratios):
    """Per-scale class and box heads plus anchors (reference
    common.py:multibox_layer)."""
    cls_preds, loc_preds, anchors = [], [], []
    for i, feat in enumerate(features):
        num_anchors = len(sizes[i]) + len(ratios[i]) - 1
        cls = sym.Convolution(feat, num_filter=num_anchors * (num_classes + 1),
                              kernel=(3, 3), pad=(1, 1), name="cls_pred%d" % i)
        # (B, A*(C+1), H, W) -> (B, H, W, A*(C+1)) -> flat
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_preds.append(sym.Flatten(cls, name="cls_flat%d" % i))
        loc = sym.Convolution(feat, num_filter=num_anchors * 4, kernel=(3, 3),
                              pad=(1, 1), name="loc_pred%d" % i)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_preds.append(sym.Flatten(loc, name="loc_flat%d" % i))
        anchors.append(sym.Flatten(
            sym.contrib.MultiBoxPrior(feat, sizes=sizes[i], ratios=ratios[i],
                                      clip=True, name="anchors%d" % i),
            name="anchor_flat%d" % i))
    cls_concat = sym.Concat(*cls_preds, dim=1, num_args=len(cls_preds),
                            name="cls_concat")
    loc_concat = sym.Concat(*loc_preds, dim=1, num_args=len(loc_preds),
                            name="loc_concat")
    anc_concat = sym.Concat(*anchors, dim=1, num_args=len(anchors),
                            name="anchor_concat")
    # cls: (B, N, C+1) -> (B, C+1, N) for the multi_output SoftmaxOutput
    cls_concat = sym.Reshape(cls_concat, shape=(0, -1, NUM_CLASSES + 1),
                             name="cls_resh")
    cls_concat = sym.transpose(cls_concat, axes=(0, 2, 1), name="cls_tr")
    anc_concat = sym.Reshape(anc_concat, shape=(1, -1, 4), name="anchor_resh")
    return cls_concat, loc_concat, anc_concat


def get_symbol_train(num_classes):
    data = sym.var("data")
    label = sym.var("label")
    cls_preds, loc_preds, anchors = multibox_layer(
        multi_layer_feature(data), num_classes,
        sizes=[(0.25, 0.35), (0.45, 0.6)], ratios=[(1.0, 2.0), (1.0, 2.0)])
    tmp = sym.contrib.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3, name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]
    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 multi_output=True, normalization="valid",
                                 name="cls_prob")
    loc_diff = loc_preds - loc_target
    masked = loc_target_mask * sym.smooth_l1(loc_diff, scalar=1.0,
                                             name="loc_smooth_l1")
    loc_loss = sym.MakeLoss(masked, grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    # monitoring heads, gradient-blocked (reference symbol_builder.py:108)
    cls_label = sym.BlockGrad(cls_target, name="cls_label")
    det = sym.contrib.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                        nms_threshold=0.45, nms_topk=100,
                                        name="detection")
    det = sym.BlockGrad(det, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=os.path.join(
        tempfile.gettempdir(), "mxtpu_torch_ssd_data"))
    ap.add_argument("--rec", default=None, help="an existing detection .rec")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--side", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def batch_losses(outs):
    """(cls cross-entropy over the labelled anchors, mean |loc loss|) of
    one batch's outputs (the reference's MultiBoxMetric)."""
    p = outs[0].asnumpy()
    t = outs[2].asnumpy().astype(int)
    idx = np.where(t >= 0)
    ce = -np.log(np.maximum(p[idx[0], t[idx[0], idx[1]], idx[1]], 1e-12))
    return float(ce.mean()), float(np.abs(outs[1].asnumpy()).mean())


def run(args):
    """Train, then detect on one batch; returns the run's readings and
    the trained module."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    with ctx:
        mx.random.seed(0)  # deterministic weights, shuffling and flips
        rec = args.rec
        if rec is None:
            os.makedirs(args.data_dir, exist_ok=True)
            rec = make_dataset(os.path.join(args.data_dir, "shapes"),
                               side=args.side)
        it = img_mod.ImageDetIter(batch_size=args.batch_size,
                                  data_shape=(3, args.side, args.side),
                                  path_imgrec=rec, shuffle=True, mean=True,
                                  std=True, rand_mirror=True)
        net = get_symbol_train(NUM_CLASSES)
        mod = mx.module.Module(net, data_names=("data",),
                               label_names=("label",),
                               context=mx.current_context())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(mx.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": args.lr,
                                             "momentum": 0.9, "wd": 5e-4})
        epochs, steps, train_s = [], 0, 0.0
        for epoch in range(args.epochs):
            it.reset()
            tot_cls, tot_loc, nb = 0.0, 0.0, 0
            _sync(ctx)
            tic = time.perf_counter()
            for batch in it:
                mod.forward_backward(batch)
                mod.update()
                cls_l, loc_l = batch_losses(mod.get_outputs())
                tot_cls += cls_l
                tot_loc += loc_l
                nb += 1
            _sync(ctx)
            secs = time.perf_counter() - tic
            train_s += secs
            steps += nb
            epochs.append({"cls_loss": tot_cls / nb, "loc_loss": tot_loc / nb,
                           "img_per_s": nb * args.batch_size / secs})
            print("[epoch %d] cls_loss %.4f loc_loss %.4f (%.1f img/s)"
                  % (epoch, tot_cls / nb, tot_loc / nb,
                     nb * args.batch_size / secs), flush=True)

        # inference: decode + NMS on one batch
        it.reset()
        batch = next(iter(it))
        mod.forward(batch, is_train=False)
        det = mod.get_outputs()[3].asnumpy()
    kept = det[0][det[0, :, 0] >= 0]
    first = epochs[0]["cls_loss"] + epochs[0]["loc_loss"]
    last = epochs[-1]["cls_loss"] + epochs[-1]["loc_loss"]
    return {"epochs": epochs, "steps": steps, "train_s": train_s,
            "img_per_s": steps * args.batch_size / train_s,
            "first_loss": first, "last_loss": last,
            "improved": last < first, "det_shape": det.shape,
            "detections": int(len(kept)),
            "best_score": float(kept[:, 1].max()) if len(kept) else -1.0,
            "module": mod}


def main(argv=None):
    res = run(parse_args(argv))
    print("detections on image 0: %d boxes, best score %.3f"
          % (res["detections"], res["best_score"]))
    print("loss %.4f -> %.4f (%s)" % (res["first_loss"], res["last_loss"],
                                      "improved" if res["improved"]
                                      else "NOT improved"))
    return 0 if res["improved"] else 1


if __name__ == "__main__":
    sys.exit(main())
