"""The Module-API training harness of the image-classification examples:
the port of ``example/image-classification/common/fit.py`` (reference
``common/fit.py:148``), with the same arguments and defaults.

:func:`fit` makes the kvstore, the iterators, the learning-rate
schedule, the ``Module`` on the current context, the ``Monitor``, the
``Speedometer`` and the checkpoint callback, then calls ``Module.fit``
with the store object, so the store's updater applies the optimizer
(``update_on_kvstore``). The caller picks the context (``with mx.cpu():``
or the card, the default). ``--devices`` above 1 and ``--kv-store
tpu``/``dist*`` are not ported yet and raise.
"""
import logging
import os
import time

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError


def add_fit_args(parser):
    """The common training flags (reference common/fit.py:add_fit_args)."""
    train = parser.add_argument_group("Training", "model training")
    train.add_argument("--network", type=str, help="the neural network to use")
    train.add_argument("--num-layers", type=int,
                       help="number of layers in the neural network")
    train.add_argument("--devices", type=int, default=1,
                       help="number of devices to data-parallel over "
                            "(reference --gpus)")
    train.add_argument("--kv-store", type=str, default="local",
                       help="key-value store type: local|device")
    train.add_argument("--num-epochs", type=int, default=2,
                       help="max num of epochs")
    train.add_argument("--lr", type=float, default=0.05, help="learning rate")
    train.add_argument("--lr-factor", type=float, default=0.1,
                       help="lr reduction ratio at each step")
    train.add_argument("--lr-step-epochs", type=str, default="10",
                       help="epochs at which lr reduces, e.g. '30,60'")
    train.add_argument("--optimizer", type=str, default="sgd")
    train.add_argument("--mom", type=float, default=0.9, help="sgd momentum")
    train.add_argument("--wd", type=float, default=1e-4, help="weight decay")
    train.add_argument("--batch-size", type=int, default=64)
    train.add_argument("--disp-batches", type=int, default=100,
                       help="show progress every n batches")
    train.add_argument("--model-prefix", type=str, help="checkpoint prefix")
    train.add_argument("--save-period", type=int, default=1)
    train.add_argument("--load-epoch", type=int,
                       help="resume from this checkpoint epoch")
    train.add_argument("--monitor", type=int, default=0,
                       help="log network stats every N iters if > 0")
    train.add_argument("--top-k", type=int, default=0,
                       help="also report top-k accuracy when > 0")
    train.add_argument("--gc-type", type=str, default="none",
                       help="gradient compression: 2bit|none")
    train.add_argument("--gc-threshold", type=float, default=0.5)
    train.add_argument("--test-io", type=int, default=0,
                       help="1 = measure data reading speed only")
    return train


def _contexts(args):
    """The current context; several devices are not ported yet."""
    if args.devices > 1:
        raise MXNetError("--devices %d is not ported yet: the port trains "
                         "on one device" % args.devices)
    return [mx.current_context()]


def fit(args, network, data_loader, **kwargs):
    """Train ``network`` (a Symbol) on the iterators from ``data_loader``
    (reference common/fit.py:148); returns the Module."""
    kv = mx.kvstore.create(args.kv_store)
    if args.gc_type != "none":
        kv.set_gradient_compression({"type": args.gc_type,
                                     "threshold": args.gc_threshold})

    head = "%(asctime)-15s Node[" + str(kv.rank) + "] %(message)s"
    logging.basicConfig(level=logging.INFO, format=head)
    logging.info("start with arguments %s", args)

    train, val = data_loader(args, kv)

    if args.test_io:
        tic = time.time()
        for i, batch in enumerate(train):
            for j in batch.data:
                j.wait_to_read()
            if (i + 1) % args.disp_batches == 0:
                logging.info("Batch [%d]\tSpeed: %.2f samples/sec", i,
                             args.disp_batches * args.batch_size
                             / (time.time() - tic))
                tic = time.time()
        return None

    # load / checkpoint
    model_prefix = args.model_prefix
    sym, arg_params, aux_params = network, None, None
    if model_prefix and args.load_epoch:
        sym, arg_params, aux_params = mx.load_checkpoint(
            model_prefix, args.load_epoch)
    checkpoint = None
    if model_prefix is not None:
        os.makedirs(os.path.dirname(model_prefix) or ".", exist_ok=True)
        checkpoint = mx.callback.do_checkpoint(
            model_prefix if kv.rank == 0 else "%s-%d" % (model_prefix, kv.rank),
            args.save_period)

    # lr schedule (reference _get_lr_scheduler)
    step_epochs = [int(x) for x in args.lr_step_epochs.split(",") if x]
    epoch_size = max(1, getattr(train, "num_batches", 0) or
                     (60000 // args.batch_size)) // max(kv.num_workers, 1)
    lr = args.lr
    for s in step_epochs:
        if (args.load_epoch or 0) >= s:
            lr *= args.lr_factor
    steps = [epoch_size * (x - (args.load_epoch or 0)) for x in step_epochs
             if x - (args.load_epoch or 0) > 0]
    lr_scheduler = mx.lr_scheduler.MultiFactorScheduler(
        step=steps, factor=args.lr_factor) if steps else None

    optimizer_params = {"learning_rate": lr, "wd": args.wd,
                        "lr_scheduler": lr_scheduler}
    if args.optimizer in ("sgd", "nag", "signum"):
        optimizer_params["momentum"] = args.mom

    mod = mx.mod.Module(symbol=sym, context=_contexts(args))

    monitor = mx.monitor.Monitor(args.monitor, pattern=".*") \
        if args.monitor > 0 else None
    batch_end_callbacks = [mx.callback.Speedometer(
        args.batch_size, args.disp_batches)]

    eval_metrics = ["accuracy"]
    if args.top_k > 0:
        eval_metrics.append(mx.metric.create(
            "top_k_accuracy", top_k=args.top_k))

    mod.fit(train,
            begin_epoch=args.load_epoch or 0,
            num_epoch=args.num_epochs,
            eval_data=val,
            eval_metric=eval_metrics,
            kvstore=kv,
            optimizer=args.optimizer,
            optimizer_params=optimizer_params,
            initializer=mx.initializer.Xavier(
                rnd_type="gaussian", factor_type="in", magnitude=2),
            arg_params=arg_params,
            aux_params=aux_params,
            batch_end_callback=batch_end_callbacks,
            epoch_end_callback=checkpoint,
            allow_missing=True,
            monitor=monitor)
    return mod
