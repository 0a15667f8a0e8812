"""Training callbacks, the port of ``mxnet_tpu/callback.py`` (reference
``python/mxnet/callback.py``: Speedometer :120, ProgressBar :180).

Contracts: epoch-end callbacks are called as ``cb(epoch, symbol,
arg_params, aux_params)``; batch-end callbacks receive a
``BatchEndParam``-style object with ``epoch``, ``nbatch``,
``eval_metric`` and ``locals`` attributes. The log lines are the JAX
package's, word for word. The checkpoint callbacks write at the end of
every ``period``-th epoch, numbered from 1: ``module_checkpoint`` through
``Module.save_checkpoint``, ``do_checkpoint`` through
``model.save_checkpoint``.
"""
from __future__ import annotations

import logging
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def _every(period):
    """Normalized positive period for the *-checkpoint factories."""
    return max(1, int(period))


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback checkpointing a Module (reference callback.py:27)."""
    n = _every(period)

    def _cb(epoch, sym=None, arg=None, aux=None):
        done = epoch + 1
        if done % n == 0:
            mod.save_checkpoint(prefix, done, save_optimizer_states)

    return _cb


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing ``prefix-symbol.json`` and
    ``prefix-NNNN.params`` (reference callback.py:55)."""
    from . import model

    n = _every(period)

    def _cb(epoch, sym, arg, aux):
        done = epoch + 1
        if done % n == 0:
            model.save_checkpoint(prefix, done, sym, arg, aux)

    return _cb


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every ``period``
    batches (reference callback.py:93)."""

    def _cb(param):
        metric = param.eval_metric
        if metric is None or param.nbatch % period != 0:
            return
        for name, value in metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            metric.reset()

    return _cb


class Speedometer:
    """Logs samples/sec (and the running metric) every ``frequent`` batches
    (reference callback.py:120).

    The state is one ``(batch_count, timestamp)`` mark taken at the
    previous report; throughput = batches since the mark x batch_size /
    elapsed, on a monotonic clock. A batch counter that goes backwards (a
    new epoch) re-arms the mark. The host clock reads when the batch was
    issued; on the card the metric's device-to-host copy makes each
    batch end only after its work is done.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._mark = None  # (nbatch, monotonic time) of the last report

    def __call__(self, param):
        count = param.nbatch
        if self._mark is None or count < self._mark[0]:
            self._mark = (count, time.monotonic())
            return
        if count % self.frequent != 0 or count == self._mark[0]:
            return
        elapsed = time.monotonic() - self._mark[1]
        done = (count - self._mark[0]) * self.batch_size
        speed = done / elapsed if elapsed > 0 else float("inf")
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            tail = "".join("\t%s=%f" % nv for nv in pairs)
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, count, speed, tail)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self._mark = (count, time.monotonic())


class ProgressBar:
    """Text progress bar over ``total`` batches (reference callback.py:180)."""

    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        frac = min(1.0, param.nbatch / float(self.total))
        fill = int(self.length * frac + 0.5)
        bar = "=" * fill + "-" * (self.length - fill)
        logging.info("[%s] %d%%\r", bar, int(frac * 100 + 0.999))


class LogValidationMetricsCallback:
    """Eval-end callback logging validation metrics (reference
    callback.py:210)."""

    def __call__(self, param):
        metric = param.eval_metric
        if metric is None:
            return
        for name, value in metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
