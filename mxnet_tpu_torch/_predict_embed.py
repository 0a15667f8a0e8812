"""Python half of the C predict API, ported from
``mxnet_tpu/_predict_embed.py``.

The reference's ``c_predict_api.h`` exposes inference (load symbol JSON +
params, bind, set input, forward, read output) as a flat C ABI consumed by
the C++/Matlab/mobile frontends. A C frontend embeds a CPython interpreter
and drives these functions; data crosses the boundary as raw float32
buffers. ``dev_type == 2`` binds on the card (``mx.gpu()``), any other
value on the CPU.

:func:`forward_batch` is the batched entry: N samples go through a
per-handle :class:`~mxnet_tpu_torch.serving.Server` whose engine keeps one
reshaped executor a batch bucket.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple

import numpy as np

_HANDLES: Dict[int, "_Predictor"] = {}
_NEXT = [1]


class _Predictor:
    def __init__(self, symbol_json: str, param_bytes: bytes,
                 dev_type: int, input_shapes: Dict[str, Tuple[int, ...]]):
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import symbol as sym_mod
        from mxnet_tpu_torch.ndarray import io_utils

        self.mx = mx
        sym = sym_mod.load_json(symbol_json)
        self.ctx = ctx = mx.gpu() if dev_type == 2 else mx.cpu()
        params = {}
        if param_bytes:
            import os
            import tempfile

            fd, tmp = tempfile.mkstemp(suffix=".params")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(param_bytes)
                loaded = io_utils.load(tmp, ctx=ctx)
            finally:
                os.remove(tmp)
            for k, v in loaded.items():
                name = k.split(":", 1)[-1]  # strip arg:/aux: prefixes
                params[name] = v
        arg_names = sym.list_arguments()
        aux_names = sym.list_auxiliary_states()
        shapes = dict(input_shapes)
        for name in arg_names:
            if name in params and name not in shapes:
                shapes[name] = params[name].shape
        self.executor = sym.simple_bind(ctx, grad_req="null", **shapes)
        self.executor.copy_params_from(
            {k: v for k, v in params.items() if k in arg_names},
            {k: v for k, v in params.items() if k in aux_names},
            allow_extra_params=True)
        self.input_names = list(input_shapes)
        self.input_shapes = input_shapes
        self.inputs: Dict[str, np.ndarray] = {}
        self.outputs: List[np.ndarray] = []
        self._server = None  # lazy serving.Server (see server())
        self._server_lock = threading.Lock()
        self._freed = False

    def set_input(self, key: str, buf: bytes):
        shape = self.input_shapes[key]
        arr = np.frombuffer(buf, dtype=np.float32).reshape(shape)
        self.inputs[key] = arr

    def forward(self):
        from mxnet_tpu_torch.base import fetch_host

        feed = {k: self.mx.nd.array(v, ctx=self.ctx)
                for k, v in self.inputs.items()}
        outs = self.executor.forward(is_train=False, **feed)
        # one batched device->host copy for every output
        self.outputs = [o.astype(np.float32, copy=False)
                        for o in fetch_host([o._data for o in outs])]

    def reshape(self, new_shapes: Dict[str, Tuple[int, ...]]):
        self.input_shapes.update(new_shapes)
        self.executor = self.executor.reshape(**new_shapes)
        with self._server_lock:
            server, self._server = self._server, None
        if server is not None:
            # the server's sample shape and per-bucket executors are frozen
            # at build time; a rebind invalidates both (bounded join: a
            # wedged device must not hang the frontend)
            server.close(timeout=60.0)

    # -- dynamic-batching serve (mxnet_tpu_torch.serving) --------------
    def server(self, **kwargs):
        """Lazily build the dynamic-batching server over this predictor.

        Single-input predictors only (the predict ABI's common case). The
        per-request sample shape is the bound input shape minus its batch
        axis; each bucket gets one reshaped executor, made on first use
        (warm after ``Server.warmup()``)."""
        with self._server_lock:
            if self._freed:
                raise ValueError("predictor handle already freed")
            if self._server is None:
                from mxnet_tpu_torch import serving

                if len(self.input_names) != 1:
                    raise ValueError("batched predict serves single-input "
                                     "models; got inputs %r"
                                     % self.input_names)
                key = self.input_names[0]
                sample_shape = tuple(self.input_shapes[key][1:])
                # the ABI caller blocks synchronously on every result, and
                # the first call per bucket pays its setup: no per-request
                # timeout unless asked
                kwargs.setdefault("timeout_ms", 0)
                self._server = serving.Server(
                    _ExecutorEngine(self, key), sample_shape,
                    name="predict", **kwargs)
            return self._server


class _ExecutorEngine:
    """``serving.Engine`` over a bound executor: one reshaped executor per
    batch bucket (``Executor.reshape``), made on first use."""

    def __init__(self, predictor: "_Predictor", key: str):
        self._pred = predictor
        self._key = key
        self._executors: Dict[int, Any] = {}

    def run(self, batch: np.ndarray):
        from mxnet_tpu_torch.base import fetch_host

        ex = self._executors.get(batch.shape[0])
        if ex is None:
            ex = self._pred.executor.reshape(**{self._key: batch.shape})
            self._executors[batch.shape[0]] = ex
        # the batcher's thread has no context scope: name the device
        data = self._pred.mx.nd.array(batch, ctx=self._pred.ctx)
        outs = ex.forward(is_train=False, **{self._key: data})
        host = [o.astype(np.float32, copy=False)
                for o in fetch_host([o._data for o in outs])]
        return tuple(host) if len(host) > 1 else host[0]

    @property
    def compile_count(self) -> int:
        return len(self._executors)


def create(symbol_json: str, param_bytes: bytes, dev_type: int,
           input_names: List[str], input_shapes: List[List[int]]) -> int:
    h = _NEXT[0]
    _NEXT[0] += 1
    _HANDLES[h] = _Predictor(symbol_json, param_bytes, dev_type,
                             {n: tuple(s) for n, s in
                              zip(input_names, input_shapes)})
    return h


def set_input(handle: int, key: str, buf: bytes) -> None:
    _HANDLES[handle].set_input(key, buf)


def forward(handle: int) -> None:
    _HANDLES[handle].forward()


def num_outputs(handle: int) -> int:
    return len(_HANDLES[handle].executor.outputs)


def get_output_shape(handle: int, index: int) -> List[int]:
    p = _HANDLES[handle]
    if p.outputs:
        return list(p.outputs[index].shape)
    return list(p.executor.outputs[index].shape)


def get_output(handle: int, index: int) -> bytes:
    return _HANDLES[handle].outputs[index].tobytes()


def forward_batch(handle: int, bufs: List[bytes],
                  output_index: int = 0) -> List[bytes]:
    """Batched predict: N raw float32 sample buffers in, N raw float32
    output buffers out — one padded fixed-bucket execution per
    micro-batch (via :mod:`mxnet_tpu_torch.serving`) instead of N
    sequential ``set_input``/``forward`` round trips. Each buffer holds
    one sample shaped like the bound input minus its batch axis.

    Load shedding is an *external-overload* policy; this caller owns its
    whole batch, so a full queue applies backpressure instead: wait for
    the oldest in-flight result, then resubmit. ``N`` may exceed the
    server queue depth.
    """
    import collections
    import time

    from mxnet_tpu_torch import serving

    p = _HANDLES[handle]
    server = p.server()
    shape = tuple(p.input_shapes[p.input_names[0]][1:])

    def to_bytes(res):
        if isinstance(res, tuple):
            res = res[output_index]
        return np.ascontiguousarray(res).tobytes()

    outs: List[bytes] = [b""] * len(bufs)
    pending = collections.deque()
    for i, buf in enumerate(bufs):
        arr = np.frombuffer(buf, dtype=np.float32).reshape(shape)
        while True:
            try:
                pending.append((i, server.submit(arr)))
                break
            except serving.QueueFullError:
                if pending:  # drain our oldest in-flight request
                    j, fut = pending.popleft()
                    outs[j] = to_bytes(fut.result())
                else:  # queue filled by other threads: yield and retry
                    time.sleep(0.001)
    for j, fut in pending:
        outs[j] = to_bytes(fut.result())
    return outs


def free(handle: int) -> None:
    p = _HANDLES.pop(handle, None)
    if p is None:
        return
    with p._server_lock:  # a racing server() either finished or refuses now
        p._freed = True
        server, p._server = p._server, None
    if server is not None:
        # bounded: free() is driven from the C ABI and must not hang the
        # frontend if a wedged device has the batcher stuck mid-batch
        server.close(timeout=60.0)
