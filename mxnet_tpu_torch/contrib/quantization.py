"""INT8 model quantization driver: the port of
``mxnet_tpu/contrib/quantization.py`` (reference
``python/mxnet/contrib/quantization.py`` and the graph pass
``src/operator/quantization/quantize_graph_pass.cc``).

``quantize_model`` rewrites a float Symbol so that every quantizable
layer (FullyConnected / Convolution) not excluded runs as int8 x int8 ->
int32 (``ops/quantization.py``: ``torch._int_mm`` on the card)::

    data -> quantize -> quantized_op -> requantize -> dequantize -> ...

Weights and biases are quantized OFFLINE into the returned arg dict
(their ranges embedded as constants); activations use in-graph dynamic
min/max (``calib_mode='none'``), ranges collected from calibration
batches (``'naive'``), or KL-divergence-optimal clipping thresholds
(``'entropy'``, the reference's algorithm: histogram the activations,
scan candidate thresholds, pick the one whose 255-bin quantized
distribution minimizes KL(P||Q) against the clipped reference
distribution). The rewritten symbol is the JAX package's node for node,
and the int8 params are its bits.

Kept deviation: ``ctx=None`` calibrates on the current context (the card
unless a ``with mx.cpu():`` scope says otherwise), where the JAX package
takes the CPU; the int8 params are made on that context too.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..base import MXNetError

__all__ = ["quantize_model"]

QUANTIZABLE = {"FullyConnected", "Convolution"}
INT8_RANGE = 127.0


def _quantize_params_int8(arr, ctx):
    """Offline symmetric int8 quantization of a weight/bias array; returns
    (int8 NDArray on ``ctx``, real_range)."""
    from .. import ndarray as nd_mod

    a = np.asarray(arr.asnumpy() if hasattr(arr, "asnumpy") else arr)
    r = float(max(abs(a.min()), abs(a.max()), 1e-30))
    q = np.clip(np.round(a * (INT8_RANGE / r)), -127, 127).astype(np.int8)
    return nd_mod.array(q, ctx=ctx, dtype="int8"), r


_MAX_CALIB_SAMPLES = 1 << 20  # per-tensor cap for the entropy histogram


def _smooth_distribution(p, eps=0.0001):
    """Spread eps mass onto zero bins so KL is defined (reference
    contrib/quantization.py:_smooth_distribution)."""
    is_zeros = (p == 0).astype(np.float32)
    is_nonzeros = (p != 0).astype(np.float32)
    n_zeros = is_zeros.sum()
    n_nonzeros = p.size - n_zeros
    if not n_nonzeros:
        raise MXNetError("all-zero calibration distribution")
    eps1 = eps * n_zeros / n_nonzeros
    hist = p.astype(np.float32)
    hist += eps * is_zeros + (-eps1) * is_nonzeros
    return hist


def _kl_divergence(p, q):
    p = p / p.sum()
    q = q / q.sum()
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))


def _get_optimal_threshold(arr, num_bins=8001, num_quantized_bins=255):
    """KL-optimal symmetric clipping threshold (reference
    contrib/quantization.py:244-317 _get_optimal_threshold): histogram the
    samples over (-th, th); for every candidate threshold, form the
    clipped reference distribution P (outliers folded into the edge bins)
    and its 255-bin quantization Q expanded back to P's support; minimize
    KL(P||Q). Returns (min_val, max_val, opt_min, opt_max)."""
    arr = np.asarray(arr)
    min_val = float(arr.min())
    max_val = float(arr.max())
    th = max(abs(min_val), abs(max_val), 1e-30)
    hist, _ = np.histogram(arr, bins=num_bins, range=(-th, th))
    zero_bin = num_bins // 2
    half_q = num_quantized_bins // 2

    best_div = np.inf
    best_th = th
    for i in range(half_q, zero_bin + 1):
        start, stop = zero_bin - i, zero_bin + i + 1
        sliced = hist[start:stop].astype(np.float64)
        p = sliced.copy()
        p[0] += hist[:start].sum()
        p[-1] += hist[stop:].sum()
        if p.sum() == 0:
            continue
        is_nonzero = (sliced != 0)
        # quantize the 2i+1 bins into num_quantized_bins (the last takes
        # the remainder), then expand back: each merged bin's mass spread
        # over its nonzero bins. The counts are integers, so these sums
        # are exact in any order: the JAX package's bin-by-bin loop's bits
        num_merged = sliced.size // num_quantized_bins
        starts = np.arange(num_quantized_bins) * num_merged
        lengths = np.diff(np.append(starts, sliced.size))
        sums = np.add.reduceat(sliced, starts)
        nz = np.add.reduceat(is_nonzero.astype(np.int64), starts)
        per = np.where(nz > 0, sums / np.maximum(nz, 1), 0.0)
        q = is_nonzero * np.repeat(per, lengths)
        p = _smooth_distribution(p)
        try:
            q = _smooth_distribution(q)
        except MXNetError:
            continue  # fully-zero candidate window
        div = _kl_divergence(p, q)
        if div < best_div:
            best_div = div
            best_th = (i + 0.5) * (2.0 * th / num_bins)
    return min_val, max_val, -best_th, best_th


def _collect_thresholds(sym, arg_params, aux_params, calib_data,
                        collect_names, num_calib_examples, ctx,
                        mode="naive"):
    """Run calibration batches through the FLOAT graph on ``ctx``.
    ``naive`` records min/max of every tensor in ``collect_names``
    (reference _LayerOutputCollector); ``entropy`` also keeps a capped
    sample of each tensor (reservoir sampling over the whole stream) and
    computes the KL-optimal threshold."""
    from .. import symbol as sym_mod

    internals = sym.get_internals()
    out_names = internals.list_outputs()
    wanted = [n for n in collect_names if n in out_names]
    group = sym_mod.Group([internals[n] for n in wanted])

    stats: Dict[str, List[float]] = {n: [np.inf, -np.inf] for n in wanted}
    samples: Dict[str, np.ndarray] = {
        n: np.empty(_MAX_CALIB_SAMPLES, np.float32) for n in wanted}
    counts: Dict[str, int] = {n: 0 for n in wanted}     # filled slots
    seen_elems: Dict[str, int] = {n: 0 for n in wanted}  # stream length
    rng = np.random.RandomState(0)
    seen = 0
    executors = {}  # one executor an input shape, params bound once
    calib_data.reset()
    for batch in calib_data:
        shape = tuple(batch.data[0].shape)
        ex = executors.get(shape)
        if ex is None:
            ex = group.simple_bind(ctx, grad_req="null", data=shape)
            ex.copy_params_from(
                {k: v for k, v in arg_params.items() if k in ex.arg_dict},
                {k: v for k, v in aux_params.items() if k in ex.aux_dict})
            executors[shape] = ex
        ex.copy_params_from({"data": batch.data[0]})
        outs = ex.forward(is_train=False)
        for name, o in zip(wanted, outs):
            a = o.asnumpy()
            stats[name][0] = min(stats[name][0], float(a.min()))
            stats[name][1] = max(stats[name][1], float(a.max()))
            if mode == "entropy":
                # every element of the stream has about cap/seen chance of
                # being in the histogram, so later batches keep counting
                # after the buffer fills
                flat = np.asarray(a.reshape(-1), np.float32)
                buf = samples[name]
                n = counts[name]
                room = _MAX_CALIB_SAMPLES - n
                if room > 0:
                    take = min(room, flat.size)
                    buf[n:n + take] = flat[:take]
                    counts[name] = n + take
                    rest = flat[take:]
                else:
                    rest = flat
                if rest.size:
                    total = seen_elems[name] + flat.size
                    n_repl = rng.binomial(
                        rest.size, _MAX_CALIB_SAMPLES / max(total, 1))
                    if n_repl:
                        n_repl = min(n_repl, rest.size)
                        slots = rng.randint(0, _MAX_CALIB_SAMPLES, n_repl)
                        vals = rest[rng.randint(0, rest.size, n_repl)]
                        buf[slots] = vals
                seen_elems[name] += flat.size
        seen += batch.data[0].shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    if mode != "entropy":
        return {n: (mn, mx) for n, (mn, mx) in stats.items()}
    out = {}
    for n in stats:
        arr = samples[n][:counts[n]] if counts[n] else np.zeros(1)
        _, _, opt_mn, opt_mx = _get_optimal_threshold(arr)
        out[n] = (opt_mn, opt_mx)
    return out


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   excluded_sym_names=None, calib_mode="none",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", ctx=None, logger=None):
    """Quantize a float model (reference contrib/quantization.py:
    quantize_model). Returns (quantized Symbol, quantized arg_params,
    aux_params). ``ctx=None`` is the current context."""
    from .. import symbol as sym_mod
    from ..context import current_context
    from ..symbol import Symbol, _invoke

    if quantized_dtype != "int8":
        raise MXNetError("only quantized_dtype='int8' is supported "
                         "(symmetric int8, as the JAX package)")
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXNetError("calib_mode=%r requires calib_data" % calib_mode)
    elif calib_mode != "none":
        raise MXNetError("unknown calib_mode %r" % calib_mode)
    excluded = set(excluded_sym_names or [])
    ctx = ctx or current_context()

    nodes = sym._topo_nodes()
    targets = [n for n in nodes
               if n.op in QUANTIZABLE and n.name not in excluded]

    thresholds = {}
    if calib_mode in ("naive", "entropy") and targets:
        collect = []
        for node in targets:
            src, _ = node.inputs[0]
            collect.append(src.name if src.is_var()
                           else "%s_output" % src.name)
            collect.append("%s_output" % node.name)
        thresholds = _collect_thresholds(
            sym, arg_params, aux_params, calib_data, set(collect),
            num_calib_examples, ctx, mode=calib_mode)

    qarg_params = dict(arg_params)
    new_syms: Dict[int, Symbol] = {}

    def mapped(entry):
        node, idx = entry
        s = new_syms[id(node)]
        return s[idx] if len(s._outputs) > 1 else s

    def const(value, name):
        return _invoke("_full", [], {"shape": (1,), "value": float(value)},
                       name=name)

    target_ids = {id(n) for n in targets}
    for node in nodes:
        if node.is_var():
            v = sym_mod.var(node.name)
            v._outputs[0][0]._extra_attrs.update(node._extra_attrs)
            new_syms[id(node)] = v
            continue
        ins = [mapped(e) for e in node.inputs]
        if id(node) not in target_ids:
            new_syms[id(node)] = _invoke(node.op, ins, dict(node.attrs),
                                         name=node.name)
            continue
        name = node.name
        data_s = ins[0]
        weight_name = node.inputs[1][0].name
        bias_name = node.inputs[2][0].name if len(node.inputs) > 2 else None

        # offline weight/bias quantization
        qw, w_r = _quantize_params_int8(arg_params[weight_name], ctx)
        qarg_params[weight_name] = qw
        w_min = const(-w_r, "%s_wmin" % name)
        w_max = const(w_r, "%s_wmax" % name)

        src, _ = node.inputs[0]
        in_key = src.name if src.is_var() else "%s_output" % src.name
        if in_key in thresholds:
            mn, mx = thresholds[in_key]
            d_min = const(mn, "%s_dmin" % name)
            d_max = const(mx, "%s_dmax" % name)
        else:  # dynamic: the range computed in the graph
            d_min = _invoke("min", [data_s], {}, name="%s_dmin" % name)
            d_max = _invoke("max", [data_s], {}, name="%s_dmax" % name)
        q = _invoke("_contrib_quantize", [data_s, d_min, d_max],
                    {"out_type": "int8"}, name="%s_qdata" % name)

        attrs = dict(node.attrs)
        q_ins = [q[0], sym_mod.var(weight_name)]
        if bias_name is not None and not attrs.get("no_bias"):
            qb, b_r = _quantize_params_int8(arg_params[bias_name], ctx)
            qarg_params[bias_name] = qb
            q_ins.append(sym_mod.var(bias_name))
            q_ins += [q[1], q[2], w_min, w_max,
                      const(-b_r, "%s_bmin" % name),
                      const(b_r, "%s_bmax" % name)]
        else:
            attrs["no_bias"] = True
            q_ins += [q[1], q[2], w_min, w_max]
        qop = "_contrib_quantized_fully_connected" \
            if node.op == "FullyConnected" else "_contrib_quantized_conv"
        acc = _invoke(qop, q_ins, attrs, name="%s_quantized" % name)

        rq_attrs = {}
        out_key = "%s_output" % name
        if out_key in thresholds:
            mn, mx = thresholds[out_key]
            rq_attrs = {"min_calib_range": mn, "max_calib_range": mx}
        rq = _invoke("_contrib_requantize", [acc[0], acc[1], acc[2]],
                     rq_attrs, name="%s_requantize" % name)
        new_syms[id(node)] = _invoke("_contrib_dequantize",
                                     [rq[0], rq[1], rq[2]], {},
                                     name="%s_dequantize" % name)

    outs = []
    for node, idx in sym._outputs:
        s = new_syms[id(node)]
        outs.append(s[idx] if len(s._outputs) > 1 else s)
    qsym = sym_mod.Group(outs) if len(outs) > 1 else outs[0]
    return qsym, qarg_params, dict(aux_params)
