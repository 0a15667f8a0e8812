"""Neural-network ops: the part of ``mxnet_tpu/ops/nn.py`` the GPT, SSD
and ResNet training paths call, in PyTorch.

``FullyConnected`` (its product stays ``F.linear``: the JAX package leaves
it to XLA outside any kernel), ``LayerNorm`` (three outputs: the result,
the mean and the variance), ``Activation``, ``softmax`` and
``log_softmax``; for the SSD path ``Convolution`` and ``Pooling``
(channels-first; ``F.conv*d`` and ``F.*_pool*d``, where the JAX package
leaves them to XLA) and ``SoftmaxOutput``, a ``torch.autograd.Function``
with the reference's backward; for the ResNet path ``BatchNorm`` (three
outputs; the caller updates the moving statistics), ``Deconvolution``
(``F.conv_transpose*d``), ``LeakyReLU``, ``InstanceNorm`` and ``Dropout``, which draw from
the port's explicit ``torch.Generator`` (``random.generator``); for the
word language model the ``Sequence*`` ops, ``_rnn_param_concat`` and the
fused ``RNN`` op (cuDNN through ``torch._VF`` on the card, a step loop
of the JAX op's arithmetic on the CPU, picked by the tensor's device).
Train mode is ``autograd.is_training()``. The other ops of the JAX
module are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd, random as _random
from ..base import MXNetError, torch_dtype
from .registry import REQUIRED, register

__all__ = []


@register("FullyConnected",
          params={"num_hidden": (int, REQUIRED), "no_bias": (bool, False),
                  "flatten": (bool, True)},
          inputs=lambda attrs: ["data", "weight"] if attrs.get("no_bias")
          else ["data", "weight", "bias"])
def fully_connected(attrs, data, weight, *rest):
    """out = data @ weight.T + bias; weight is (num_hidden, in_units)."""
    if attrs.flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    bias = rest[0] if rest else None
    return F.linear(data, weight, bias)


@register("LayerNorm",
          params={"axis": (int, -1), "eps": (float, 1e-5),
                  "output_mean_var": (bool, False)},
          inputs=("data", "gamma", "beta"), num_outputs=3)
def layer_norm(attrs, data, gamma, beta):
    ax = attrs.axis % data.dim()
    mean = data.mean(dim=ax, keepdim=True)
    var = data.var(dim=ax, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + attrs.eps)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    out = (data - mean) * inv * gamma.reshape(bshape) + beta.reshape(bshape)
    return out, mean.squeeze(ax), var.squeeze(ax)


@register("InstanceNorm", params={"eps": (float, 1e-3)},
          inputs=("data", "gamma", "beta"))
def instance_norm(attrs, data, gamma, beta):
    """Each (sample, channel) normalised over its spatial axes with the
    biased variance, then ``* gamma + beta`` by channel
    (``mxnet_tpu/ops/nn.py:304-315``)."""
    red = tuple(range(2, data.dim()))
    var, mean = torch.var_mean(data, dim=red, unbiased=False, keepdim=True)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + attrs.eps) \
        * gamma.reshape(bshape) + beta.reshape(bshape)


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation", params={"act_type": (str, REQUIRED)})
def activation(attrs, data):
    try:
        return _ACTS[attrs.act_type](data)
    except KeyError:
        raise MXNetError("unknown act_type %r" % attrs.act_type)


@register("LeakyReLU",
          params={"act_type": (str, "leaky"), "slope": (float, 0.25),
                  "lower_bound": (float, 0.125),
                  "upper_bound": (float, 0.334)},
          inputs=lambda attrs: ["data", "gamma"]
          if attrs.get("act_type") == "prelu" else ["data"])
def leaky_relu(attrs, data, *rest):
    """leaky, elu, selu, gelu (exact), prelu (a learned slope per channel)
    and rrelu (a uniform random slope in train mode, the bounds' mean
    otherwise): ``mxnet_tpu/ops/nn.py:367``."""
    t = attrs.act_type
    if t == "leaky":
        return torch.where(data >= 0, data, attrs.slope * data)
    if t == "elu":
        return torch.where(data >= 0, data, attrs.slope * torch.expm1(data))
    if t == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= 0, data,
                                   alpha * torch.expm1(data))
    if t == "gelu":
        return F.gelu(data)
    if t == "prelu":
        gamma = rest[0]
        bshape = (1, -1) + (1,) * (data.dim() - 2) if data.dim() > 1 \
            else (-1,)
        return torch.where(data >= 0, data, gamma.reshape(bshape) * data)
    if t == "rrelu":
        lo, hi = attrs.lower_bound, attrs.upper_bound
        if autograd.is_training():
            slope = torch.rand(data.shape, dtype=data.dtype,
                               device=data.device,
                               generator=_random.generator(data.device))
            slope = slope * (hi - lo) + lo
        else:
            slope = (lo + hi) / 2.0
        return torch.where(data >= 0, data, slope * data)
    raise MXNetError("unknown LeakyReLU act_type %r" % t)


@register("Dropout",
          params={"p": (float, 0.5), "mode": (str, "training"),
                  "axes": (tuple, None), "cudnn_off": (bool, False)})
def dropout(attrs, data):
    """Inverted dropout: each value (each slice along ``axes``, which
    share one draw) kept with probability ``1 - p`` and scaled by
    ``1 / (1 - p)``; the identity at p = 0 and outside train mode unless
    ``mode='always'``. The mask comes from the port's ``torch.Generator``
    of the data's device, so its numbers differ from the JAX package's
    PRNG keys (``mxnet_tpu/ops/nn.py:646-661``)."""
    if attrs.p <= 0 or (not autograd.is_training()
                        and attrs.mode != "always"):
        return data
    if autograd.is_recomputing():
        raise MXNetError("Dropout under remat is not ported yet: its "
                         "recompute would draw another mask from the "
                         "port's generator")
    shape = data.shape
    if attrs.axes:
        axes = {a % data.dim() for a in attrs.axes}
        shape = tuple(1 if i in axes else s for i, s in enumerate(shape))
    keep = 1.0 - attrs.p
    draw = torch.rand(shape, device=data.device,
                      generator=_random.generator(data.device))
    return torch.where(draw < keep, data / keep, torch.zeros_like(data))


@register("BatchNorm",
          params={"eps": (float, 1e-3), "momentum": (float, 0.9),
                  "fix_gamma": (bool, True),
                  "use_global_stats": (bool, False),
                  "output_mean_var": (bool, False), "axis": (int, 1),
                  "cudnn_off": (bool, False)},
          inputs=("data", "gamma", "beta", "moving_mean", "moving_var"),
          num_outputs=3)
def batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    """``(out, mean, var)``, as ``mxnet_tpu/ops/nn.py:254-283``: in train
    mode (unless ``use_global_stats``) the batch's mean and *biased*
    variance over every axis but ``axis``, else the moving statistics;
    ``fix_gamma`` pins gamma to 1 (gamma then gets no gradient). The
    moving statistics are not written here: the caller (the gluon layer)
    updates them from the returned mean and variance, which is why this
    does not leave the update to ``F.batch_norm`` (that one would use the
    unbiased variance). The normalisation itself is ``torch.batch_norm``
    (cuDNN on the card) with the channel axis moved to 1."""
    ax = attrs.axis % data.dim()
    x = data if ax == 1 else data.movedim(ax, 1)
    # fix_gamma: a weight of ones, as the JAX op's ones_like(gamma) (cuDNN's
    # training backward fails on the card for a bias without a weight)
    weight = torch.ones_like(gamma) if attrs.fix_gamma else gamma
    if autograd.is_training() and not attrs.use_global_stats:
        red = tuple(i for i in range(data.dim()) if i != ax)
        var, mean = torch.var_mean(data, dim=red, unbiased=False)
        # torch.batch_norm, not F.batch_norm: the JAX op normalises a
        # single value a channel too (to beta), where F.batch_norm raises
        out = torch.batch_norm(x, weight, beta, None, None, True, 0.0,
                               attrs.eps, torch.backends.cudnn.enabled)
    else:
        mean, var = moving_mean, moving_var
        out = torch.batch_norm(x, weight, beta, moving_mean, moving_var,
                               False, 0.0, attrs.eps,
                               torch.backends.cudnn.enabled)
    if ax != 1:
        out = out.movedim(1, ax)
    return out, mean, var


_SOFTMAX_PARAMS = {"axis": (int, -1), "temperature": (float, None),
                   "dtype": ("dtype", None)}


def _softmax_impl(attrs, data, log):
    x = data
    if attrs.temperature is not None and attrs.temperature != 1.0:
        x = x / attrs.temperature
    out = (torch.log_softmax if log else torch.softmax)(x, dim=attrs.axis)
    if attrs.dtype is not None:
        out = out.to(torch_dtype(attrs.dtype))
    return out


@register("softmax", params=dict(_SOFTMAX_PARAMS))
def softmax(attrs, data):
    return _softmax_impl(attrs, data, log=False)


@register("log_softmax", params=dict(_SOFTMAX_PARAMS))
def log_softmax(attrs, data):
    return _softmax_impl(attrs, data, log=True)


# ---------------------------------------------------------------------------
# convolution and pooling (channels-first, as the SSD symbol uses them)
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _channels_first(layout, nd):
    if layout and not layout.startswith("NC"):
        raise MXNetError("layout %r is not ported yet (channels-first "
                         "only)" % (layout,))
    if nd not in _CONV:
        raise MXNetError("%d spatial dims: 1, 2 or 3 expected" % nd)


@register("Convolution",
          params={"kernel": (tuple, REQUIRED), "stride": (tuple, None),
                  "dilate": (tuple, None), "pad": (tuple, None),
                  "num_filter": (int, REQUIRED), "num_group": (int, 1),
                  "workspace": (int, 1024), "no_bias": (bool, False),
                  "cudnn_tune": (str, None), "cudnn_off": (bool, False),
                  "layout": (str, None)},
          inputs=lambda attrs: ["data", "weight"] if attrs.get("no_bias")
          else ["data", "weight", "bias"])
def convolution(attrs, data, weight, *rest):
    """N-d convolution, weight (num_filter, C / num_group, *kernel)."""
    nd = len(attrs.kernel)
    _channels_first(attrs.layout, nd)
    bias = rest[0] if rest else None
    return _CONV[nd](data, weight, bias, stride=attrs.stride or (1,) * nd,
                     padding=attrs.pad or (0,) * nd,
                     dilation=attrs.dilate or (1,) * nd,
                     groups=attrs.num_group)


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution",
          params={"kernel": (tuple, REQUIRED), "stride": (tuple, None),
                  "dilate": (tuple, None), "pad": (tuple, None),
                  "adj": (tuple, None), "target_shape": (tuple, None),
                  "num_filter": (int, REQUIRED), "num_group": (int, 1),
                  "workspace": (int, 512), "no_bias": (bool, True),
                  "cudnn_tune": (str, None), "cudnn_off": (bool, False),
                  "layout": (str, None)},
          inputs=lambda attrs: ["data", "weight"]
          if attrs.get("no_bias", True) else ["data", "weight", "bias"])
def deconvolution(attrs, data, weight, *rest):
    """Transposed convolution, weight (in_channels, num_filter /
    num_group, *kernel) as in the reference: the output side is
    ``(in - 1) * stride - 2 * pad + dilate * (kernel - 1) + adj + 1``, as
    the JAX package's input-dilated lowering gives (``mxnet_tpu/ops/
    nn.py:107``). ``target_shape`` is ignored there and here."""
    nd = len(attrs.kernel)
    _channels_first(attrs.layout, nd)
    bias = rest[0] if rest else None
    return _DECONV[nd](data, weight, bias, stride=attrs.stride or (1,) * nd,
                       padding=attrs.pad or (0,) * nd,
                       output_padding=attrs.adj or (0,) * nd,
                       groups=attrs.num_group,
                       dilation=attrs.dilate or (1,) * nd)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling",
          params={"kernel": (tuple, None), "pool_type": (str, "max"),
                  "global_pool": (bool, False), "cudnn_off": (bool, False),
                  "pooling_convention": (str, "valid"),
                  "stride": (tuple, None), "pad": (tuple, None),
                  "p_value": (int, 2), "count_include_pad": (bool, True),
                  "layout": (str, None)})
def pooling(attrs, data):
    """Max, average and sum pooling. The padding is applied here (-inf
    for max, 0 otherwise) and the pool runs unpadded, so the windows and
    divisors are the JAX ``reduce_window``'s: ``pooling_convention=
    'full'`` pads the high side up to a whole stride, and an average with
    ``count_include_pad`` divides by the kernel size."""
    nd = data.dim() - 2
    _channels_first(attrs.layout, nd)
    spatial = tuple(range(2, 2 + nd))
    if attrs.global_pool:
        if attrs.pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        if attrs.pool_type == "avg":
            return data.mean(dim=spatial, keepdim=True)
        if attrs.pool_type == "sum":
            return data.sum(dim=spatial, keepdim=True)
        raise MXNetError("global pool_type %r is not ported yet"
                         % attrs.pool_type)
    if attrs.pool_type not in ("max", "avg", "sum"):
        raise MXNetError("pool_type %r is not ported yet" % attrs.pool_type)
    kernel = tuple(attrs.kernel)
    stride = tuple(attrs.stride or (1,) * nd)
    pad = tuple(attrs.pad or (0,) * nd)
    widths = []  # F.pad order: last spatial dim first, (low, high)
    for i in reversed(range(nd)):
        hi = pad[i]
        if attrs.pooling_convention == "full":
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                hi += stride[i] - rem
        widths += [pad[i], hi]
    padded = any(widths)
    if attrs.pool_type == "max":
        x = F.pad(data, widths, value=-float("inf")) if padded else data
        return _MAX_POOL[nd](x, kernel, stride)
    x = F.pad(data, widths) if padded else data
    if attrs.pool_type == "avg" and attrs.count_include_pad:
        return _AVG_POOL[nd](x, kernel, stride)
    summed = _window_sum(x, kernel, stride)
    if attrs.pool_type == "sum":
        return summed
    ones = torch.ones_like(data[:1, :1])
    return summed / _window_sum(F.pad(ones, widths) if padded else ones,
                                kernel, stride)


def _window_sum(x, kernel, stride):
    if len(kernel) == 1:  # avg_pool1d has no divisor_override
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(-2)
    return _AVG_POOL[len(kernel)](x, kernel, stride, divisor_override=1)


# ---------------------------------------------------------------------------
# SoftmaxOutput
# ---------------------------------------------------------------------------


def _onehot(label, k, dim):
    """One-hot along ``dim`` with ``k`` classes; an out-of-range label
    (the ignore label -1) gives an all-zero row, as ``jax.nn.one_hot``."""
    lab = label.to(torch.int64).unsqueeze(dim)
    shape = [1] * lab.dim()
    shape[dim] = k
    classes = torch.arange(k, device=label.device).reshape(shape)
    return (lab == classes)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward ignores the incoming gradient and
    emits ``(prob - smoothed_onehot(label)) * grad_scale``, masked where
    the label is ``ignore_label`` and normalized: the JAX ``_so_bwd``
    (``mxnet_tpu/ops/nn.py:461-519``, reference softmax_output-inl.h)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        if attrs.multi_output:
            prob = torch.softmax(data, dim=1)
        elif attrs.preserve_shape:
            prob = torch.softmax(data, dim=-1)
        else:
            prob = torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
                .reshape(data.shape)
        ctx.save_for_backward(prob, label)
        ctx.attrs = attrs
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        a = ctx.attrs

        def smoothed(onehot, k):
            onehot = onehot.to(prob.dtype)
            if a.smooth_alpha > 0:
                return onehot * (1.0 - a.smooth_alpha) + \
                    (1.0 - onehot) * (a.smooth_alpha / (k - 1))
            return onehot

        ignore = (label != a.ignore_label).to(prob.dtype)
        if a.multi_output:
            k = prob.shape[1]
            grad = prob - smoothed(_onehot(label, k, 1), k)
            if a.use_ignore:
                grad = grad * ignore.unsqueeze(1)
        elif a.preserve_shape:
            k = prob.shape[-1]
            grad = prob - smoothed(_onehot(label, k, -1), k)
            if a.use_ignore:
                grad = grad * ignore[..., None]
        else:
            flat = prob.reshape(prob.shape[0], -1)
            k = flat.shape[-1]
            grad = (flat - smoothed(_onehot(label.reshape(-1), k, -1), k)) \
                .reshape(prob.shape)
            if a.use_ignore:
                grad = grad * ignore.reshape(
                    (-1,) + (1,) * (prob.dim() - 1))
        # a fill on the device, not a copy from the host: a captured
        # step (trainplane.module_plane) replays this backward
        scale = torch.full((), a.grad_scale, dtype=prob.dtype,
                           device=prob.device)
        if a.normalization == "batch":
            scale = scale / prob.shape[0]
        elif a.normalization == "valid" and a.use_ignore:
            scale = scale / torch.clamp_min(ignore.sum(), 1.0)
        return grad * scale, None, None


@register("SoftmaxOutput",
          params={"grad_scale": (float, 1.0), "ignore_label": (float, -1.0),
                  "multi_output": (bool, False), "use_ignore": (bool, False),
                  "preserve_shape": (bool, False),
                  "normalization": (str, "null"), "out_grad": (bool, False),
                  "smooth_alpha": (float, 0.0)},
          inputs=("data", "label"), aliases=("Softmax",))
def softmax_output(attrs, data, label):
    """Softmax with a built-in cross-entropy gradient; no gradient to the
    label."""
    return _SoftmaxOutput.apply(data, label.detach(), attrs)


# ---------------------------------------------------------------------------
# sequence ops (mxnet_tpu/ops/nn.py:695-755, reference sequence_*.cc)
# ---------------------------------------------------------------------------


def _seq_inputs(attrs):
    return ["data", "sequence_length"] if attrs.get("use_sequence_length") \
        else ["data"]


@register("SequenceMask",
          params={"use_sequence_length": (bool, False),
                  "value": (float, 0.0), "axis": (int, 0)},
          inputs=_seq_inputs)
def sequence_mask(attrs, data, *rest):
    """Steps at or past each sequence's length set to ``value``; time is
    ``axis`` 0 (T, N, ...) or 1 (N, T, ...)."""
    if not attrs.use_sequence_length:
        return data
    maxlen = data.shape[attrs.axis]
    steps = torch.arange(maxlen, device=data.device,
                         dtype=torch.float32).unsqueeze(1)
    mask = (steps < rest[0].to(torch.float32).unsqueeze(0)).to(data.dtype)
    if attrs.axis != 0:
        mask = mask.t()
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return data * mask + attrs.value * (1 - mask)


@register("SequenceLast",
          params={"use_sequence_length": (bool, False), "axis": (int, 0)},
          inputs=_seq_inputs)
def sequence_last(attrs, data, *rest):
    """Each sequence's last valid step (the last step without lengths; a
    length of 0 takes the last step, as the JAX op's index -1 does)."""
    ax = attrs.axis
    if not attrs.use_sequence_length:
        return data.select(ax, data.shape[ax] - 1)
    last = rest[0].to(torch.int64) - 1
    batch = torch.arange(last.shape[0], device=data.device)
    return data[last, batch] if ax == 0 else data[batch, last]


@register("SequenceReverse",
          params={"use_sequence_length": (bool, False), "axis": (int, 0)},
          inputs=_seq_inputs)
def sequence_reverse(attrs, data, *rest):
    """Each sequence's first ``length`` steps reversed along axis 0, the
    rest in place; the whole axis 0 flipped without lengths (the JAX op
    reverses axis 0 whatever ``axis`` says)."""
    if not attrs.use_sequence_length:
        return torch.flip(data, (0,))
    lens = rest[0].to(torch.int64).unsqueeze(0)
    idx = torch.arange(data.shape[0], device=data.device).unsqueeze(1)
    rev = torch.where(idx < lens, lens - 1 - idx, idx)
    rev = rev.reshape(tuple(rev.shape) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, rev.expand(data.shape))


# ---------------------------------------------------------------------------
# the fused RNN op (mxnet_tpu/ops/nn.py:808-935, reference rnn-inl.h,
# cudnn_rnn-inl.h)
# ---------------------------------------------------------------------------

_NGATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


def rnn_param_size(mode, input_size, state_size, num_layers,
                   bidirectional=False):
    """The packed parameter count (reference rnn-inl.h GetParamSize)."""
    ng, d, h = _NGATES[mode], 2 if bidirectional else 1, state_size
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else h * d
        size += d * (ng * h * in_size + ng * h * h)
    return size + num_layers * d * 2 * ng * h


def _unpack_rnn(mode, params, input_size, h, num_layers, d):
    """Views of the flat vector in MXNet's (and cuDNN's) packing: every
    layer's and direction's (i2h, h2h) weights, layer-major and
    direction-minor, then all the (i2h, h2h) biases in the same order.
    Returns ``[layer][direction] = (wx, wh, bx, bh)``."""
    ng = _NGATES[mode]
    off = 0

    def take(*shape):
        nonlocal off
        n = 1
        for s in shape:
            n *= s
        out = params[off:off + n].view(shape)
        off += n
        return out

    weights = [[(take(ng * h, input_size if layer == 0 else h * d),
                 take(ng * h, h)) for _ in range(d)]
               for layer in range(num_layers)]
    biases = [[(take(ng * h), take(ng * h)) for _ in range(d)]
              for _ in range(num_layers)]
    if off != params.numel():
        raise MXNetError("RNN: %d parameters given, %d expected"
                         % (params.numel(), off))
    return [[weights[layer][k] + biases[layer][k] for k in range(d)]
            for layer in range(num_layers)]


def _rnn_dropout(x, p):
    """Inverted dropout between layers, its mask from the port's
    generator of the device (the JAX op's ``bernoulli(keep)``)."""
    keep = 1.0 - p
    draw = torch.rand(x.shape, device=x.device,
                      generator=_random.generator(x.device))
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def _rnn_steps(mode, xs, h, c, wx, wh, bx, bh):
    """One direction of one layer, step by step, as the JAX op's
    ``_rnn_layer_scan`` (``mxnet_tpu/ops/nn.py:779-805``): the input
    projection for every step at once, then one h2h product a step.
    LSTM gates i, f, g, o; GRU gates r, z, n with
    ``n = tanh(x_n + r * (W_hn h + b_hn))``."""
    proj = F.linear(xs, wx, bx)
    ys = []
    for t in range(xs.shape[0]):
        hp = F.linear(h, wh, bh)
        if mode == "lstm":
            i, f, g, o = (proj[t] + hp).chunk(4, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            rx, zx, nx = proj[t].chunk(3, -1)
            rh, zh, nh = hp.chunk(3, -1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + r * nh)
            h = (1 - z) * n + z * h
        elif mode == "rnn_tanh":
            h = torch.tanh(proj[t] + hp)
        else:
            h = torch.relu(proj[t] + hp)
        ys.append(h)
    return torch.stack(ys), h, c


def _rnn_plain(mode, data, packs, state, state_cell, d, p, train):
    x = data
    h_out, c_out = [], []
    for layer, pack in enumerate(packs):
        outs = []
        for k in range(d):
            wx, wh, bx, bh = pack[k]
            h0 = state[layer * d + k]
            c0 = state_cell[layer * d + k] if state_cell is not None \
                else torch.zeros_like(h0)
            xs = torch.flip(x, (0,)) if k == 1 else x
            ys, ht, ct = _rnn_steps(mode, xs, h0, c0, wx, wh, bx, bh)
            outs.append(torch.flip(ys, (0,)) if k == 1 else ys)
            h_out.append(ht)
            c_out.append(ct)
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if p > 0 and train and layer < len(packs) - 1:
            x = _rnn_dropout(x, p)
    return x, torch.stack(h_out), torch.stack(c_out)


def _rnn_cudnn(mode, data, packs, state, state_cell, d, p, train):
    """cuDNN's fused RNN through ``torch._VF`` (what ``nn.LSTM.forward``
    calls), the weights handed over as views of the flat vector: cuDNN
    copies them into one buffer at each call. Its own dropout would draw
    from torch's global generator, so with dropout in training the layers
    run one call each, the port's mask between them."""
    fn = getattr(torch._VF, mode)
    # cuDNN keeps what its backward needs only in training mode
    need_grad = torch.is_grad_enabled()

    def run(x, group, first):
        flat = [w for pack in group for ws in pack for w in ws]
        n = len(group) * d
        h0 = state[first * d:first * d + n]
        if mode == "lstm":
            return fn(x, (h0, state_cell[first * d:first * d + n]), flat,
                      True, len(group), 0.0, need_grad, d == 2, False)
        y, ht = fn(x, h0, flat, True, len(group), 0.0, need_grad, d == 2,
                   False)
        return y, ht, None

    if not (p > 0 and train and len(packs) > 1):
        return run(data, packs, 0)
    x, hs, cs = data, [], []
    for layer in range(len(packs)):
        x, ht, ct = run(x, packs[layer:layer + 1], layer)
        hs.append(ht)
        cs.append(ct)
        if layer < len(packs) - 1:
            x = _rnn_dropout(x, p)
    return x, torch.cat(hs), (torch.cat(cs) if mode == "lstm" else None)


def rnn_forward(mode, data, params, state, state_cell, num_layers,
                state_size, bidirectional=False, p_dropout=0.0, train=False,
                impl=None):
    """The fused multi-layer RNN: data (T, N, C), state (L * D, N, H),
    the flat ``params`` in MXNet's packing; returns (out, hT, cT), cT
    None unless ``mode`` is ``lstm``. ``impl`` is ``'cudnn'`` (a CUDA
    tensor's default) or ``'plain'`` (the CPU's; the step loop of the
    JAX op's arithmetic)."""
    d = 2 if bidirectional else 1
    packs = _unpack_rnn(mode, params, data.shape[2], state_size,
                        num_layers, d)
    if impl is None:
        impl = "cudnn" if data.is_cuda else "plain"
    run = {"cudnn": _rnn_cudnn, "plain": _rnn_plain}[impl]
    out, ht, ct = run(mode, data, packs, state,
                      state_cell if mode == "lstm" else None, d, p_dropout,
                      train)
    return out, ht, (ct if mode == "lstm" else None)


@register("RNN",
          params={"state_size": (int, REQUIRED),
                  "num_layers": (int, REQUIRED),
                  "bidirectional": (bool, False), "mode": (str, REQUIRED),
                  "p": (float, 0.0), "state_outputs": (bool, False),
                  "projection_size": (int, None),
                  "lstm_state_clip_min": (float, None),
                  "lstm_state_clip_max": (float, None),
                  "lstm_state_clip_nan": (bool, False)},
          inputs=lambda attrs: ["data", "parameters", "state",
                                "state_cell"]
          if attrs.get("mode") == "lstm"
          else ["data", "parameters", "state"],
          num_outputs=lambda attrs: (3 if attrs.get("mode") == "lstm"
                                     else 2)
          if attrs.get("state_outputs") else 1)
def rnn(attrs, data, parameters, state, *rest):
    """``lstm``, ``gru``, ``rnn_tanh`` or ``rnn_relu``, multi-layer and
    optionally bidirectional; dropout ``p`` between layers in train mode.
    On the card cuDNN runs it; on the CPU the step loop."""
    if attrs.mode not in _NGATES:
        raise MXNetError("RNN: unknown mode %r" % attrs.mode)
    out, ht, ct = rnn_forward(
        attrs.mode, data, parameters, state, rest[0] if rest else None,
        attrs.num_layers, attrs.state_size,
        bidirectional=attrs.bidirectional, p_dropout=attrs.p,
        train=autograd.is_training())
    if not attrs.state_outputs:
        return out
    return (out, ht, ct) if attrs.mode == "lstm" else (out, ht)


@register("_rnn_param_concat",
          params={"num_args": (int, 1), "dim": (int, 0)},
          inputs=lambda attrs: ["arg%d" % i
                                for i in range(attrs.get("num_args", 1))])
def rnn_param_concat(attrs, *xs):
    """Every array flattened and joined: the RNN op's flat vector (the
    gradient reaches each piece)."""
    return torch.cat([x.reshape(-1) for x in xs])
