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
Slice 18 adds the rest of the JAX module: ``softmin``,
``SoftmaxActivation``, ``softmax_cross_entropy``, ``L2Normalization``,
``LRN``, ``UpSampling``, the output ops (``LinearRegressionOutput``,
``LogisticRegressionOutput``, ``MAERegressionOutput``, ``SVMOutput``:
each a ``torch.autograd.Function`` whose backward ignores the head
gradient, as the JAX ``custom_vjp``), ``CTCLoss`` (the JAX op's log-space
alpha recursion over the ``(B, 2L + 1)`` lattice, not ``F.ctc_loss``,
whose results and gradients differ on infeasible labels and whose CUDA
backward has no deterministic form), ``Pooling(pool_type='lp')``, the
channels-last layouts (NWC, NHWC, NDHWC) of ``Convolution``,
``Deconvolution`` and ``Pooling`` (the weight stays OIHW, as in the JAX
package), and the legacy aliases (``SyncBatchNorm``, the ``*_v1`` ops).
Train mode is ``autograd.is_training()``.

Inside a step that spans two or more ranks (``_dist.current_span()``),
``BatchNorm`` in train mode normalises with the global batch's
statistics, as the JAX op does over a batch axis sharded across devices
(``mxnet_tpu/ops/vision.py:719-726``): :class:`_GlobalBatchNorm`, plain
torch ops around two all-reduces (see there). Over one rank the global
batch is the rank's own, and the op keeps its local path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _dist, autograd, random as _random
from ..base import MXNetError, torch_dtype
from .registry import OP_REGISTRY, REQUIRED, register

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


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation over the batch of every rank of a
    span (``x`` channels-first): ``(out, mean, var)``, the statistics
    the global batch's per-channel mean and biased variance.

    Forward: each rank's per-channel sum, sum of squares and row count
    (from ``torch.var_mean``), one all-reduce, then ``var = E[x^2] -
    mean^2``. Backward: ``gamma``'s and ``beta``'s gradients are the
    rank's own sums (the step's gradient all-reduce adds them up), and
    the two per-channel sums of the input's gradient, ``sum(dy)`` and
    ``sum(dy * xhat)``, are all-reduced once, as the reference's
    SyncBatchNorm backward does. The statistics are float32 for a
    bfloat16 or float16 input."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, span):
        red = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
        var, mean = torch.var_mean(xf, dim=red, unbiased=False)
        n = torch.full((1,), float(x.numel() // x.shape[1]),
                       dtype=mean.dtype, device=x.device)
        sums = torch.cat([mean * n, (var + mean * mean) * n, n])
        span.all_reduce([sums])
        c = mean.numel()
        total = sums[2 * c]
        mean = sums[:c] / total
        var = torch.clamp(sums[c:2 * c] / total - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        out = xhat * weight.view(shape).to(xhat.dtype) + \
            bias.view(shape).to(xhat.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, total)
        ctx.span = span
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean.to(x.dtype), var.to(x.dtype)

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, total = ctx.saved_tensors
        red = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
        dyf = dy.to(xf.dtype)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        sum_dy = dyf.sum(dim=red)
        sum_dy_xhat = (dyf * xhat).sum(dim=red)
        dweight = sum_dy_xhat.to(weight.dtype)
        dbias = sum_dy.to(weight.dtype)
        sums = torch.cat([sum_dy, sum_dy_xhat])
        ctx.span.all_reduce([sums])
        c = mean.numel()
        g_dy = (sums[:c] / total).view(shape)
        g_dy_xhat = (sums[c:] / total).view(shape)
        dx = (weight.to(xf.dtype) * invstd).view(shape) * \
            (dyf - g_dy - xhat * g_dy_xhat)
        return dx.to(x.dtype), dweight, dbias, None, None


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
    span = _dist.current_span()
    if autograd.is_training() and not attrs.use_global_stats \
            and span is not None and span.world > 1:
        out, mean, var = _GlobalBatchNorm.apply(x, weight, beta, attrs.eps,
                                                span)
    elif autograd.is_training() and not attrs.use_global_stats:
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


@register("softmin", params=dict(_SOFTMAX_PARAMS))
def softmin(attrs, data):
    """softmax of -data."""
    return _softmax_impl(attrs, -data, log=False)


@register("SoftmaxActivation", params={"mode": (str, "instance")})
def softmax_activation(attrs, data):
    """softmax over the channel axis (``mode='channel'``) or over each
    sample's values."""
    if attrs.mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


@register("softmax_cross_entropy", inputs=("data", "label"))
def softmax_cross_entropy(attrs, data, label):
    """-sum(log_softmax(data)[i, label[i]]) over the batch: a scalar."""
    logprob = torch.log_softmax(data, dim=-1)
    return -logprob.gather(-1, label.to(torch.int64)[:, None]).sum()


@register("L2Normalization",
          params={"eps": (float, 1e-10), "mode": (str, "instance")})
def l2_normalization(attrs, data):
    """data / sqrt(sum(data^2) + eps) over each sample (``instance``),
    each position's channels (``channel``) or each channel's positions
    (``spatial``)."""
    if attrs.mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif attrs.mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, data.dim()))
    norm = torch.sqrt(torch.square(data).sum(dim=axes, keepdim=True)
                      + attrs.eps)
    return data / norm


@register("LRN",
          params={"alpha": (float, 1e-4), "beta": (float, 0.75),
                  "knorm": (float, 2.0), "nsize": (int, REQUIRED)})
def lrn(attrs, data):
    """Local response normalisation across ``nsize`` channels:
    data / (knorm + alpha * window_sum(data^2) / nsize) ** beta."""
    sq = torch.square(data)
    half = attrs.nsize // 2
    c = data.shape[1]
    widths = [0, 0] * (data.dim() - 2) + [half, half]
    padded = F.pad(sq, widths)
    window = sum(padded[:, i:i + c] for i in range(attrs.nsize))
    return data / torch.pow(attrs.knorm + attrs.alpha * window / attrs.nsize,
                            attrs.beta)


# ---------------------------------------------------------------------------
# convolution and pooling: channels-first (NCW, NCHW, NCDHW) or
# channels-last (NWC, NHWC, NDHWC); the weight is OI + spatial either way
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _channels_last(layout, nd):
    """Whether ``layout`` puts the channels last (any layout not starting
    with NC, as the JAX ``_conv_dims`` reads it)."""
    if nd not in _CONV:
        raise MXNetError("%d spatial dims: 1, 2 or 3 expected" % nd)
    return bool(layout) and not layout.startswith("NC")


def _to_first(x):
    return x.movedim(-1, 1)


def _to_last(x):
    return x.movedim(1, -1)


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
    """N-d convolution, weight (num_filter, C / num_group, *kernel); a
    channels-last input is moved to channels-first and back."""
    nd = len(attrs.kernel)
    last = _channels_last(attrs.layout, nd)
    bias = rest[0] if rest else None
    out = _CONV[nd](_to_first(data) if last else data, weight, bias,
                    stride=attrs.stride or (1,) * nd,
                    padding=attrs.pad or (0,) * nd,
                    dilation=attrs.dilate or (1,) * nd,
                    groups=attrs.num_group)
    return _to_last(out) if last else out


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
    last = _channels_last(attrs.layout, nd)
    bias = rest[0] if rest else None
    out = _DECONV[nd](_to_first(data) if last else data, weight, bias,
                      stride=attrs.stride or (1,) * nd,
                      padding=attrs.pad or (0,) * nd,
                      output_padding=attrs.adj or (0,) * nd,
                      groups=attrs.num_group,
                      dilation=attrs.dilate or (1,) * nd)
    return _to_last(out) if last else out


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
    """Max, average, sum and Lp pooling. The padding is applied here
    (-inf for max, 0 otherwise) and the pool runs unpadded, so the windows
    and divisors are the JAX ``reduce_window``'s: ``pooling_convention=
    'full'`` pads the high side up to a whole stride, and an average with
    ``count_include_pad`` divides by the kernel size. ``lp``: the window
    sums of |x|^p, to the power 1/p. A channels-last input is moved to
    channels-first and back."""
    nd = data.dim() - 2
    if _channels_last(attrs.layout, nd):
        return _to_last(_pool_first(attrs, _to_first(data)))
    return _pool_first(attrs, data)


def _pool_first(attrs, data):
    nd = data.dim() - 2
    spatial = tuple(range(2, 2 + nd))
    if attrs.global_pool:
        if attrs.pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        if attrs.pool_type == "avg":
            return data.mean(dim=spatial, keepdim=True)
        if attrs.pool_type == "sum":
            return data.sum(dim=spatial, keepdim=True)
        raise MXNetError("unsupported global pool_type %r"
                         % attrs.pool_type)
    if attrs.pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError("unsupported pool_type %r" % attrs.pool_type)
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
    if attrs.pool_type == "lp":
        p = float(attrs.p_value)
        x = torch.abs(data) ** p
        x = F.pad(x, widths) if padded else x
        return _window_sum(x, kernel, stride) ** (1.0 / p)
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
# regression and SVM outputs (mxnet_tpu/ops/nn.py:562-664, reference
# regression_output-inl.h, svm_output.cc): the forward is the link, the
# backward ignores the head gradient
# ---------------------------------------------------------------------------


class _RegressionOutput(torch.autograd.Function):
    """Forward ``link(data)``; backward ``grad_fn(out, label) *
    grad_scale / n``, n the outputs per sample; no gradient to the
    label."""

    @staticmethod
    def forward(ctx, data, label, link, grad_fn, scale):
        out = link(data)
        ctx.save_for_backward(out, label)
        ctx.grad_fn, ctx.scale = grad_fn, scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        n = 1
        for d in out.shape[1:]:
            n *= d
        grad = ctx.grad_fn(out, label.reshape(out.shape).to(out.dtype))
        return grad * (ctx.scale / n), None, None, None, None


def _register_regression(name, link, grad_fn):
    @register(name, params={"grad_scale": (float, 1.0)},
              inputs=("data", "label"))
    def _op(attrs, data, label):
        return _RegressionOutput.apply(data, label.detach(), link, grad_fn,
                                       attrs.grad_scale)

    _op.__doc__ = "%s: forward the link, backward (out - label) scaled." \
        % name
    return _op


_register_regression("LinearRegressionOutput", lambda x: x,
                     lambda o, l: o - l)
_register_regression("LogisticRegressionOutput", torch.sigmoid,
                     lambda o, l: o - l)
_register_regression("MAERegressionOutput", lambda x: x,
                     lambda o, l: torch.sign(o - l))


class _SVMOutput(torch.autograd.Function):
    """Forward the identity; backward the L1 (``use_linear``) or L2 SVM
    gradient for the label class and the others (reference
    svm_output.cc; ``mxnet_tpu/ops/nn.py:596-645``)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.margin, ctx.reg, ctx.use_linear = margin, reg, use_linear
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        margin, reg = ctx.margin, ctx.reg
        flat = out.reshape(out.shape[0], -1)
        onehot = _onehot(label.reshape(-1), flat.shape[-1], -1) \
            .to(flat.dtype)
        if ctx.use_linear:
            g_target = -(margin > flat).to(flat.dtype) * reg
            g_other = (margin > -flat).to(flat.dtype) * reg
        else:
            g_target = -2.0 * reg * torch.clamp_min(margin - flat, 0.0)
            g_other = 2.0 * reg * torch.clamp_min(margin + flat, 0.0)
        grad = onehot * g_target + (1.0 - onehot) * g_other
        return grad.reshape(out.shape), None, None, None, None


@register("SVMOutput",
          params={"margin": (float, 1.0),
                  "regularization_coefficient": (float, 1.0),
                  "use_linear": (bool, False)},
          inputs=("data", "label"))
def svm_output(attrs, data, label):
    """The identity, with the SVM loss's gradient in its backward."""
    return _SVMOutput.apply(data, label.detach(), attrs.margin,
                            attrs.regularization_coefficient,
                            attrs.use_linear)


# ---------------------------------------------------------------------------
# UpSampling (mxnet_tpu/ops/nn.py:666-700)
# ---------------------------------------------------------------------------


@register("UpSampling",
          params={"scale": (int, REQUIRED), "num_filter": (int, 0),
                  "sample_type": (str, "nearest"),
                  "multi_input_mode": (str, "concat"),
                  "num_args": (int, 1), "workspace": (int, 512)},
          inputs=lambda attrs: ["arg%d" % i
                                for i in range(attrs.get("num_args", 1))])
def upsampling(attrs, *xs):
    """Each NCHW input scaled ``scale`` times in H and W, nearest or
    bilinear (``jax.image.resize``'s weights), then joined on the
    channels (``concat``) or summed."""
    from .misc_tail import resize_axis

    s = attrs.scale
    outs = []
    for x in xs:
        if attrs.sample_type == "nearest":
            out = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
        else:
            out = resize_axis(resize_axis(x, 2, x.shape[2] * s, 1), 3,
                              x.shape[3] * s, 1)
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    if attrs.multi_input_mode == "concat":
        return torch.cat(outs, dim=1)
    return sum(outs[1:], outs[0])


# ---------------------------------------------------------------------------
# CTC loss (mxnet_tpu/ops/nn.py:935-1022, reference contrib/ctc_loss.cc):
# the log-space alpha recursion over the (B, 2L + 1) lattice, floored at
# -1e30 so an infeasible label gives a large finite loss and finite
# gradients
# ---------------------------------------------------------------------------

_CTC_NEG = -1e30


def _ctc_logaddexp(a, b):
    """log(e^a + e^b). |a - b| as a ``where``, so that at a tie (two
    floored alphas) the gradient is the JAX op's (``jnp.abs`` passes the
    gradient at 0 as at a positive value; ``torch.abs`` gives 0)."""
    m = torch.maximum(a, b)
    d = a - b
    return m + torch.log1p(torch.exp(-torch.where(d >= 0, d, -d)))


def ctc_forward(logp, lab, pl, ll):
    """Per-sample -log p(label | x): ``logp`` (B, T, C) log-probabilities,
    blank 0; ``lab`` (B, L) labels; ``pl`` (B,) input lengths, ``ll``
    (B,) label lengths. A step past a sample's length leaves its alphas
    as they were."""
    b, t_len, _ = logp.shape
    s = 2 * lab.shape[1] + 1
    ext = torch.zeros((b, s), dtype=torch.int64, device=logp.device)
    ext[:, 1::2] = lab
    neg = torch.full((b, 1), _CTC_NEG, dtype=logp.dtype, device=logp.device)
    first = logp[:, 0, :].gather(1, ext[:, 1:2])
    alpha = torch.cat([logp[:, 0, 0:1],
                       torch.where((ll > 0)[:, None], first, neg),
                       neg.expand(b, s - 2)], dim=1)
    same = torch.cat([torch.ones((b, 2), dtype=torch.bool,
                                 device=logp.device),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    for t in range(1, t_len):
        one = torch.cat([neg, alpha[:, :-1]], dim=1)
        two = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        two = torch.where(same, neg, two)
        merged = _ctc_logaddexp(_ctc_logaddexp(alpha, one), two)
        new = merged + logp[:, t, :].gather(1, ext)
        alpha = torch.where((t < pl)[:, None], new, alpha)
    ext_len = 2 * ll + 1
    last = (ext_len - 1).clamp(0, s - 1)[:, None]
    prev = (ext_len - 2).clamp(0, s - 1)[:, None]
    return -_ctc_logaddexp(alpha.gather(1, last)[:, 0],
                           alpha.gather(1, prev)[:, 0])


@register("CTCLoss",
          params={"use_data_lengths": (bool, False),
                  "use_label_lengths": (bool, False),
                  "blank_label": (str, "first")},
          inputs=lambda attrs: ["data", "label"]
          + (["data_lengths"] if attrs.get("use_data_lengths") else [])
          + (["label_lengths"] if attrs.get("use_label_lengths") else []),
          aliases=("_contrib_CTCLoss", "ctc_loss", "_contrib_ctc_loss"))
def ctc_loss(attrs, data, label, *rest):
    """data (B, T, C) activations, label (B, L); without label lengths a
    label ends at its first padding value (0 for ``blank_label='first'``,
    -1 for ``'last'``). ``'last'`` rotates the classes so the blank is
    index 0 and the labels up by one."""
    b, t_len, _ = data.shape
    logp = torch.log_softmax(data, dim=-1)
    lab = label.detach().to(torch.int64)
    i = 0
    if attrs.use_data_lengths:
        pl = rest[i].detach().to(torch.int64)
        i += 1
    else:
        pl = torch.full((b,), t_len, dtype=torch.int64, device=data.device)
    if attrs.use_label_lengths:
        ll = rest[i].detach().to(torch.int64)
    else:
        pad = -1 if attrs.blank_label == "last" else 0
        ll = (lab != pad).to(torch.int64).sum(dim=1)
    if attrs.blank_label == "last":
        logp = torch.cat([logp[..., -1:], logp[..., :-1]], dim=-1)
        lab = torch.where(lab < 0, torch.full_like(lab, -1), lab) + 1
    return ctc_forward(logp, lab, pl, ll)


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


# legacy names: the same OpDef as their modern op, as the JAX registry
# holds them (mxnet_tpu/ops/vision.py:712-745); SyncBatchNorm is BatchNorm,
# whose statistics are global inside a step that spans the job's ranks
for _legacy, _modern in (("_contrib_SyncBatchNorm", "BatchNorm"),
                         ("SyncBatchNorm", "BatchNorm"),
                         ("BatchNorm_v1", "BatchNorm"),
                         ("Convolution_v1", "Convolution"),
                         ("Pooling_v1", "Pooling")):
    OP_REGISTRY.setdefault(_legacy, OP_REGISTRY[_modern])
