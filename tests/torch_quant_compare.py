"""``contrib.quantization.quantize_model`` in both packages, compared
(CPU): the nets, their JAX export loaded by both packages, the
quantization under each calibration mode, and the checks, for
``test_torch_quantize_model.py`` (a small conv net) and
``test_torch_quantize_resnet.py`` (the zoo's ``resnet18_v1``).

Held: the quantized symbol's JSON node for node (a range measured on
the calibration data within 2e-5), the quantized params exactly (int8
bits and dtypes), and the outputs. For ``entropy`` the JAX package's
threshold search is swapped for the port's, whose results
``test_torch_quantization.py`` holds equal bit for bit (the JAX one
takes seconds a tensor); on resnet18_v1 both search 2001 bins instead of
8001 (its 42 tensors would take a minute).

The outputs: the JAX package's quantized symbol and params, run by the
port, give the JAX outputs within 2e-5 (the int8 maths is exact and the
float layers agree); the port's own quantized net gives them within 2e-5
where every measured range is bit-equal, and otherwise within a few
steps of the output's quantization grid with the same top-1 class: a
range one float32 step apart moves some value of the next ``quantize``
across a rounding edge.
"""
import functools
import json

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch.contrib import quantization as tq
from torch_op_sweep import same


def conv_net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Conv2D(8, 3, padding=1, activation="relu"),
            pkg.gluon.nn.Conv2D(8, 3, strides=2, use_bias=False),
            pkg.gluon.nn.BatchNorm(),
            pkg.gluon.nn.Activation("relu"),
            pkg.gluon.nn.Flatten(),
            pkg.gluon.nn.Dense(5))
    return net


def resnet(pkg):
    return pkg.gluon.model_zoo.vision.resnet18_v1(classes=10)


def exported(build, shape, d):
    """The JAX net exported once; both packages load that symbol and
    those params: (jax triple, port triple)."""
    jmx.random.seed(0)
    np.random.seed(0)
    net = build(jmx)
    net.initialize(jmx.initializer.Xavier(magnitude=2.0))
    net.hybridize()
    net(jmx.nd.array(np.random.RandomState(1).randn(*shape)
                     .astype(np.float32)))
    d.mkdir(parents=True, exist_ok=True)
    prefix = str(d / "net")
    net.export(prefix)
    sym_file, par_file = prefix + "-symbol.json", prefix + "-0000.params"

    def split(params):
        arg = {k[4:]: v for k, v in params.items() if k.startswith("arg:")}
        aux = {k[4:]: v for k, v in params.items() if k.startswith("aux:")}
        return arg, aux

    jt = (jmx.sym.load(sym_file),) + split(jmx.nd.load(par_file))
    pt = (mx.sym.load(sym_file),) + split(mx.nd.load(par_file,
                                                     ctx=mx.cpu()))
    return jt, pt


def _calib(pkg, shape, n=8):
    x = np.random.RandomState(2).randn(n, *shape[1:]).astype(np.float32)
    x[::4] *= 6.0  # outliers, so the entropy threshold clips
    return pkg.io.NDArrayIter(x, np.zeros(n, np.float32),
                              batch_size=shape[0])


def _forward(pkg, sym, arg, aux, x):
    ctx = pkg.cpu()
    ex = sym.simple_bind(ctx, data=x.shape, grad_req="null")
    # a bias the rewrite dropped stays in the params (see _same_graph)
    ex.copy_params_from(arg, aux, allow_extra_params=True)
    if pkg is mx:
        ex.copy_params_from({"data": mx.nd.array(x)})
    else:
        ex.arg_dict["data"]._data = jmx.nd.array(x)._data
    return ex.forward(is_train=False)[0].asnumpy()


def _nodes(sym):
    doc = json.loads(sym.tojson())
    return [(n["op"], n["name"], n["inputs"], n.get("attrs", {}))
            for n in doc["nodes"]], doc["heads"], doc["arg_nodes"]


# the attrs that carry a range measured on the calibration data: the float
# layers before a quantized layer round differently in the two packages
# (XLA fuses), so a measured range may differ in its last float32 bits
_MEASURED = {"value", "min_calib_range", "max_calib_range"}


def _same_graph(got, want):
    """Node for node: ops, names, inputs, heads and attrs equal, measured
    ranges within 2e-5 relative. Both packages rewrite a layer whose
    ``no_bias`` attr is the string "False" (any symbol loaded from JSON)
    as one without a bias, as the JAX package does."""
    (gn, gh, ga), (wn, wh, wa) = _nodes(got), _nodes(want)
    assert (gh, ga) == (wh, wa)
    assert len(gn) == len(wn)
    for g, w in zip(gn, wn):
        assert g[:3] == w[:3]
        assert set(g[3]) == set(w[3]), (g, w)
        for k, v in w[3].items():
            if k in _MEASURED and g[3][k] != v:
                np.testing.assert_allclose(float(g[3][k]), float(v),
                                           rtol=2e-5, err_msg=str(g))
            else:
                assert g[3][k] == v, (g, w)


def quantize_both(nets, which, mode, excluded=None):
    shape, (jsym, jarg, jaux), (psym, parg, paux) = nets[which]
    kw = {"calib_mode": mode, "excluded_sym_names": excluded}
    out = []
    for pkg, qmod, sym, arg, aux in ((jmx, jq, jsym, jarg, jaux),
                                     (mx, tq, psym, parg, paux)):
        extra = {} if mode == "none" else {
            "calib_data": _calib(pkg, shape), "num_calib_examples": 8}
        if pkg is mx:
            extra["ctx"] = mx.cpu()
        out.append(qmod.quantize_model(sym, arg, aux, **kw, **extra))
    return shape, out


def _to_port(params):
    return {k: mx.nd.array(v.asnumpy(), dtype=v.asnumpy().dtype)
            for k, v in params.items()}


def _output_step(sym):
    """The step of the last quantized layer's output grid (its calibrated
    range over 127), where the graph ends in that layer."""
    nodes = _nodes(sym)[0]
    last = [n for n in nodes if n[0] == "_contrib_requantize"][-1]
    return float(last[3]["max_calib_range"]) / 127.0


def _conv_names(sym):
    return [n for n, op in ((n["name"], n["op"]) for n in
                            json.loads(sym.tojson())["nodes"])
            if op == "Convolution"]


def check(nets, which, mode, exclude, monkeypatch):
    """Quantize ``nets[which]`` in both packages under ``mode`` (with the
    second convolution excluded if ``exclude``) and hold the results."""
    search = tq._get_optimal_threshold
    if which == "resnet18_v1":
        search = functools.partial(search, num_bins=2001)
        monkeypatch.setattr(tq, "_get_optimal_threshold", search)
    monkeypatch.setattr(jq, "_get_optimal_threshold", search)
    # excluded: the export's second convolution stays float
    excluded = _conv_names(nets[which][1][0])[1:2] if exclude else None
    shape, ((jq_sym, jq_arg, jq_aux), (pq_sym, pq_arg, pq_aux)) = \
        quantize_both(nets, which, mode, excluded)
    _same_graph(pq_sym, jq_sym)
    if mode == "none":  # no measured range: every attr equal
        assert _nodes(pq_sym) == _nodes(jq_sym)
    ops = [n[0] for n in _nodes(pq_sym)[0]]
    assert "_contrib_quantized_conv" in ops
    assert sorted(pq_arg) == sorted(jq_arg)
    for k in jq_arg:
        g, w = pq_arg[k].asnumpy(), jq_arg[k].asnumpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert sorted(pq_aux) == sorted(jq_aux)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = _forward(jmx, jq_sym, jq_arg, jq_aux, x)
    # the JAX graph and params, run by the port
    jax_graph = mx.sym.load_json(jq_sym.tojson())
    same(_forward(mx, jax_graph, _to_port(jq_arg), _to_port(jq_aux), x),
         want)
    got = _forward(mx, pq_sym, pq_arg, pq_aux, x)
    if _nodes(pq_sym) == _nodes(jq_sym):
        same(got, want)
    else:
        step = _output_step(jq_sym)
        assert np.abs(got - want).max() <= 3 * step + 2e-5
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    if excluded:
        assert [n[0] for n in _nodes(pq_sym)[0] if n[1] == excluded[0]] \
            == ["Convolution"]
