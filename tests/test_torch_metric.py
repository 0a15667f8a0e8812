"""The port's metric.py against the JAX package's (CPU).

Every metric of ``mxnet_tpu/metric.py`` is fed the same numpy labels and
predictions (from a seed), in two batches, as NDArrays of each package;
``get()`` must agree within 1e-6 (both accumulate on the host in float64
from the same float32 inputs; the port copies with torch, the JAX
package with numpy, so only the last bits may differ). Then ``create``
by every name and alias, and ``CompositeEvalMetric``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = dict(rtol=1e-6, atol=1e-6)
N, C = 40, 5


def _probs(rng, n, c):
    p = rng.rand(n, c).astype(np.float32) + 0.05
    return p / p.sum(1, keepdims=True)


def _batches(kind, rng):
    out = []
    for _ in range(2):
        if kind == "class":
            out.append((rng.randint(0, C, N).astype(np.float32),
                        _probs(rng, N, C)))
        elif kind == "binary":
            out.append((rng.randint(0, 2, N).astype(np.float32),
                        _probs(rng, N, 2)))
        elif kind == "regress":
            out.append((rng.randn(N).astype(np.float32),
                        rng.randn(N).astype(np.float32)))
        elif kind == "loss":
            out.append((None, rng.rand(N).astype(np.float32)))
    return out


def _feval(label, pred):
    return float(np.abs(label - pred.argmax(1)).sum()), len(label)


METRICS = [
    ("acc", (), {}, "class"),
    ("top_k_accuracy", (), {"top_k": 3}, "class"),
    ("f1", (), {}, "binary"),
    ("f1", (), {"average": "micro"}, "binary"),
    ("mcc", (), {}, "binary"),
    ("mcc", (), {"average": "micro"}, "binary"),
    ("perplexity", (), {"ignore_label": None}, "class"),
    ("perplexity", (), {"ignore_label": 0}, "class"),
    ("mae", (), {}, "regress"),
    ("mse", (), {}, "regress"),
    ("rmse", (), {}, "regress"),
    ("ce", (), {}, "class"),
    ("nll_loss", (), {}, "class"),
    ("pearsonr", (), {}, "regress"),
    ("loss", (), {}, "loss"),
    ("torch", (), {}, "loss"),
    ("caffe", (), {}, "loss"),
    ("custom", (_feval,), {"name": "dist"}, "class"),
]


def _make(pkg, name, args, kw):
    if name == "custom":
        return pkg.metric.CustomMetric(*args, **kw)
    return pkg.metric.create(name, *args, **kw)


@pytest.mark.parametrize("name,args,kw,kind", METRICS,
                         ids=["%s-%d" % (m[0], i)
                              for i, m in enumerate(METRICS)])
def test_metric_matches_jax(name, args, kw, kind):
    rng = np.random.RandomState(17)
    theirs, ours = _make(jmx, name, args, kw), _make(mx, name, args, kw)
    assert type(ours).__name__ == type(theirs).__name__
    with mx.cpu():
        for label, pred in _batches(kind, rng):
            jl = None if label is None else [jmx.nd.array(label)]
            tl = None if label is None else [mx.nd.array(label)]
            theirs.update(jl, [jmx.nd.array(pred)])
            ours.update(tl, [mx.nd.array(pred)])
    (jn, jv), (tn, tv) = theirs.get(), ours.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, **TOL)
    ours.reset()
    assert np.isnan(ours.get()[1])


def test_np_decorator_matches_jax():
    rng = np.random.RandomState(3)
    label, pred = rng.randint(0, C, N), _probs(rng, N, C)

    def hits(lab, p):
        return float((p.argmax(1) == lab).mean())

    theirs, ours = jmx.metric.np(hits), mx.metric.np(hits)
    theirs.update([label], [pred])
    ours.update([label], [pred])
    assert ours.get() == theirs.get()


ALIASES = ["acc", "accuracy", "top_k_acc", "top_k_accuracy", "f1", "mcc",
           "perplexity", "mae", "mse", "rmse", "ce", "crossentropy",
           "nll_loss", "negativeloglikelihood", "pearsonr",
           "pearsoncorrelation", "loss", "torch", "caffe", "composite",
           "compositeevalmetric", "ACC", "MSE"]


@pytest.mark.parametrize("name", ALIASES)
def test_create_by_name_and_alias_matches_jax(name):
    kw = {"top_k": 2} if "top_k" in name else \
        {"ignore_label": None} if name == "perplexity" else {}
    ours, theirs = mx.metric.create(name, **kw), jmx.metric.create(name,
                                                                   **kw)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.name == theirs.name


def test_create_unknown_raises_like_jax():
    with pytest.raises(jmx.MXNetError, match="not registered"):
        jmx.metric.create("no_such_metric")
    with pytest.raises(mx.MXNetError, match="not registered"):
        mx.metric.create("no_such_metric")


def test_composite_matches_jax():
    rng = np.random.RandomState(11)
    theirs = jmx.metric.create(["acc", "ce", _feval])
    ours = mx.metric.create(["acc", "ce", _feval])
    assert isinstance(ours, mx.metric.CompositeEvalMetric)
    with mx.cpu():
        for label, pred in _batches("class", rng):
            theirs.update_dict({"l": jmx.nd.array(label)},
                               {"p": jmx.nd.array(pred)})
            ours.update_dict({"l": mx.nd.array(label)},
                             {"p": mx.nd.array(pred)})
    (jn, jv), (tn, tv) = theirs.get(), ours.get()
    assert tn == jn == ["accuracy", "cross-entropy", "_feval"]
    np.testing.assert_allclose(tv, jv, **TOL)
    assert ours.get_name_value() == list(zip(tn, tv))
