"""The port's vision model zoo against the JAX package's (CPU).

* Every name of the JAX package's ``get_model`` table
  (``mxnet_tpu/gluon/model_zoo/vision/__init__.py:20-47``) builds in the
  port, with the same parameter names (after ``params_from_jax``'s
  canonical renumbering); ``pretrained=True`` raises in every family.
* Forwards of VGG (with and without BatchNorm, small ``filters``) and
  AlexNet equal the JAX nets' from the same weights
  (``params_from_jax``) in predict mode (the Dropout layers draw in train
  mode, from each package's own generator). He-initialized weights
  (Xavier, gaussian, fan-in, magnitude 2) keep the logits' scale through
  the depth; the tolerance is ``TOL`` of the largest logit.
  ``test_torch_zoo_squeezenet.py``, ``test_torch_zoo_mobilenet.py``
  (with DenseNet), ``test_torch_zoo_mobilenet_v2.py`` and
  ``test_torch_zoo_inception.py`` hold the other families.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd
from mxnet_tpu_torch.gluon import _canonical_names
from mxnet_tpu_torch.gluon.model_zoo import vision

TOL = 2e-5  # fp32, two packages (test_decode.py:46-51)
JAX_NAMES = ("resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
             "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
             "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16",
             "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
             "alexnet", "densenet121", "densenet161", "densenet169",
             "densenet201", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
             "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
             "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.75",
             "mobilenetv2_0.5", "mobilenetv2_0.25")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def he(pkg):
    return pkg.initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2)


def compare(make, side, batch=2, train=False, tol=TOL):
    """The family's net built by ``make(vision module)`` in both packages
    from the JAX net's He weights, one forward on ``RandomState(0)``
    images: the logits within ``tol`` of the largest one, the parameter
    names equal, and in train mode the moving statistics within ``tol``.
    Returns the largest logit difference and the largest logit."""
    x = np.random.RandomState(0).rand(batch, 3, side, side).astype(
        np.float32)
    jmx.random.seed(0)
    jnet = make(jvision)
    jnet.initialize(he(jmx))
    with jmx.autograd.predict_mode():
        jout = jnet(jmx.nd.array(x)).asnumpy()  # makes the parameters
    arrays = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    if train:
        with jmx.autograd.train_mode():
            jout = jnet(jmx.nd.array(x)).asnumpy()
    with mx.cpu():
        net = make(vision)
        net.initialize()
        assert sorted(_canonical_names(list(net.collect_params()))) == \
            sorted(_canonical_names(list(arrays)))
        gluon.params_from_jax(net, {k: v for k, v in arrays.items()})
        mode = autograd.train_mode() if train else autograd.predict_mode()
        with mode:
            out = net(nd.array(x)).asnumpy()
    scale = float(np.abs(jout).max())
    assert out.shape == jout.shape
    # the logits kept a scale (VGG's Dense layers draw from their own
    # Normal(0.01), which brings its logits to about 5e-3)
    assert scale > 1e-3
    err = float(np.abs(out - jout).max())
    assert err <= tol * max(1.0, scale), (err, scale)
    if train:  # the moving statistics moved alike
        jstats, stats = ({n: p.data().asnumpy() for n, p in zip(
            _canonical_names(list(params)), params.values()) if "running" in n}
            for params in (jnet.collect_params(), net.collect_params()))
        assert jstats and sorted(jstats) == sorted(stats)
        for name, jv in jstats.items():
            np.testing.assert_allclose(stats[name], jv, rtol=tol, atol=tol,
                                       err_msg=name)
    return err, scale


@pytest.mark.parametrize("name", JAX_NAMES)
def test_every_jax_name_builds_with_the_jax_parameter_names(name):
    assert sorted(vision._MODELS) == sorted(JAX_NAMES)
    jmx.random.seed(0)
    jnet = jvision.get_model(name, classes=10)
    net = vision.get_model(name, classes=10)
    assert type(net).__name__ == type(jnet).__name__
    assert sorted(_canonical_names(list(net.collect_params()))) == \
        sorted(_canonical_names(list(jnet.collect_params())))
    with pytest.raises(MXNetError, match="pretrained"):
        vision.get_model(name, pretrained=True)


def test_get_model_refuses_unknown_names_and_takes_any_case():
    with pytest.raises(MXNetError, match="not supported"):
        vision.get_model("vgg17")
    assert isinstance(vision.get_model("SqueezeNet1.1"), vision.SqueezeNet)
    for attr in ("alexnet", "vgg16", "squeezenet1_0", "densenet121",
                 "inception_v3", "mobilenet1_0", "mobilenet_v2_1_0",
                 "resnet152_v1"):  # benchmark_score's attribute names
        assert callable(getattr(vision, attr))
    with pytest.raises(MXNetError, match="Invalid"):
        vision.get_vgg(12)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_vgg_forward_matches_jax(batch_norm):
    compare(lambda v: v.VGG([1, 1, 1, 1, 1], [4, 4, 8, 8, 8], classes=10,
                            batch_norm=batch_norm), 32)


def test_alexnet_forward_matches_jax():
    compare(lambda v: v.alexnet(classes=10), 224)
