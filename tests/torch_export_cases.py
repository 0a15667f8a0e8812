"""Shared cases of ``test_torch_export*.py``: nets built in either
package, the JAX net's weights carried into the port's, each exported,
and the checks each test file runs on them (fp32 within 1e-5 of the
largest magnitude: the same ops in the same order, but
``Symbol.eval_nd`` and the eager layers may group a sum differently)."""
import json

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon

REL = 1e-5


def rel_close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = rel * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= bound


def bn_net(pkg, center=True, scale=True):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
                nn.BatchNorm(center=center, scale=scale, in_channels=4),
                nn.Activation("relu"), nn.Flatten(),
                nn.Dense(6, in_units=4 * 6 * 6),
                nn.BatchNorm(in_channels=6), nn.Dense(3, in_units=6))
    return net


def resnet(pkg):
    return pkg.gluon.model_zoo.vision.resnet18_v1(classes=10)


def sample(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _train_stats(pkg, net, x):
    """One train-mode forward, so the moving statistics are not the
    initial ones."""
    with pkg.autograd.record():
        net(pkg.nd.array(x, ctx=pkg.cpu()))


def jax_net(build, x, seed=0):
    jmx.random.seed(seed)
    jnet = build(jmx)
    jnet.initialize(jmx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                    ctx=jmx.cpu())
    _train_stats(jmx, jnet, x)
    return jnet


def port_net(build, jnet, x):
    """The port's net with the JAX net's weights and statistics."""
    with mx.cpu():
        net = build(mx)
        net.initialize()
        net(mx.nd.array(x))  # finish any deferred shapes
    gluon.params_from_jax(net, {k: p.data().asnumpy() for k, p in
                                jnet.collect_params().items()})
    return net




def export_both(build, shape, d):
    """Both packages' nets (the same weights), each exported under
    ``d``; returns (d, the JAX net, the port's net, an input)."""
    x = sample(shape)
    jnet = jax_net(build, x)
    net = port_net(build, jnet, x)
    jnet.export(str(d / "jax"))
    net.export(str(d / "port"))
    return d, jnet, net, sample(shape, 1)


def check_round_trip(exported):
    d, _, net, x = exported
    with mx.cpu():
        sb = gluon.SymbolBlock.imports(str(d / "port-symbol.json"), "data",
                                       str(d / "port-0000.params"))
        got = sb(mx.nd.array(x)).asnumpy()
        want = net(mx.nd.array(x)).asnumpy()
    rel_close(got, want)
    assert set(sb.collect_params()) == set(net.collect_params())


def check_arg_aux_split(exported):
    d, jnet, net, _ = exported
    got = mx.nd.load(str(d / "port-0000.params"), ctx=mx.cpu())
    want = jmx.nd.load(str(d / "jax-0000.params"))

    def tagged(keys):
        return sorted((k.split(":")[0], n) for k, n in zip(
            keys, gluon._canonical_names([k.split(":", 1)[1]
                                          for k in keys])))

    assert tagged(list(got)) == tagged(list(want))
    aux = {k.split(":", 1)[1] for k in got if k.startswith("aux:")}
    nulls = {k for k, p in net.collect_params().items()
             if p.grad_req == "null"}
    assert aux == nulls and aux  # every 'null' parameter, and only those
    gj = json.loads((d / "port-symbol.json").read_text())
    jj = json.loads((d / "jax-symbol.json").read_text())
    assert [n["op"] for n in gj["nodes"]] == [n["op"] for n in jj["nodes"]]
    assert len(gj["heads"]) == len(jj["heads"]) == 1


def check_jax_into_port(exported):
    d, jnet, _, x = exported
    want = jnet(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy()
    with mx.cpu():
        sb = gluon.SymbolBlock.imports(str(d / "jax-symbol.json"), "data",
                                       str(d / "jax-0000.params"))
        got = sb(mx.nd.array(x)).asnumpy()
    rel_close(got, want)


def check_port_into_jax(exported):
    d, _, net, x = exported
    with mx.cpu():
        want = net(mx.nd.array(x)).asnumpy()
    sb = jmx.gluon.SymbolBlock.imports(str(d / "port-symbol.json"), "data",
                                       str(d / "port-0000.params"),
                                       ctx=jmx.cpu())
    rel_close(sb(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy(), want)
