"""``HybridBlock.export`` and ``SymbolBlock`` against the JAX package
(CPU), on Dense/Conv/BatchNorm nets (BatchNorm with and without
``center``/``scale``); ``test_torch_export_resnet.py`` runs the same
checks on ``resnet18_v1``. The cases are in ``torch_export_cases.py``.

* The port's export comes back through its ``SymbolBlock.imports`` with
  the net's own output (fp32 within 1e-5 of the largest magnitude);
* the ``.params`` file splits ``arg:``/``aux:`` as the JAX package's
  export does (a ``grad_req='null'`` parameter is aux), and the symbol
  JSON lists the same nodes;
* across packages, both directions: the JAX export imported by the port,
  and the port's by the JAX package, each give the other's output
  within 1e-5 relative (weights carried by ``params_from_jax``);
* under ``autograd.record()`` an imported SymbolBlock records nothing,
  as in the JAX package: a backward from its output alone raises the
  same error, and its parameters and input get no gradient;
* a SymbolBlock of a two-output graph gives both outputs;
* exporting a net whose initialization is still deferred raises, as in
  the JAX package.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
import torch_export_cases as cases

NETS = [("bn", cases.bn_net),
        ("bn_no_center_scale", lambda p: cases.bn_net(p, False, False))]


@pytest.fixture(scope="module", params=NETS, ids=[n[0] for n in NETS])
def exported(request, tmp_path_factory):
    return cases.export_both(request.param[1], (2, 3, 6, 6),
                             tmp_path_factory.mktemp("export"))


def test_port_export_round_trips_in_the_port(exported):
    cases.check_round_trip(exported)


def test_params_split_arg_aux_as_the_jax_export(exported):
    cases.check_arg_aux_split(exported)


def test_jax_export_imports_into_the_port(exported):
    cases.check_jax_into_port(exported)


def test_port_export_imports_into_the_jax_package(exported):
    cases.check_port_into_jax(exported)


def test_imported_block_records_nothing_as_in_jax(tmp_path):
    """Under ``record()`` the JAX ``eval_nd`` unwraps its arrays: the
    output is off the tape. The port's is too."""
    errors, grads = [], []
    for pkg in (jmx, mx):
        with pkg.cpu():
            pkg.random.seed(1)
            net = cases.bn_net(pkg)
            net.initialize()
            prefix = str(tmp_path / pkg.__name__)
            net.export(prefix)
            sb = pkg.gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                               "data",
                                               prefix + "-0000.params")
            x = pkg.nd.array(cases.sample((2, 3, 6, 6)))
            x.attach_grad()
            w = pkg.nd.array(np.ones((2, 3), np.float32))
            w.attach_grad()
            with pkg.autograd.record():
                y = sb(x)
            with pytest.raises(Exception) as e:
                y.backward()
            errors.append((type(e.value).__name__, str(e.value)))
            with pkg.autograd.record():  # a head the tape does reach
                loss = (sb(x) * w).sum() + (w * w).sum()
            loss.backward()
            grads.append([np.abs(p.grad().asnumpy()).sum()
                          for p in sb.collect_params().values()
                          if p.grad_req != "null"]
                         + [np.abs(x.grad.asnumpy()).sum()])
            np.testing.assert_allclose(w.grad.asnumpy(), (
                y.asnumpy() + 2 * w.asnumpy()), rtol=1e-5, atol=1e-5)
    assert errors[1] == errors[0]
    assert grads[1] == grads[0] == [0.0] * len(grads[0])


def test_export_of_a_deferred_net_raises(tmp_path):
    for pkg in (jmx, mx):
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(3))
        net.initialize(ctx=pkg.cpu())
        with pytest.raises(Exception, match="deferred"):
            net.export(str(tmp_path / pkg.__name__))


def test_symbolblock_of_grouped_outputs(tmp_path):
    """A SymbolBlock of a two-output graph gives both outputs, as the
    JAX one does; a parameter takes its shape from its file."""
    outs = []
    w = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    x = cases.sample((3, 4))
    for pkg in (jmx, mx):
        with pkg.cpu():
            f = str(tmp_path / (pkg.__name__ + ".params"))
            pkg.nd.save(f, {"arg:fc_weight": pkg.nd.array(w)})
            data = pkg.sym.var("data")
            fc = pkg.sym.FullyConnected(data, num_hidden=2, no_bias=True,
                                        name="fc")
            sb = pkg.gluon.SymbolBlock([fc, pkg.sym.relu(fc)], data)
            sb.collect_params().load(f, ctx=pkg.cpu())
            outs.append([o.asnumpy() for o in sb(pkg.nd.array(x))])
            assert sb.collect_params()["fc_weight"].data().shape == (2, 4)
    assert len(outs[1]) == len(outs[0]) == 2
    for g, want in zip(outs[1], outs[0]):
        cases.rel_close(g, want)
