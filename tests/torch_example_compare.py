"""Run a JAX example script and the port's counterpart in this process,
seeded alike, recording every ``NDArray.backward`` head's mean in each
package, in call order. Used by ``test_torch_gluon_examples_*.py``."""
import importlib.util
import os
import sys

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record_heads(monkeypatch, pkg):
    """Every ``NDArray.backward`` head's mean, in call order."""
    heads = []
    orig = pkg.nd.NDArray.backward

    def backward(self, *args, **kwargs):
        heads.append(float(self.asnumpy().mean()))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(pkg.nd.NDArray, "backward", backward)
    return heads


def run_both(monkeypatch, name, argv, port_run):
    """``example/gluon/<name>.py``'s ``main`` with ``argv`` in the JAX
    package, then ``port_run(argv + ['--device', 'cpu'])``; returns (the
    port's heads, the JAX heads, what ``port_run`` returned)."""
    script = load_script("_jax_" + name, os.path.join(
        REPO, "example", "gluon", name + ".py"))
    want = record_heads(monkeypatch, jmx)
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    jmx.random.seed(0)
    script.main()
    got = record_heads(monkeypatch, mx)
    mx.random.seed(0)
    res = port_run(argv + ["--device", "cpu"])
    return got, want, res


def rel_errs(got, want):
    assert len(got) == len(want) > 0
    return [abs(g - w) / abs(w) for g, w in zip(got, want)]
