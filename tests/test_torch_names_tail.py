"""Three small names of the JAX package in the port: ``name.Prefix``,
``ops.list_ops`` and ``io.OrderedDictItems``, each against the JAX
package (exact: names, lists and iterator readings)."""
import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu import io as jio, name as jname, ops as jops

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io as tio, name as tname, ops as tops


def _names(mx, name_mod):
    with name_mod.Prefix("model_"):
        data = mx.sym.var("data")
        fc = mx.sym.FullyConnected(data, num_hidden=4)
        act = mx.sym.Activation(fc, act_type="relu")
        out = mx.sym.FullyConnected(act, num_hidden=2, name="head")
    return out.list_arguments(), fc.name, act.name, out.name


def test_prefix_names_symbols_as_the_jax_package_does():
    ours, theirs = _names(tmx, tname), _names(jmx, jname)
    assert ours == theirs
    assert ours[1].startswith("model_fullyconnected")
    assert ours[3] == "model_head"  # an explicit name is prefixed too


def test_prefix_is_a_name_manager_that_nests():
    assert issubclass(tname.Prefix, tname.NameManager)
    with tname.Prefix("a_") as outer:
        assert tname.NameManager.current() is outer
        assert outer.get(None, "conv") == "a_conv0"
        assert outer.get(None, "conv") == "a_conv1"
        with tname.Prefix("b_"):
            assert tname.NameManager.current().get("x", "fc") == "b_x"
        assert tname.NameManager.current() is outer


def test_list_ops_equals_the_jax_registry():
    ours = tops.list_ops()
    assert ours == sorted(ours) and len(set(ours)) == len(ours)
    assert ours == jops.list_ops()
    assert tops.get_op("FullyConnected") is tops.OP_REGISTRY["FullyConnected"]
    assert tops.registry.list_ops() == ours


def test_ordered_dict_items_keeps_the_order_of_the_inputs():
    assert issubclass(tio.OrderedDictItems, list)
    pairs = tio.OrderedDictItems([("b", 1), ("a", 2)])
    assert list(pairs) == [("b", 1), ("a", 2)]
    assert pairs == jio.OrderedDictItems([("b", 1), ("a", 2)])
    rs = np.random.RandomState(0)
    arrays = [rs.rand(6, 3).astype(np.float32) for _ in range(2)]
    with tmx.cpu():
        for data in (arrays, {"z": arrays[0], "y": arrays[1]}):
            ours = tio.NDArrayIter(data, batch_size=2)
            theirs = jio.NDArrayIter(data, batch_size=2)
            assert [d.name for d in ours.provide_data] == \
                [d.name for d in theirs.provide_data]
            for a, b in zip(ours.next().data, theirs.next().data):
                np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    # the iterators' own normalization gives OrderedDictItems pairs
    got = tio._init_data({"z": arrays[0]}, False, "data")
    want = jio._init_data({"z": arrays[0]}, False, "data")
    assert [k for k, _ in got] == [k for k, _ in want] == ["z"]
