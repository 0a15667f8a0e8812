"""The port's ``ops/misc_tail.py`` against the JAX package's, name by
name (CPU).

Every case of ``torch_tail_cases``' misc_tail group runs through both
packages (``torch_op_sweep``: forward and gradients, ``rtol=atol=2e-5``
in float32; uint8 images exactly), and each alias runs its op's first
case under its own name. Decoding has cases of its own: PNG bytes (RGB,
RGBA, gray, gray+alpha, written by PIL) through ``_cvimdecode`` and
``imdecode_op`` in both packages (the JAX op decodes with PIL, the port
with its own codec) with every ``flag``/``to_rgb``, exactly; ``_cvimread``
of the same file; and a JPEG buffer, which the port refuses.
"""
import io

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_sweep import check
from torch_tail_cases import ALIASES, TAIL_CASES, canonical, group


@pytest.mark.parametrize("case", group("misc_tail") + group("sparse"))
def test_misc_tail_op_matches_jax(case):
    check(*TAIL_CASES[case], "float32")


@pytest.mark.parametrize("name", ALIASES["misc_tail"])
def test_misc_tail_alias_runs_its_op(name):
    op, specs, attrs, flags = canonical(name, OP_REGISTRY)
    assert OP_REGISTRY[name] is OP_REGISTRY[op]
    assert JAX_REGISTRY[name] is JAX_REGISTRY[op]
    check(name, specs, attrs, flags, "float32")


def _png(shape, seed):
    rs = np.random.RandomState(seed)
    arr = rs.randint(0, 256, shape).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


_IMAGES = {"rgb": ((6, 7, 3), 1), "rgba": ((5, 4, 4), 2),
           "gray": ((7, 3), 3), "gray_alpha": ((4, 6, 2), 4)}


@pytest.mark.parametrize("kind", sorted(_IMAGES))
@pytest.mark.parametrize("name", ["_cvimdecode", "imdecode_op"])
def test_cvimdecode_matches_jax_pil(kind, name):
    raw = np.frombuffer(_png(*_IMAGES[kind]), np.uint8)
    for flag, to_rgb in ((1, True), (1, False), (0, True)):
        want = jmx.nd.invoke(name, jmx.nd.array(raw, dtype="uint8"),
                             flag=flag, to_rgb=to_rgb).asnumpy()
        with mx.cpu():
            got = mx.nd.invoke(name, mx.nd.array(raw, dtype="uint8"),
                               flag=flag, to_rgb=to_rgb).asnumpy()
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_cvimread_matches_jax(tmp_path):
    path = tmp_path / "img.png"
    path.write_bytes(_png((5, 6, 3), 9))
    want = jmx.nd.invoke("_cvimread", filename=str(path)).asnumpy()
    with mx.cpu():
        got = mx.nd.invoke("_cvimread", filename=str(path))
    assert got.context == mx.cpu()
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_cvimdecode_refuses_jpeg():
    """JPEG now decodes: the port's op gives the JAX op's pixels (PIL's),
    exactly, for RGB, BGR and gray."""
    buf = io.BytesIO()
    img = np.random.RandomState(3).randint(0, 256, (9, 13, 3)).astype(
        np.uint8)
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    raw = np.frombuffer(buf.getvalue(), np.uint8)
    for kw in ({}, {"to_rgb": False}, {"flag": 0}):
        with mx.cpu():
            got = mx.nd.invoke("_cvimdecode", mx.nd.array(raw, dtype="uint8"),
                               **kw).asnumpy()
        want = jmx.nd.invoke("_cvimdecode", jmx.nd.array(raw, dtype="uint8"),
                             **kw).asnumpy()
        np.testing.assert_array_equal(got, want)
    with mx.cpu(), pytest.raises(MXNetError, match="neither"):
        mx.nd.invoke("_cvimdecode", mx.nd.array(raw[2:], dtype="uint8"))


def test_every_slice_18_name_has_a_parity_case():
    import inspect

    from torch_tail_cases import NN_NAMES, OWN_TESTS, SIGN_CASES

    mods = {"mxnet_tpu_torch.ops.linalg", "mxnet_tpu_torch.ops.misc_tail",
            "mxnet_tpu_torch.ops.sparse"}
    names = {n for n, o in OP_REGISTRY.items()
             if inspect.getmodule(o.fcompute).__name__ in mods}
    names |= set(NN_NAMES)
    assert len(names) == 30 + 21 + 3 + 19
    covered = {v[0] for v in TAIL_CASES.values()} | OWN_TESTS
    covered |= {v[0] for v in SIGN_CASES.values()}
    covered |= {n for group_names in ALIASES.values() for n in group_names}
    assert sorted(names - covered) == []
    for n in names:
        assert n in JAX_REGISTRY
