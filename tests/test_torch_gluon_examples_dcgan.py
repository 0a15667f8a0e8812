"""The port's ``example/gluon/dcgan.py`` against the JAX script (CPU),
both in this process, seeded alike (``torch_example_compare.py``): every
backward's head, the discriminator's and the generator's per-sample
losses, step for step at ``--epochs 1 --num-samples 96`` (3 steps of
each player). ``HOME`` is the test's directory, so ``MNIST()`` finds no
files and both take the synthetic blobs; nothing is written outside it.

Tolerances: the first step of each player, from the same weights and
batch, within 1e-6 relative (measured 1.5e-7 and 4.3e-7). The later
steps within 5e-4 relative, where the aim was 1e-4: Adam's first step
moves each weight by about ``lr * sign(gradient)``, and a generator
convolution weight whose gradient is fp32 rounding noise (a direction
the BatchNorm after it cancels) moves by +-lr on the noise's sign,
which differs between the packages: after one step of each player the
generator's three transposed-conv weights differ by 3.99e-4 = 2 x lr in
a few elements, while every gradient of that first step agrees within
3e-6 relative with no sign flip, and the next losses differ by up to
2.05e-4 (measured on a CPU).
"""
import os

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.example.gluon import dcgan
from torch_example_compare import REPO, load_script, rel_errs, run_both


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("MXNET_TPU_FAKE_DATA", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dcgan_losses_step_for_step(monkeypatch, tmp_path):
    got, want, res = run_both(
        monkeypatch, "dcgan", ["--epochs", "1", "--num-samples", "96"],
        lambda argv: dcgan.run(dcgan.parse_args(argv)))
    assert len(got) == 6  # (D, G) x 3 steps
    errs = rel_errs(got, want)
    assert max(errs[:2]) <= 1e-6
    assert max(errs[2:]) <= 5e-4
    np.testing.assert_allclose(res["d_losses"], got[0::2], rtol=1e-6)
    np.testing.assert_allclose(res["g_losses"], got[1::2], rtol=1e-6)
    lo, hi = res["sample_range"]
    assert -1.0 <= lo <= hi <= 1.0  # tanh
    # MNIST() made its root under HOME, as the JAX package's does
    assert os.path.isdir(tmp_path / ".mxnet" / "datasets" / "mnist")


def test_mnist_branch_with_fake_data(monkeypatch):
    """Under ``MXNET_TPU_FAKE_DATA=1`` both load the synthetic MNIST set,
    padded to 32 x 32: the same images."""
    monkeypatch.setenv("MXNET_TPU_FAKE_DATA", "1")
    script = load_script("_jax_dcgan_data", os.path.join(
        REPO, "example", "gluon", "dcgan.py"))
    got, want = dcgan.load_images(20), script.load_images(20)
    assert got.shape == (20, 1, 32, 32)
    np.testing.assert_array_equal(got, want)
