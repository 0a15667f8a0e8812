"""Install mxnet_tpu (counterpart of the reference's python/setup.py).

The native C++ runtime (src/) compiles lazily on first import via
mxnet_tpu._native (g++ required); no build step is needed here. Compute
dependencies (jax/jaxlib) are intentionally unpinned — match them to your
TPU runtime release.

The PyTorch/CUDA port, mxnet_tpu_torch, ships beside it. Its CUDA kernel
sources (mxnet_tpu_torch/ops/csrc/*.cu) are package data: each is built
with nvcc at first use on a machine with a card, never at install.
"""
from setuptools import find_packages, setup

setup(
    name="mxnet_tpu",
    version="1.3.0",
    description="TPU-native deep learning framework with the capabilities "
                "of Apache MXNet 1.3 on JAX/XLA/Pallas",
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    package_data={"mxnet_tpu_torch.ops": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={
        "dev": ["pytest"],
        "interop": ["torch"],
    },
    include_package_data=True,
)
