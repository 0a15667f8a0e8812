"""``HybridBlock.export`` and ``SymbolBlock`` on ``resnet18_v1`` at
32 x 32 (BatchNorm and the residual adds) against the JAX package (CPU):
the checks of ``test_torch_export.py`` (``torch_export_cases.py``): the
port's export round trip, the ``arg:``/``aux:`` split, and both
directions across packages, within 1e-5 of the largest magnitude."""
import pytest

import torch_export_cases as cases


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    return cases.export_both(cases.resnet, (2, 3, 32, 32),
                             tmp_path_factory.mktemp("export_resnet"))


def test_port_export_round_trips_in_the_port(exported):
    cases.check_round_trip(exported)


def test_params_split_arg_aux_as_the_jax_export(exported):
    cases.check_arg_aux_split(exported)


def test_jax_export_imports_into_the_port(exported):
    cases.check_jax_into_port(exported)


def test_port_export_imports_into_the_jax_package(exported):
    cases.check_port_into_jax(exported)
