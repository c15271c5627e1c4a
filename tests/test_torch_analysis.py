"""The port's analytical FLOP and byte counts against the JAX package's.

``repro_torch.launch.analysis`` is pure Python over the port's configs;
JAX's ``launch/analysis.py`` is too, but JAX's configs import JAX, so both
run here in-process.  Every registry arch at every input shape: the
``FlopReport`` and the byte model equal JAX's exactly.
"""
import dataclasses

import pytest

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch import analysis as jax_analysis
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import analysis


def test_the_registries_name_the_same_archs_and_shapes():
    from repro.configs.shapes import SHAPES as JAX_SHAPES

    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(ARCHS) == 10
    assert sorted(SHAPES) == sorted(JAX_SHAPES) and len(SHAPES) == 4


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytical_counts_equal_jax(arch, shape):
    got = analysis.analytical_flops(ARCHS[arch], shape)
    want = jax_analysis.analytical_flops(JAX_ARCHS[arch], shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total >= got.ideal > 0 and got.model_flops_6nd > 0
    assert (analysis.analytical_bytes(ARCHS[arch], shape)
            == jax_analysis.analytical_bytes(JAX_ARCHS[arch], shape))
