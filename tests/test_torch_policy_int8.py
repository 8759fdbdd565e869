"""The whole slice on mla-tiny in int8 W8A8: each package quantizes the same
weights with its own quantize_model and serves the same request; the port's
chunk matches the JAX package's, whose int8 linears run the W8A8 branch."""

import numpy as np
import pytest

import torch_policy_parity as tpp


@pytest.fixture(scope="module")
def int8_model():
    return tpp.model(seed=4)


@pytest.mark.parametrize("sampler,cfg_scale", [("ddim", 0.0), ("ddim", 3.0), ("dpm", 0.0), ("dpm", 3.0)])
def test_predict_action_diff_matches_jax_int8(monkeypatch, int8_model, sampler, cfg_scale, record_property):
    # JAX picks 'dequant' off the TPU; the port always runs W8A8. The env
    # must be set before the JAX policy first traces its graph.
    monkeypatch.setenv("MLA_INT8_MODE", "w8a8")
    jpol, tpol = tpp.policies(*int8_model, quantized=True)
    j, t = tpp.both(jpol, tpol, sampler=sampler, cfg_scale=cfg_scale, return_normalized=True)
    assert t.shape == (16, 7) and np.isfinite(t).all()
    # the int8 leaves are identical and the int32 products exact; what
    # differs is fp32 summation order outside them, which can move an
    # activation across a rounding boundary of its int8 quantization (one
    # step = 1/127 of the row's max) in a rare element
    record_property("max_abs_err", float(np.abs(t - j).max()))
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-3)
