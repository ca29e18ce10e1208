"""Parity of the port's quantization core with the JAX package: bit
packing, activation quantization, the fake-quant weight quantizers and the
serving exports.  Inputs are made with numpy and handed to both packages.

Integer results (packed bytes, int8 codes) must be exactly equal.  Float
scales are means over the weight, summed in another order by each
framework, so they are compared at rtol 1e-6 (f32 rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core import quantization as jquant
from repro.train import quantized_serving as jserve
from repro_torch.core import packing, quantization
from repro_torch.train import quantized_serving as serve

RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("shape", [(64, 24), (3, 16, 40), (2, 1, 8, 5)])
def test_pack_unpack_signs_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    signs = np.where(rng.random(shape) > 0.5, 1, -1).astype(np.int8)
    got = packing.pack_signs(_t(signs))
    want = np.asarray(jpacking.pack_signs(jnp.asarray(signs)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = packing.unpack_signs(got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jpacking.unpack_signs(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), signs)


def test_pack_rejects_unaligned_k():
    with pytest.raises(ValueError):
        packing.pack_signs(torch.ones((12, 4)))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 40.0])
def test_quantize_act_int8_codes_match_jax(scale):
    rng = np.random.default_rng(int(scale * 10))
    x = (rng.standard_normal((7, 96)) * scale).astype(np.float32)
    x[3] = 0.0  # an all-zero row: gamma = 127 / 1e-5, codes 0
    q, g = quantization.quantize_act_int8(_t(x))
    jq, jg = jquant.quantize_act_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    fq, fg = quantization.quantize_activations_int8(_t(x))
    jfq, jfg = jquant.quantize_activations_int8(jnp.asarray(x))
    np.testing.assert_array_equal(fq.numpy(), np.asarray(jfq))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jfg))


def test_weight_fake_quantizers_match_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 48)).astype(np.float32) * 0.1
    cases = [
        (quantization.binarize_weights, jquant.binarize_weights),
        (quantization.ternarize_weights, jquant.ternarize_weights),
        (quantization.quantize_weights_int8, jquant.quantize_weights_int8),
        (quantization.binarize_weights_channelwise, jquant.binarize_weights_channelwise),
        (lambda v: quantization.binarize_weights_grouped(v, 16),
         lambda v: jquant.binarize_weights_grouped(v, 16)),
    ]
    for port, ref in cases:
        (wq, s), (jwq, js) = port(_t(w)), ref(jnp.asarray(w))
        np.testing.assert_allclose(wq.numpy(), np.asarray(jwq), rtol=RTOL, atol=0)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL, atol=0)
    ws = rng.standard_normal((2, 16, 8)).astype(np.float32)
    wq, s = quantization.quantize_weights_int8_stacked(_t(ws))
    jwq, js = jquant.quantize_weights_int8_stacked(jnp.asarray(ws))
    np.testing.assert_allclose(wq.numpy(), np.asarray(jwq), rtol=RTOL, atol=0)


@pytest.mark.parametrize("shape", [(64, 40), (4, 96, 64), (4, 1, 64, 16)])
def test_binarize_and_int8_exports_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    for packed in (True, False):
        got = serve._binarize_export(_t(w), packed)
        want = jserve._binarize_export(jnp.asarray(w), packed)
        assert set(got) == set(want)
        key = "packed" if packed else "q"
        assert got[key].dtype == (torch.uint8 if packed else torch.int8)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]), rtol=RTOL)
    got, want = serve._int8_export(_t(w)), jserve._int8_export(jnp.asarray(w))
    assert got["q"].dtype == torch.int8 and got["scale"].shape == want["scale"].shape
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]), rtol=RTOL)


@pytest.mark.parametrize("shape", [(3, 512, 1024), (2, 3, 256, 640)])
def test_binarize_export_of_a_stack_equals_its_slices_alone(shape):
    """Each (K, N) slice's scale and packed signs, bit for bit, as the slice
    exports alone: a block-by-block export equals the one-shot export."""
    w = _t((np.random.default_rng(len(shape)).standard_normal(shape) * 0.05).astype(np.float32))
    whole = serve._binarize_export(w, packed=True)
    for i, s in enumerate(w.reshape((-1,) + shape[-2:])):
        alone = serve._binarize_export(s.clone(), packed=True)
        at = np.unravel_index(i, shape[:-2])
        assert torch.equal(whole["scale"][at], alone["scale"]), at
        assert torch.equal(whole["packed"][at], alone["packed"]), at


def test_unaligned_k_export_keeps_int8_signs():
    w = np.random.default_rng(0).standard_normal((12, 8)).astype(np.float32)
    with pytest.warns(UserWarning):
        got = serve._binarize_export(_t(w), packed=True)
    want = jserve._binarize_export(jnp.asarray(w), packed=False)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))


def test_export_bit_and_int8_weight_match_jax():
    w = (np.random.default_rng(5).standard_normal((64, 24)) * 0.2).astype(np.float32)
    b, jb = packing.export_bit_weight(_t(w)), jpacking.export_bit_weight(jnp.asarray(w))
    np.testing.assert_array_equal(b.packed.numpy(), np.asarray(jb.packed))
    np.testing.assert_allclose(b.lam.numpy(), np.asarray(jb.lam), rtol=RTOL)
    np.testing.assert_allclose(b.dequantize().numpy(), np.asarray(jb.dequantize()), rtol=RTOL)
    assert b.nbytes == jb.nbytes
    q, jq = packing.export_int8_weight(_t(w)), jpacking.export_int8_weight(jnp.asarray(w))
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(jq.q))
    np.testing.assert_allclose(q.dequantize().numpy(), np.asarray(jq.dequantize()), rtol=RTOL)


def test_dequant_stored_layouts_match_jax():
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((3, 32, 16)) * 0.1).astype(np.float32)
    for exp in (jserve._binarize_export(jnp.asarray(w), True),
                jserve._binarize_export(jnp.asarray(w), False),
                jserve._int8_export(jnp.asarray(w))):
        port = {k: _t(np.asarray(v)) for k, v in exp.items()}
        np.testing.assert_array_equal(
            quantization._dequant_stored(port).numpy(), np.asarray(jquant._dequant_stored(exp))
        )
        assert quantization.is_packed_1bit(port) == jquant.is_packed_1bit(exp)
        assert quantization.is_stored_int8(port) == jquant.is_stored_int8(exp)
