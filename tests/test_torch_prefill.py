"""The port's prefill tier against the JAX package: ``w1a8_matmul``,
``decoupled_matmul`` and ``rmsnorm_quant`` (their plain versions on the
CPU), the ops dispatch above ``DECODE_M_MAX`` rows, the prefill hooks
``forward_chunk(logits_at=)`` / ``prefill(last_pos=)``, and greedy
``DecodeEngine`` streams whose forwards run the prefill tier.

The JAX side runs as its own tests run it: the Pallas kernels in interpret
mode through ``repro.kernels.ops``, and the oracles of
``repro.kernels.ref``.  Tolerances:

* integers (int8 codes, int32 accumulators) exactly;
* f32 GEMM outputs to rtol 1e-6: the plain versions keep the Pallas
  kernels' epilogue order, ``acc * (lam * (1/gamma))``, but interpreted
  Pallas may reassociate it;
* ``rmsnorm_quant`` gamma to rtol 1e-5, every code within one step and
  at most 0.1% of the codes different: the mean of squares sums in
  another order in each framework and ``rsqrt`` is not correctly rounded,
  so a value on a rounding boundary may take the neighbouring code;
* logits as in ``test_torch_decoder.py`` (within 5e-2 everywhere and 1e-5
  at the median element): a last-ulp difference ahead of a per-token int8
  quantization can move one code by one step;
* greedy token streams equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.packing import pack_signs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decoupled_matmul import decoupled_matmul as pallas_decoupled_matmul
from repro.kernels.w1a8_matmul import w1a8_matmul as pallas_w1a8_matmul
from repro.models import api as japi
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.core.quantization import fdiv, quantize_act_int8
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels.decoupled_matmul import decoupled_matmul, decoupled_matmul_plain
from repro_torch.kernels.rmsnorm_quant import rmsnorm_quant, rmsnorm_quant_plain
from repro_torch.kernels.w1a8_matmul import w1a8_matmul, w1a8_matmul_plain
from repro_torch.models import api
from repro_torch.serve.engine import DecodeEngine, SamplerConfig
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

RTOL = 1e-6
PREFILL_ROWS = [33, 40, 136]  # 136 > 128 takes upstream's bm = 128 path
CPU = torch.device("cpu")
ATOL, ATOL_FLIP = 1e-5, 5e-2
RMS_RTOL, RMS_CODE_SHARE = 1e-5, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(m, k, n, r=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :3] = [0.5, -0.5, 2.5]  # ties in the act-quant rounding
    signs = np.where(rng.random((k, n)) > 0.5, 1, -1).astype(np.int8)
    packed = np.asarray(pack_signs(jnp.asarray(signs)))
    w8 = None if r is None else rng.integers(-127, 128, (k, r)).astype(np.int8)
    return x, packed, w8


def _jdot(a, b):
    return np.asarray(jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))


# ---------------------------------------------------------------------------
# ops dispatch above DECODE_M_MAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", PREFILL_ROWS)
@pytest.mark.parametrize("k,n", [(64, 96), (256, 128)])
def test_bit_linear_infer_prefill_matches_pallas(m, k, n):
    x, packed, _ = _inputs(m, k, n, seed=m + k)
    lam = np.float32(0.042)
    _cuda.reset_launches()
    got = ops.bit_linear_infer(_t(x), _t(packed), _t(lam), out_dtype=torch.float32)
    assert sum(_cuda.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    want = jops.bit_linear_infer(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(lam),
                                 out_dtype=jnp.float32)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)
    # the integers underneath: the act-quant pass and the int32 accumulators
    xq, gamma = quantize_act_int8(_t(x))
    jxq, jgamma = jops.quantize_act_int8(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(gamma.numpy(), np.asarray(jgamma))
    acc = ref.int_matmul(xq, ref.unpack_ref(_t(packed)))
    np.testing.assert_array_equal(acc.numpy(), _jdot(jxq, jref.unpack_ref(jnp.asarray(packed))))
    # bf16, as the serving path asks for it: the f32 epilogue rounded once
    bf = ops.bit_linear_infer(_t(x), _t(packed), _t(lam))
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, got.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("m", PREFILL_ROWS)
@pytest.mark.parametrize("k,n,r", [(64, 96, 16), (128, 256, 128)])
def test_decoupled_first_gemm_prefill_matches_pallas(m, k, n, r):
    x, packed, w8 = _inputs(m, k, n, r, seed=m * r)
    sc = [np.float32(v) for v in (0.031, 1 / 0.0023, 1.7, 0.3)]
    y1, y8 = ops.decoupled_first_gemm(_t(x), _t(packed), _t(w8), *map(_t, sc),
                                      out_dtype=torch.float32)
    p1, p8 = jops.decoupled_first_gemm(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(w8),
                                       *map(jnp.asarray, sc), out_dtype=jnp.float32)
    assert y1.shape == (m, n) and y8.shape == (m, r)
    np.testing.assert_allclose(y1.numpy(), np.asarray(p1), rtol=RTOL, atol=0)
    np.testing.assert_allclose(y8.numpy(), np.asarray(p8), rtol=RTOL, atol=0)
    xq, _ = quantize_act_int8(_t(x))
    np.testing.assert_array_equal(ref.int_matmul(xq, _t(w8)).numpy(), _jdot(xq.numpy(), w8))


def test_prefill_tier_keeps_leading_dims():
    x, packed, w8 = _inputs(3 * 14, 64, 40, 8, seed=9)
    one = torch.tensor(1.0)
    x3 = _t(x).reshape(3, 14, 64)
    y = ops.bit_linear_infer(x3, _t(packed), one, out_dtype=torch.float32)
    assert y.shape == (3, 14, 40)
    torch.testing.assert_close(
        y.reshape(-1, 40), ops.bit_linear_infer(_t(x), _t(packed), one, torch.float32),
        rtol=0, atol=0)
    y1, y8 = ops.decoupled_first_gemm(x3, _t(packed), _t(w8), one, one, one, one)
    assert y1.shape == (3, 14, 40) and y8.shape == (3, 14, 8)


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels and repro.kernels.ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(40, 64, 32), (136, 256, 128)])
def test_w1a8_matmul_plain_matches_pallas_and_ref(m, k, n):
    x, packed, _ = _inputs(m, k, n, seed=k + n)
    lam = np.float32(0.037)
    xq, gamma = quantize_act_int8(_t(x))
    got = w1a8_matmul(xq, _t(packed), gamma, _t(lam))
    np.testing.assert_array_equal(got.numpy(), w1a8_matmul_plain(xq, _t(packed), gamma,
                                                                 _t(lam)).numpy())
    # the interpreted Pallas kernel on shapes that tile evenly (bm = 8)
    pallas = pallas_w1a8_matmul(jnp.asarray(xq.numpy()), jnp.asarray(packed),
                                jnp.asarray(gamma.numpy()), jnp.asarray(lam), bm=8,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL, atol=0)
    want = jref.w1a8_matmul_ref(jnp.asarray(xq.numpy()), jnp.asarray(packed),
                                jnp.asarray(gamma.numpy()), jnp.asarray(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)
    port_ref = ref.w1a8_matmul_ref(xq, _t(packed), gamma, _t(lam))
    np.testing.assert_array_equal(port_ref.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n,r", [(40, 64, 32, 16), (136, 256, 128, 64)])
def test_decoupled_matmul_plain_matches_pallas_and_ref(m, k, n, r):
    x, packed, w8 = _inputs(m, k, n, r, seed=r)
    sc = [np.float32(v) for v in (0.029, 1 / 0.0017, 1.4, 0.45)]
    xq, gamma = quantize_act_int8(_t(x))
    y1, y8 = decoupled_matmul(xq, _t(packed), _t(w8), gamma, *map(_t, sc))
    pallas = pallas_decoupled_matmul(jnp.asarray(xq.numpy()), jnp.asarray(packed),
                                     jnp.asarray(w8), jnp.asarray(gamma.numpy()),
                                     *map(jnp.asarray, sc), bm=8, interpret=True)
    want = jref.decoupled_matmul_ref(jnp.asarray(xq.numpy()), jnp.asarray(packed),
                                     jnp.asarray(w8), jnp.asarray(gamma.numpy()),
                                     *map(jnp.asarray, sc))
    for got, p, w in zip((y1, y8), pallas, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(p), rtol=RTOL, atol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=RTOL, atol=0)
    r1, r8 = ref.decoupled_matmul_ref(xq, _t(packed), _t(w8), gamma, *map(_t, sc))
    np.testing.assert_array_equal(r1.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(r8.numpy(), np.asarray(want[1]))
    # bf16 out is the f32 epilogue rounded once, in both branches
    b1, b8 = decoupled_matmul_plain(xq, _t(packed), _t(w8), gamma, *map(_t, sc),
                                    out_dtype=torch.bfloat16)
    torch.testing.assert_close(b1, y1.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(b8, y8.to(torch.bfloat16), rtol=0, atol=0)


def test_prefill_epilogue_follows_upstream_order():
    """The prefill tier divides once, 1/gamma, and scales by lam * that:
    on a row where the two orders round apart, the port takes the Pallas
    kernel's."""
    m, k, n = 40, 64, 16
    x, packed, _ = _inputs(m, k, n, seed=5)
    xq, gamma = quantize_act_int8(_t(x))
    lam = torch.tensor(0.0371)
    acc = ref.int_matmul(xq, ref.unpack_ref(_t(packed))).float()
    prefill_order = acc * (lam * fdiv(1.0, gamma))[:, None]
    assert not torch.equal(prefill_order, acc * fdiv(lam, gamma)[:, None])  # the orders differ here
    got = w1a8_matmul(xq, _t(packed), gamma, lam)
    torch.testing.assert_close(got, prefill_order, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# rmsnorm_quant
# ---------------------------------------------------------------------------


def _assert_codes_close(q, jq, g, jg):
    np.testing.assert_allclose(g, jg, rtol=RMS_RTOL, atol=0)
    diff = np.abs(q.astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= RMS_CODE_SHARE


@pytest.mark.parametrize("lead,d", [((40,), 256), ((3, 5), 128), ((300,), 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rmsnorm_quant_matches_jax(lead, d, dtype):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal(lead + (d,)) * 3).astype(np.float32)
    scale = (rng.random(d) + 0.5).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(tx.float().numpy(), np.asarray(jx.astype(jnp.float32)))
    q, g = ops.fused_rmsnorm_quant(tx, _t(scale))
    jq, jg = jops.fused_rmsnorm_quant(jx, jnp.asarray(scale))
    assert q.shape == lead + (d,) and q.dtype == torch.int8
    assert g.shape == lead and g.dtype == torch.float32
    _assert_codes_close(q.numpy(), jq, g.numpy(), jg)
    rq, rg = jref.rmsnorm_quant_ref(jx.reshape(-1, d), jnp.asarray(scale))
    _assert_codes_close(q.reshape(-1, d).numpy(), rq, g.reshape(-1).numpy(), rg)


def test_rmsnorm_quant_wrapper_runs_plain_on_cpu():
    x = torch.randn(6, 32)
    s = torch.rand(32) + 0.5
    _cuda.reset_launches()
    q, g = rmsnorm_quant(x, s)
    assert sum(_cuda.LAUNCHES.values()) == 0
    rq, rg = rmsnorm_quant_plain(x, s)
    assert torch.equal(q, rq) and torch.equal(g, rg)
    assert q.abs().max() == 127  # each row's AbsMax element maps to the rail


# ---------------------------------------------------------------------------
# The prefill hooks and the engine on the reduced configs
# ---------------------------------------------------------------------------


def _assert_logits_close(got, want):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert err.max() <= ATOL_FLIP, err.max()
    assert np.median(err) <= ATOL, np.median(err)


@pytest.fixture(scope="module", params=["pquant", "bitnet"])
def served(request):
    jcfg = jregistry.reduced(jregistry.get_config("pquant-100m", quant_mode=request.param))
    cfg = registry.reduced(registry.get_config("pquant-100m", quant_mode=request.param))
    params, axes = japi.init_model(jax.random.PRNGKey(13), jcfg)
    qparams, _ = jquantize(params, axes, jcfg, packed=True)
    tq = params_from_numpy(jax.tree.map(np.asarray, qparams), CPU)
    return jcfg, cfg, qparams, tq


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_forward_chunk_logits_at_matches_jax(served):
    jcfg, cfg, qparams, tq = served
    toks = _tokens(3, 12, cfg.vocab_size, seed=21)  # 36 rows: the prefill tier
    at = np.array([11, 3, 7], np.int32)
    jcache, _ = japi.init_cache(jcfg, 3, 16, jnp.float32)
    jl, _ = japi.forward_chunk(qparams, jnp.asarray(toks), jcache, jnp.asarray(0, jnp.int32),
                               jcfg, logits_at=jnp.asarray(at))
    tl, _ = api.forward_chunk(tq, torch.from_numpy(toks).long(),
                              api.init_cache(cfg, 3, 16, torch.float32, device=CPU), 0, cfg,
                              logits_at=torch.from_numpy(at))
    assert tl.shape == (3, cfg.vocab_size)
    _assert_logits_close(tl.numpy(), jl)
    full, _ = api.forward_chunk(tq, torch.from_numpy(toks).long(),
                                api.init_cache(cfg, 3, 16, torch.float32, device=CPU), 0, cfg)
    torch.testing.assert_close(tl, full[torch.arange(3), torch.from_numpy(at).long()],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("last_pos", [13, 20])
def test_prefill_last_pos_matches_jax(served, last_pos):
    jcfg, cfg, qparams, tq = served
    toks = _tokens(2, 20, cfg.vocab_size, seed=22)  # 40 rows: the prefill tier
    jl, _ = japi.prefill(qparams, {"tokens": jnp.asarray(toks)}, jcfg, 24,
                         jnp.asarray(last_pos, jnp.int32))
    tl, _ = api.prefill(tq, {"tokens": torch.from_numpy(toks).long()}, cfg, 24,
                        last_pos=torch.tensor(last_pos))
    assert tl.shape == (2, cfg.vocab_size)
    _assert_logits_close(tl.numpy(), jl)
    # causal masking: the padded prompt's logits at last_pos - 1 are the
    # exact-length prompt's last ones (2 x 13 = 26 rows run the decode
    # tier, whose epilogue rounds in another order: a code may flip)
    exact, _ = api.prefill(tq, {"tokens": torch.from_numpy(toks[:, :last_pos]).long()}, cfg, 24)
    _assert_logits_close(tl.numpy(), exact.numpy())
    as_int, _ = api.prefill(tq, {"tokens": torch.from_numpy(toks).long()}, cfg, 24,
                            last_pos=last_pos)
    torch.testing.assert_close(as_int, tl, rtol=0, atol=0)


@pytest.mark.parametrize("batch,prompt", [(2, 24), (36, 4)])
def test_greedy_stream_equals_jax_on_prefill_tier(served, batch, prompt):
    """2 x 24: 48 prefill rows, then decode at 2 (the GEMV tier); 36 x 4:
    144 prefill rows, then decode at 36 rows — the prefill tier in every
    forward."""
    jcfg, cfg, qparams, tq = served
    new = 6
    prompts = _tokens(batch, prompt, cfg.vocab_size, seed=batch)
    want = JaxEngine(qparams, jcfg, max_len=prompt + new).generate(
        jnp.asarray(prompts), JaxSampler(temperature=0.0, top_k=0, max_new_tokens=new))
    eng = DecodeEngine(tq, cfg, max_len=prompt + new, device=CPU)
    _cuda.reset_launches()
    got = eng.generate(prompts, SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=new))
    assert got.shape == (batch, new)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.host_transfers == 1
    assert sum(_cuda.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# On the card (skip without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [33, 300])
def test_cuda_rmsnorm_quant_within_tolerance(cuda_device, m):
    rng = np.random.default_rng(m)
    x = _t((rng.standard_normal((m, 512)) * 3).astype(np.float32)).to(cuda_device)
    s = _t((rng.random(512) + 0.5).astype(np.float32)).to(cuda_device)
    before = _cuda.LAUNCHES["rmsnorm_quant"]
    q, g = ops.fused_rmsnorm_quant(x.to(torch.bfloat16), s)
    assert _cuda.LAUNCHES["rmsnorm_quant"] == before + 1
    rq, rg = rmsnorm_quant_plain(x.to(torch.bfloat16), s)
    _assert_codes_close(q.cpu().numpy(), rq.cpu().numpy(), g.cpu().numpy(), rg.cpu().numpy())
