"""The port's ``DecodeEngine`` against the JAX engine on packed reduced
pQuant weights (made in JAX, converted leaf for leaf): greedy streams must
be equal token for token, each ``generate`` makes one device->host
transfer, and ``generate_stream``'s chunks concatenate to ``generate``.
Sampled decoding cannot match JAX's threefry bits, so it is held to its
distribution only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import _cuda
from repro_torch.serve.engine import DecodeEngine, SamplerConfig, sample_token
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
MAX_LEN = 24
NEW = 10


@pytest.fixture(scope="module", params=["pquant", "bitnet"])
def served(request):
    jcfg = jregistry.reduced(jregistry.get_config("pquant-100m", quant_mode=request.param))
    cfg = registry.reduced(registry.get_config("pquant-100m", quant_mode=request.param))
    params, axes = japi.init_model(jax.random.PRNGKey(11), jcfg)
    qparams, _ = jquantize(params, axes, jcfg, packed=True)
    tq = params_from_numpy(jax.tree.map(np.asarray, qparams), CPU)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    return jcfg, cfg, qparams, tq, prompts


def _greedy(n=NEW, **kw):
    return SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=n, **kw)


def test_greedy_stream_equals_jax(served):
    jcfg, cfg, qparams, tq, prompts = served
    want = JaxEngine(qparams, jcfg, max_len=MAX_LEN).generate(
        jnp.asarray(prompts), JaxSampler(temperature=0.0, top_k=0, max_new_tokens=NEW)
    )
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    _cuda.reset_launches()
    got = eng.generate(prompts, _greedy())
    assert got.shape == (2, NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.host_transfers == 1
    assert sum(_cuda.LAUNCHES.values()) == 0  # CPU tensors: plain versions only


def test_one_host_transfer_per_generate(served):
    _, cfg, _, tq, prompts = served
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    first = eng.generate(prompts, _greedy())
    second = eng.generate(prompts, _greedy())
    assert eng.host_transfers == 2
    np.testing.assert_array_equal(first, second)


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_stream_chunks_concatenate_to_generate(served, chunk):
    _, cfg, _, tq, prompts = served
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    full = eng.generate(prompts, _greedy())
    before = eng.host_transfers
    parts = list(eng.generate_stream(prompts, _greedy(), chunk=chunk))
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), full)
    assert eng.host_transfers - before == len(parts) == -(-(NEW - 1) // chunk)


def test_stream_exits_once_every_sequence_stopped(served):
    _, cfg, _, tq, prompts = served
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    full = eng.generate(prompts, _greedy())
    # stop on whatever each sequence emits at step 3
    scfg = _greedy(stop_tokens=tuple(int(t) for t in full[:, 3]))
    parts = list(eng.generate_stream(prompts, scfg, chunk=2))
    got = np.concatenate(parts, axis=1)
    assert got.shape[1] < NEW
    np.testing.assert_array_equal(got, full[:, : got.shape[1]])


def test_single_token_budget_and_bad_budgets(served):
    _, cfg, _, tq, prompts = served
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    one = eng.generate(prompts, _greedy(1))
    np.testing.assert_array_equal(one, eng.generate(prompts, _greedy())[:, :1])
    np.testing.assert_array_equal(np.concatenate(list(eng.generate_stream(prompts, _greedy(1))), 1), one)
    with pytest.raises(ValueError):
        eng.generate(prompts, _greedy(0))
    with pytest.raises(ValueError):
        next(eng.generate_stream(prompts, _greedy(), chunk=0))


def test_sampled_tokens_follow_the_top_k_softmax():
    """20000 draws of one (V=8) row: frequencies within 0.015 of the top-k
    softmax at the sampler's temperature, and nothing outside the top k."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 3.0, -1.0, 0.0, 2.5, -2.0]])
    scfg = SamplerConfig(temperature=0.8, top_k=4)
    gen = torch.Generator().manual_seed(0)
    draws = sample_token(gen, logits.expand(20000, -1), scfg)
    freq = np.bincount(draws.numpy(), minlength=8) / draws.numel()
    top = torch.topk(logits[0], 4).indices
    want = torch.zeros(8)
    want[top] = torch.softmax(logits[0, top] / 0.8, dim=0)
    assert np.abs(freq - want.numpy()).max() < 0.015
    assert freq[[i for i in range(8) if i not in top.tolist()]].sum() == 0


def test_sampled_engine_is_seeded(served):
    _, cfg, _, tq, prompts = served
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    scfg = SamplerConfig(temperature=1.0, top_k=20, max_new_tokens=NEW)
    a, b = eng.generate(prompts, scfg, seed=3), eng.generate(prompts, scfg, seed=3)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
