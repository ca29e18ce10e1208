"""The port's ``BatchedServer`` (``repro_torch.train.serve``) and its
serving example.

``generate``, ``generate_stream`` and the per-token
``generate_python_loop`` agree token for token, greedy and sampled (the
loop draws from its generator in the engine's order), and the loop makes
one host transfer a token; greedy output equals JAX's ``BatchedServer``
on the same weights (reduced pquant-100m, fake-quant and the packed
export); ``examples/torch_serve_lm.py`` runs on the CPU with
``--continuous --prefix-cache`` and with ``--compare``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro.train.serve import BatchedServer as JaxServer
from repro.train.serve import SamplerConfig as JaxSampler
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.train.serve import BatchedServer, SamplerConfig, make_prefill_step, \
    make_serve_step
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
B, S, NEW = 3, 6, 7


@pytest.fixture(scope="module")
def served():
    """Reduced pquant-100m made in JAX, latent and packed, both converted,
    with JAX's greedy ``BatchedServer`` output on each."""
    jcfg = jregistry.reduced(jregistry.get_config("pquant-100m"))
    cfg = registry.reduced(registry.get_config("pquant-100m"))
    params, axes = japi.init_model(jax.random.PRNGKey(3), jcfg)
    packed, _ = jquantize(params, axes, jcfg, packed=True)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    greedy = JaxSampler(temperature=0.0, top_k=0, max_new_tokens=NEW)
    out = {}
    for name, p in (("latent", params), ("packed", packed)):
        want = np.asarray(JaxServer(p, jcfg, S + NEW + 1).generate(jnp.asarray(prompts),
                                                                     greedy))
        out[name] = (params_from_numpy(jax.tree.map(np.asarray, p), CPU), want)
    return cfg, prompts, out


@pytest.mark.parametrize("name", ["latent", "packed"])
def test_greedy_equals_jax_batched_server(served, name):
    cfg, prompts, out = served
    tparams, want = out[name]
    server = BatchedServer(tparams, cfg, S + NEW + 1, device=CPU)
    greedy = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=NEW)
    np.testing.assert_array_equal(server.generate(prompts, greedy), want)
    np.testing.assert_array_equal(server.generate_python_loop(prompts, greedy), want)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_three_paths_agree_and_the_loop_fetches_once_a_token(served, temperature):
    cfg, prompts, out = served
    server = BatchedServer(out["packed"][0], cfg, S + NEW + 1, device=CPU)
    scfg = SamplerConfig(temperature=temperature, top_k=20, max_new_tokens=NEW)
    full = server.generate(prompts, scfg, seed=5)
    assert full.shape == (B, NEW) and server.engine.host_transfers == 1
    stream = np.concatenate(list(server.generate_stream(prompts, scfg, seed=5, chunk=3)), axis=1)
    np.testing.assert_array_equal(stream, full)
    loop = server.generate_python_loop(prompts, scfg, seed=5)
    np.testing.assert_array_equal(loop, full)
    assert server.host_transfers == NEW
    if temperature:
        assert not (server.generate(prompts, scfg, seed=6) == full).all()


def test_steps_and_budget_validation(served):
    cfg, prompts, out = served
    tparams = out["latent"][0]
    server = BatchedServer(tparams, cfg, S + 2, device=CPU)
    with pytest.raises(ValueError, match="max_new_tokens"):
        server.generate_python_loop(prompts, SamplerConfig(max_new_tokens=0))
    logits, caches = make_prefill_step(cfg, S + 2)(tparams, {"tokens": torch.as_tensor(prompts)})
    tok = logits.argmax(-1)[:, None]
    step, _ = make_serve_step(cfg)(tparams, tok, caches, S)
    assert logits.shape == step.shape == (B, cfg.vocab_size)
    np.testing.assert_array_equal(
        server.generate_python_loop(prompts, SamplerConfig(temperature=0.0, max_new_tokens=2)),
        torch.stack([tok[:, 0], step.argmax(-1)], 1).numpy())


def _example():
    spec = importlib.util.spec_from_file_location("torch_serve_lm",
                                                  ROOT / "examples" / "torch_serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [["--continuous", "--prefix-cache"], ["--compare"]],
                         ids=["continuous-prefix-cache", "compare"])
def test_serving_example_runs_on_the_cpu(flags, capsys):
    assert _example().main(["--reduced", "--device", "cpu", "--new-tokens", "6",
                            "--prompt-len", "16", "--batch", "2", *flags]) == 0
    text = capsys.readouterr().out
    if "--compare" in flags:
        assert "same tokens: True" in text
    else:
        assert "repeat streams identical: True" in text and "1 CoW" in text
