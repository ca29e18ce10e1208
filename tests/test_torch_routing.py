"""The port's sort-based top-k dispatch (``repro_torch.core.routing``)
against ``repro.core.routing`` on the CPU, on numpy-seeded inputs.

Tolerances: the integers (``expert_index``, ``buffer_token``,
``buffer_slot``, the capacity) exactly equal; the combine weights, the aux
loss and the z-loss within FLOAT_TOL (f32 sums in another order); the
outputs and the gradients of ``route_and_apply`` with respect to x and the
router weight within GRAD_RTOL of each one's largest element.  The inputs
make no near-tie between the two largest router logits of any token, so
that both frameworks choose alike (a choice decided two ways is the
replay's business: ``tests/test_torch_experts.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import routing as jrouting
from repro.telemetry import probes as jprobes
from repro_torch.core import routing
from repro_torch.telemetry import probes

FLOAT_TOL = 1e-6
GRAD_RTOL = 1e-5


def _probs(t, n, seed, skew=0.0):
    """Softmax of numpy-seeded logits (T, N) in f32; ``skew`` tilts every
    token toward expert 0, so that it overflows its capacity."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, n)).astype(np.float32) * 2.0
    logits[:, 0] += skew
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _dispatch_both(probs, cfg):
    jcfg = jrouting.RouterConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    want = jrouting.topk_dispatch(jnp.asarray(probs), jcfg)
    got = routing.topk_dispatch(torch.from_numpy(probs), cfg)
    return got, want


def _assert_dispatch_equal(got, want):
    assert got["capacity"] == want["capacity"]
    for k in ("expert_index", "buffer_token", "buffer_slot"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["combine_weight"].numpy(), np.asarray(want["combine_weight"]),
                               rtol=0, atol=FLOAT_TOL)
    assert abs(got["aux_loss"].item() - float(want["aux_loss"])) <= FLOAT_TOL


def _drops(d):
    return int((np.asarray(d["buffer_slot"]) == d["capacity"]).sum())


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", ["no_drops", "drops"])
def test_topk_dispatch_matches_jax(n, case):
    """Integers exactly upstream's, with and without capacity drops (a
    small capacity factor and a skew toward expert 0 force drops)."""
    if case == "drops":
        cfg = routing.RouterConfig(num_experts=n, capacity_factor=0.5)
        probs = _probs(96, n, seed=n, skew=1.5)
    else:
        cfg = routing.RouterConfig(num_experts=n, capacity_factor=float(n))
        probs = _probs(40, n, seed=n)
    got, want = _dispatch_both(probs, cfg)
    _assert_dispatch_equal(got, want)
    dropped = _drops(want)
    assert (dropped > 0) == (case == "drops"), dropped
    assert _drops(got) == dropped
    # every kept token sits in its expert's buffer at its slot, in token order
    bt, ei, bs = (got[k].numpy() for k in ("buffer_token", "expert_index", "buffer_slot"))
    for tok in range(probs.shape[0]):
        if bs[tok, 0] < got["capacity"]:
            assert bt[ei[tok, 0], bs[tok, 0]] == tok


@pytest.mark.parametrize("n", [2, 4, 8])
def test_uniform_rows_take_the_lowest_expert(n):
    """Equal probabilities (a zero row of x, or an all-equal router) go to
    expert 0, as ``jax.lax.top_k`` decides a tie, and the ties of a row
    between two later experts go to the lower one."""
    probs = _probs(24, n, seed=3)
    probs[0] = 1.0 / n
    probs[5] = 1.0 / n
    if n > 2:
        probs[7] = 0.0
        probs[7, 1] = probs[7, 2] = 0.5
    got, want = _dispatch_both(probs, routing.RouterConfig(num_experts=n))
    _assert_dispatch_equal(got, want)
    ei = got["expert_index"].numpy()[:, 0]
    assert ei[0] == ei[5] == 0
    if n > 2:
        assert ei[7] == 1
    # the router itself: a zero row of x gives uniform probabilities
    x = np.zeros((4, 16), np.float32)
    w = np.random.default_rng(0).standard_normal((16, n)).astype(np.float32)
    p, _ = routing.router_probs({"w": torch.from_numpy(w)}, torch.from_numpy(x))
    assert (routing.topk_dispatch(p, routing.RouterConfig(num_experts=n))["expert_index"] == 0).all()


@pytest.mark.parametrize("t,n,cf", [(1, 2, 1.25), (7, 4, 1.25), (64, 8, 1.25), (8192, 8, 1.25),
                                    (100, 3, 2.0), (33, 8, 0.5)])
def test_expert_capacity_matches_jax(t, n, cf):
    cfg = routing.RouterConfig(num_experts=n, capacity_factor=cf)
    jcfg = jrouting.RouterConfig(num_experts=n, capacity_factor=cf)
    assert routing.expert_capacity(t, cfg) == jrouting.expert_capacity(t, jcfg)
    assert routing.expert_capacity(8192, routing.RouterConfig(num_experts=8)) == 1280


def test_top_k_above_one_matches_lax_top_k():
    """The port's top-k (argmax by turns) against ``jax.lax.top_k``: values
    in descending order, ties to the lowest index."""
    probs = _probs(32, 8, seed=4)
    probs[3] = 0.125
    probs[9, 2] = probs[9, 5] = probs[9].max() + 0.1
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = routing._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    cfg = routing.RouterConfig(num_experts=8, top_k=2, capacity_factor=0.75)
    got, want = _dispatch_both(probs, cfg)
    _assert_dispatch_equal(got, want)


def test_gather_and_combine_match_jax():
    n, d = 4, 12
    probs = _probs(50, n, seed=5, skew=2.0)
    cfg = routing.RouterConfig(num_experts=n, capacity_factor=0.25)
    got, want = _dispatch_both(probs, cfg)
    assert _drops(want) > 0
    x = np.random.default_rng(6).standard_normal((50, d)).astype(np.float32)
    xe = routing.dispatch_gather(torch.from_numpy(x), got)
    jxe = jrouting.dispatch_gather(jnp.asarray(x), want)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(jxe))
    ye = np.random.default_rng(7).standard_normal(xe.shape).astype(np.float32)
    y = routing.combine_scatter(torch.from_numpy(ye), got, 50)
    jy = jrouting.combine_scatter(jnp.asarray(ye), want, 50)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=FLOAT_TOL)
    # a dropped token gets nothing from the routed branch
    dropped = got["buffer_slot"][:, 0] == got["capacity"]
    assert (y[dropped] == 0).all()


def _expert_fns(n, d, e, seed):
    """A batched expert: a per-expert matmul and a SiLU, in both frameworks."""
    w = np.random.default_rng(seed).standard_normal((n, d, e)).astype(np.float32) * d**-0.5
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    return (lambda xe: jax.nn.silu(jnp.einsum("ncd,nde->nce", xe, jw)),
            lambda xe: torch.nn.functional.silu(torch.einsum("ncd,nde->nce", xe, tw)))


def _route_case(n, t=48, d=16, e=20, cf=1.25, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((d, n)).astype(np.float32) * d**-0.5 * 3.0
    cfg = routing.RouterConfig(num_experts=n, capacity_factor=cf)
    jcfg = jrouting.RouterConfig(num_experts=n, capacity_factor=cf)
    jfn, tfn = _expert_fns(n, d, e, seed + 1)
    cot = rng.standard_normal((t, e)).astype(np.float32)
    return x, w, cfg, jcfg, jfn, tfn, cot


def _gap_ok(x, w):
    """The smallest gap between a token's two largest router logits: far
    above the frameworks' f32 noise, so that both choose alike."""
    top2 = np.sort(x @ w, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]).min() > 1e-4


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_route_and_apply_and_gradients_match_jax(n, cf):
    """Outputs, aux (with the z-loss) and the gradients of an objective of
    both with respect to x and the router weight, against ``jax.grad``."""
    x, w, cfg, jcfg, jfn, tfn, cot = _route_case(n, cf=cf, seed=n)
    assert _gap_ok(x, w)

    def jobj(x, w):
        y, aux = jrouting.route_and_apply({"w": w}, x, jcfg, jfn)
        return jnp.sum(y * cot) + 10.0 * aux, (y, aux)

    (jval, (jy, jaux)), (jgx, jgw) = jax.value_and_grad(jobj, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y, aux = routing.route_and_apply({"w": tw}, tx, cfg, tfn)
    val = torch.sum(y * torch.from_numpy(cot)) + 10.0 * aux
    gx, gw = torch.autograd.grad(val, (tx, tw))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=GRAD_RTOL * np.abs(np.asarray(jy)).max())
    assert abs(aux.item() - float(jaux)) <= FLOAT_TOL
    for g, jg in ((gx, jgx), (gw, jgw)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=GRAD_RTOL * np.abs(jg).max())
    # the z-loss alone
    _, logits = routing.router_probs({"w": torch.from_numpy(w)}, torch.from_numpy(x))
    z = torch.mean(torch.square(torch.logsumexp(logits, -1))) * cfg.router_z_weight
    jz = jnp.mean(jax.nn.logsumexp(jnp.asarray(x) @ jnp.asarray(w), -1) ** 2) * 1e-3
    assert abs(z.item() - float(jz)) <= FLOAT_TOL


def test_route_and_apply_in_bf16_matches_jax():
    """bf16 rows (the training forward): the router runs in f32 on the
    bf16-cast weight, the combine weight is cast to bf16 before the
    multiply, as upstream."""
    n = 4
    x, w, cfg, jcfg, _, _, _ = _route_case(n, seed=11)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    assert _gap_ok(xb.float().numpy(), wb.float().numpy())
    ident = (lambda xe: xe)
    y, aux = routing.route_and_apply({"w": wb}, xb, cfg, ident)
    jy, jaux = jrouting.route_and_apply({"w": jnp.asarray(w).astype(jnp.bfloat16)},
                                        jnp.asarray(x).astype(jnp.bfloat16), jcfg, ident)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(jy.astype(jnp.float32)))
    assert abs(aux.item() - float(jaux)) <= FLOAT_TOL


@pytest.mark.parametrize("n", [2, 8])
def test_router_entropy_tap_matches_jax(n):
    probs = _probs(64, n, seed=12, skew=0.7)
    cfg = routing.RouterConfig(num_experts=n)
    jcfg = jrouting.RouterConfig(num_experts=n)
    with jprobes.collect():
        jrouting.topk_dispatch(jnp.asarray(probs), jcfg)
        jrouting.topk_dispatch(jnp.asarray(probs[:32]), jcfg)
        want = jprobes.summaries()
    with probes.collect():
        routing.topk_dispatch(torch.from_numpy(probs), cfg)
        routing.topk_dispatch(torch.from_numpy(probs[:32]), cfg)
        got = probes.summaries()
    ent = got["qat_router_entropy"].item()
    assert 0.0 <= ent <= 1.0
    np.testing.assert_allclose(ent, float(want["qat_router_entropy"]), rtol=FLOAT_TOL)
    # outside collect(): no tap
    assert not probes.active()
    routing.topk_dispatch(torch.from_numpy(probs), cfg)
    assert probes.summaries() == {}


def test_dispatch_runs_no_host_sync_op(monkeypatch):
    """The dispatch reads nothing back to the host: no ``.item()``,
    ``nonzero`` or boolean-mask indexing (each would sync on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    x, w, cfg, _, _, tfn, _ = _route_case(8, cf=0.5, seed=13)
    with Ops():
        routing.route_and_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x), cfg, tfn)
    bad = [op for op in seen if any(s in op for s in ("item", "nonzero", "_local_scalar",
                                                     "masked_select", "index.Tensor"))]
    assert not bad, bad
