"""The port's decode-tier kernels (``w1a8_gemv``, ``decoupled_gemv``,
``int8_matmul``) against the JAX package: the Pallas kernels run in
interpret mode through ``repro.kernels.ops`` (as ``tests/test_gemv.py``
runs them), and the plain oracles of ``repro.kernels.ref``; the GEMVs
with x and the output each in float32 and bfloat16.  The prefill tier
above ``DECODE_M_MAX`` rows has its own file, ``test_torch_prefill.py``;
here it is checked only where the two tiers meet (the dispatch on the
CPU) and on the card (``int8_matmul``, ``w1a8_matmul`` and
``decoupled_matmul`` against their plain versions at every route;
``test_torch_decoupled_matmul.py`` emulates the wgmma route of
``decoupled_matmul`` on the CPU).

On the CPU every wrapper runs its plain PyTorch version.  Integer results
(int8 codes, int32 accumulators) must be exactly equal.  The f32 outputs
agree to f32 rounding (rtol 1e-6): the plain versions keep the Pallas
kernels' epilogue order, ``acc * (lam / gamma)``, but XLA may reassociate
it (the interpreted kernel then rounds like ``acc * lam / gamma``, which
is also ``repro.kernels.ref``'s order).  The CUDA kernels themselves run
only on the card, where they must equal their plain versions exactly: the
tests marked ``cuda`` skip elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_signs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.quantization import fdiv, quantize_act_int8
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels.decoupled_matmul import (
    decoupled_matmul,
    decoupled_matmul_plain,
    decoupled_matmul_route,
)
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain, int8_matmul_route
from repro_torch.kernels.w1a8_gemv import (
    decoupled_gemv,
    decoupled_gemv_plain,
    w1a8_gemv,
    w1a8_gemv_plain,
)
from repro_torch.kernels.w1a8_matmul import w1a8_matmul, w1a8_matmul_plain, w1a8_matmul_route
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

RTOL = 1e-6
ROWS = [1, 5, 8, 32]
# the decode GEMVs also at 16 and 17 rows (the edge of the card kernel's
# tiles of 8 token rows, and the continuous-batching path's 16 slots)
GEMV_ROWS = ROWS + [16, 17]


def _inputs(m, k, n, r=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :3] = [0.5, -0.5, 2.5]  # exercise ties in the act-quant rounding
    signs = np.where(rng.random((k, n)) > 0.5, 1, -1).astype(np.int8)
    packed = np.asarray(pack_signs(jnp.asarray(signs)))
    w8 = None if r is None else rng.integers(-127, 128, (k, r)).astype(np.int8)
    return x, packed, w8


def _scalar(v):
    return np.float32(v)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(a):
    """One bf16 ulp at each value of the float array a (8 significant bits)."""
    _, e = np.frexp(a.astype(np.float32))
    return np.ldexp(np.float32(1), e - 8)


def _typed(x, x_dtype):
    """x as both packages get it: (torch tensor, jax array) of x_dtype
    holding the same values (bf16 rounds once, in torch)."""
    xt = _t(x).to(getattr(torch, x_dtype))
    return xt, jnp.asarray(xt.float().numpy()).astype(getattr(jnp, x_dtype))


def _assert_matches(got, theirs, out_dtype):
    """f32 within RTOL; bf16 within one bf16 ulp (the interpreted kernel may
    round the f32 epilogue one ulp apart, across a bf16 boundary)."""
    got_f, theirs = got.float().numpy(), np.asarray(theirs).astype(np.float32)
    if out_dtype == "float32":
        np.testing.assert_allclose(got_f, theirs, rtol=RTOL, atol=0)
    else:
        assert np.all(np.abs(got_f - theirs) <= np.maximum(_bf16_ulp(got_f), _bf16_ulp(theirs)))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", GEMV_ROWS)
@pytest.mark.parametrize("k,n", [(64, 96), (256, 128)])
def test_w1a8_gemv_matches_pallas_and_ref(m, k, n, x_dtype, out_dtype):
    """x in f32 or bf16 (read in its own type, as upstream's kernel reads
    it), the output written in out_dtype, against the interpreted Pallas
    kernel with the same types; bf16 output equal bit for bit to the
    port's own f32 output rounded to bf16."""
    x, packed, _ = _inputs(m, k, n, seed=m + k)
    xt, jx = _typed(x, x_dtype)
    x = xt.float().numpy()  # the values both packages quantize
    lam = _scalar(0.042)
    tdt, jdt = getattr(torch, out_dtype), getattr(jnp, out_dtype)
    got = ops.bit_linear_infer(xt, _t(packed), _t(lam), out_dtype=tdt)
    pallas = jops.bit_linear_infer(jx, jnp.asarray(packed), jnp.asarray(lam), out_dtype=jdt)
    assert got.shape == (m, n) and got.dtype == tdt
    _assert_matches(got, pallas, out_dtype)
    want = jref.w1a8_gemv_ref(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(lam))
    _assert_matches(got, want, out_dtype)
    f32 = w1a8_gemv(xt, _t(packed), _t(lam))
    np.testing.assert_array_equal(got.float().numpy(), f32.to(tdt).float().numpy())
    port_ref = ref.w1a8_gemv_ref(_t(x), _t(packed), _t(lam))
    np.testing.assert_array_equal(port_ref.numpy(), np.asarray(want))
    # the integers underneath: act-quant codes and int32 accumulators
    xq, gamma = ref.quantize_act_ref(xt)
    jxq, jgamma = jref.quantize_act_ref(jx)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(gamma.numpy(), np.asarray(jgamma))
    acc = ref.int_matmul(xq, ref.unpack_ref(_t(packed)))
    jacc = jax.lax.dot_general(jxq, jref.unpack_ref(jnp.asarray(packed)), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", GEMV_ROWS)
@pytest.mark.parametrize("k,n,r", [(64, 96, 16), (128, 256, 128)])
def test_decoupled_gemv_matches_pallas_and_ref(m, k, n, r, x_dtype, out_dtype):
    """As the W1A8 GEMV's test, for both branches of the dual GEMV."""
    x, packed, w8 = _inputs(m, k, n, r, seed=m * r)
    xt, jx = _typed(x, x_dtype)
    x = xt.float().numpy()
    sc = [_scalar(v) for v in (0.031, 1 / 0.0023, 1.7, 0.3)]
    tdt, jdt = getattr(torch, out_dtype), getattr(jnp, out_dtype)
    y1, y8 = ops.decoupled_first_gemm(xt, _t(packed), _t(w8), *map(_t, sc), out_dtype=tdt)
    p1, p8 = jops.decoupled_first_gemm(jx, jnp.asarray(packed), jnp.asarray(w8),
                                       *map(jnp.asarray, sc), out_dtype=jdt)
    assert y1.shape == (m, n) and y8.shape == (m, r)
    assert y1.dtype == y8.dtype == tdt
    _assert_matches(y1, p1, out_dtype)
    _assert_matches(y8, p8, out_dtype)
    w1, w8r = jref.decoupled_gemv_ref(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(w8),
                                      *map(jnp.asarray, sc))
    _assert_matches(y1, w1, out_dtype)
    _assert_matches(y8, w8r, out_dtype)
    for got, f32 in zip((y1, y8), decoupled_gemv(xt, _t(packed), _t(w8), *map(_t, sc))):
        np.testing.assert_array_equal(got.float().numpy(), f32.to(tdt).float().numpy())
    r1, r8 = ref.decoupled_gemv_ref(_t(x), _t(packed), _t(w8), *map(_t, sc))
    np.testing.assert_array_equal(r1.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(r8.numpy(), np.asarray(w8r))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", ROWS + [40, 129])
def test_int8_matmul_matches_pallas_and_ref(m, out_dtype):
    """f32 within RTOL of the interpreted Pallas kernel and of
    ``int8_matmul_ref`` (which divides where the kernels multiply by a
    reciprocal); bf16 equal bit for bit to the port's own f32 result
    rounded to bf16, and within one bf16 ulp of JAX's: the interpreted
    kernel may round the f32 epilogue one ulp apart, and that ulp can cross
    a bf16 rounding boundary."""
    rng = np.random.default_rng(m)
    k, n = 48, 64
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    wscale = _scalar(1 / 0.0031)
    tdt, jdt = getattr(torch, out_dtype), getattr(jnp, out_dtype)
    got = ops.int8_linear_infer(_t(x), _t(w), _t(wscale), out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (m, n)
    pallas = jops.int8_linear_infer(jnp.asarray(x), jnp.asarray(w), jnp.asarray(wscale),
                                    out_dtype=jdt)
    xq, gamma = jops.quantize_act_int8(jnp.asarray(x))
    want = jref.int8_matmul_ref(xq, jnp.asarray(w), gamma, jnp.asarray(wscale), out_dtype=jdt)
    got_f = got.float().numpy()
    for theirs in (pallas, want):
        theirs = np.asarray(theirs).astype(np.float32)
        if out_dtype == "float32":
            np.testing.assert_allclose(got_f, theirs, rtol=RTOL, atol=0)
        else:
            ulp = np.maximum(_bf16_ulp(got_f), _bf16_ulp(theirs))
            assert np.all(np.abs(got_f - theirs) <= ulp)
    direct = int8_matmul(_t(xq), _t(w), _t(gamma), _t(wscale), tdt)
    np.testing.assert_array_equal(direct.float().numpy(), got_f)
    f32 = int8_matmul(_t(xq), _t(w), _t(gamma), _t(wscale))
    np.testing.assert_array_equal(got_f, f32.to(tdt).float().numpy())


def test_port_ref_matches_jax_ref():
    x, packed, w8 = _inputs(6, 64, 40, 24, seed=4)
    np.testing.assert_array_equal(ref.unpack_ref(_t(packed)).numpy(),
                                  np.asarray(jref.unpack_ref(jnp.asarray(packed))))
    q, g = ref.quantize_act_ref(_t(x))
    jq, jg = jref.quantize_act_ref(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    y = ref.int8_matmul_ref(q, _t(w8), g, torch.tensor(7.5))
    jy = jref.int8_matmul_ref(jq, jnp.asarray(w8), jg, jnp.asarray(np.float32(7.5)))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_cpu_plain_versions_touch_no_launch_counter():
    _cuda.reset_launches()
    x, packed, w8 = _inputs(4, 64, 32, 16, seed=1)
    one = torch.tensor(1.0)
    w1a8_gemv(_t(x), _t(packed), one)
    decoupled_gemv(_t(x), _t(packed), _t(w8), one, one, one, one)
    q, g = ref.quantize_act_ref(_t(x))
    int8_matmul(q, _t(w8), g, one)
    ops.bit_linear_infer(_t(x), _t(packed), one)
    assert sum(_cuda.LAUNCHES.values()) == 0


def test_cpu_dispatch_above_decode_tier_runs_plain_version():
    """On the CPU, M > DECODE_M_MAX runs the prefill tier's plain version:
    the act-quant pass, then upstream's prefill epilogue ``acc * (lam *
    (1/gamma))`` (the decode tier computes ``acc * (lam / gamma)``)."""
    m = ops.DECODE_M_MAX + 8
    x, packed, _ = _inputs(m, 64, 48, seed=2)
    lam = _scalar(0.05)
    got = ops.bit_linear_infer(_t(x), _t(packed), _t(lam), out_dtype=torch.float32)
    want = jops.bit_linear_infer(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(lam),
                                 out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)
    xq, gamma = quantize_act_int8(_t(x))
    acc = ref.int_matmul(xq, ref.unpack_ref(_t(packed))).float()
    prefill_order = acc * (_t(lam) * fdiv(1.0, gamma))[:, None]
    np.testing.assert_array_equal(got.numpy(), prefill_order.numpy())


def test_zero_rows_stay_finite():
    x = np.zeros((3, 64), np.float32)
    _, packed, w8 = _inputs(3, 64, 32, 16)
    one = torch.tensor(1.0)
    y = w1a8_gemv(_t(x), _t(packed), one)
    y1, y8 = decoupled_gemv(_t(x), _t(packed), _t(w8), one, one, one, one)
    assert all(torch.isfinite(t).all() and not t.any() for t in (y, y1, y8))


def test_build_digest_follows_sources():
    """Library names carry a digest of the sources and flags, so an edited
    kernel never loads a stale build."""
    names = {_cuda.library_path(n).name for n in _cuda.SOURCES}
    assert len(names) == len(_cuda.SOURCES)
    assert all(p.endswith(".so") for p in names)


# ---------------------------------------------------------------------------
# On the card (skip without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 32])
def test_cuda_kernels_equal_plain_versions(cuda_device, m):
    x, packed, w8 = _inputs(m, 256, 160, 32, seed=m)
    dev = cuda_device
    xs, ps, ws = _t(x).to(dev), _t(packed).to(dev), _t(w8).to(dev)
    sc = [torch.tensor(v, device=dev) for v in (0.03, 410.0, 1.5, 0.25)]
    before = dict(_cuda.LAUNCHES)
    torch.testing.assert_close(w1a8_gemv(xs, ps, sc[0]), w1a8_gemv_plain(xs, ps, sc[0]),
                               rtol=0, atol=0)
    for a, b in zip(decoupled_gemv(xs, ps, ws, *sc), decoupled_gemv_plain(xs, ps, ws, *sc)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    q, g = ref.quantize_act_ref(xs)
    assert int8_matmul_route(m, *ws.shape) == "gemv"
    torch.testing.assert_close(int8_matmul(q, ws, g, sc[1]), int8_matmul_plain(q, ws, g, sc[1]),
                               rtol=0, atol=0)
    for name in ("w1a8_gemv", "decoupled_gemv", "int8_matmul"):
        assert _cuda.LAUNCHES[name] == before.get(name, 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m", [33, 136])
def test_cuda_rows_above_decode_tier_launch_prefill_kernels(cuda_device, m):
    """Above DECODE_M_MAX rows ops launches w1a8_matmul / decoupled_matmul
    (never a decode GEMV, never a plain version) and int8_matmul, whose
    launch takes the tile route; each equals its plain version."""
    x, packed, w8 = _inputs(m, 256, 160, 32, seed=m)
    dev = cuda_device
    xs, ps, ws = _t(x).to(dev), _t(packed).to(dev), _t(w8).to(dev)
    sc = [torch.tensor(v, device=dev) for v in (0.03, 410.0, 1.5, 0.25)]
    before = dict(_cuda.LAUNCHES)
    y = ops.bit_linear_infer(xs, ps, sc[0], out_dtype=torch.float32)
    y1, y8 = ops.decoupled_first_gemm(xs, ps, ws, *sc, out_dtype=torch.bfloat16)
    y_i8 = ops.int8_linear_infer(xs, ws, sc[1], out_dtype=torch.bfloat16)
    assert _cuda.LAUNCHES["int8_matmul"] == before.get("int8_matmul", 0) + 1
    assert int8_matmul_route(m, *ws.shape) == "tile"
    assert _cuda.LAUNCHES["w1a8_matmul"] == before.get("w1a8_matmul", 0) + 1
    assert _cuda.LAUNCHES["decoupled_matmul"] == before.get("decoupled_matmul", 0) + 1
    for name in ("w1a8_gemv", "decoupled_gemv"):
        assert _cuda.LAUNCHES[name] == before.get(name, 0)
    q, g = quantize_act_int8(xs)
    torch.testing.assert_close(y, w1a8_matmul_plain(q, ps, g, sc[0]), rtol=0, atol=0)
    p1, p8 = decoupled_matmul_plain(q, ps, ws, g, *sc, out_dtype=torch.bfloat16)
    torch.testing.assert_close(y1, p1, rtol=0, atol=0)
    torch.testing.assert_close(y8, p8, rtol=0, atol=0)
    torch.testing.assert_close(y_i8, int8_matmul_plain(q, ws, g, sc[1], torch.bfloat16),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(384, 2048), (16, 64), (400, 72), (20, 66)])
@pytest.mark.parametrize("m", [33, 64, 129, 1000, 8192])
def test_cuda_int8_matmul_equals_plain_version(cuda_device, m, k, n, out_dtype):
    """int8_matmul above the decode tier, bit for bit against its plain
    version: w8_down's shape, K not a multiple of 128 (16, 400), N ragged
    against the tile (64, 72, 66), and (20, 66), which the shape rule
    sends to the GEMV route (every other pair takes the tile); one launch
    a call."""
    rng = np.random.default_rng(m + k + n)
    dev = cuda_device
    x = _t(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
    w = _t(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
    gamma = _t((rng.random(m) * 50 + 10).astype(np.float32)).to(dev)
    wscale = torch.tensor(1 / 0.0019, dtype=torch.float32, device=dev)
    dt = getattr(torch, out_dtype)
    assert int8_matmul_route(m, k, n) == ("gemv" if (k, n) == (20, 66) else "tile")
    before = _cuda.LAUNCHES["int8_matmul"]
    got = int8_matmul(x, w, gamma, wscale, dt)
    assert _cuda.LAUNCHES["int8_matmul"] == before + 1
    assert got.dtype == dt and got.shape == (m, n)
    torch.testing.assert_close(got, int8_matmul_plain(x, w, gamma, wscale, dt), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 33])
def test_cuda_int8_matmul_alignment_by_route(cuda_device, m):
    """x 4-byte but not 16-byte aligned: the GEMV route (M 4) reads bytes
    and takes it, equal to the plain version; the tile route (M 33)
    raises ValueError and launches nothing."""
    k, n = 384, 2048
    rng = np.random.default_rng(m)
    dev = cuda_device
    buf = _t(rng.integers(-127, 128, m * k + 16).astype(np.int8)).to(dev)
    x = buf[4:4 + m * k].view(m, k)
    assert x.data_ptr() % 16 and not x.data_ptr() % 4
    w = _t(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
    gamma = _t((rng.random(m) * 50 + 10).astype(np.float32)).to(dev)
    wscale = torch.tensor(1 / 0.0019, dtype=torch.float32, device=dev)
    before = _cuda.LAUNCHES["int8_matmul"]
    if int8_matmul_route(m, k, n) == "tile":
        with pytest.raises(ValueError, match="aligned"):
            int8_matmul(x, w, gamma, wscale)
        assert _cuda.LAUNCHES["int8_matmul"] == before
    else:
        torch.testing.assert_close(int8_matmul(x, w, gamma, wscale),
                                   int8_matmul_plain(x, w, gamma, wscale), rtol=0, atol=0)
        assert _cuda.LAUNCHES["int8_matmul"] == before + 1


def _w1a8_matmul_inputs(m, k, n, dev, seed):
    rng = np.random.default_rng(seed)
    x = _t(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
    wp = _t(rng.integers(0, 256, (k // 8, n)).astype(np.uint8)).to(dev)
    gamma = _t((rng.random(m) * 50 + 10).astype(np.float32)).to(dev)
    return x, wp, gamma, torch.tensor(0.031, dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(2048, 2048), (5024, 2048), (400, 72), (16, 64)])
@pytest.mark.parametrize("m", [33, 64, 129, 1000, 8192])
def test_cuda_w1a8_matmul_equals_plain_version(cuda_device, m, k, n, out_dtype):
    """w1a8_matmul above the decode tier, bit for bit against its plain
    version: q/k/v/o's and w1_down's shapes (K 5024 = 39 x 128 + 32: a
    ragged K tail), K not a multiple of 128 (400, 16), N ragged against
    the tile (72, 64; 72 takes the mma route), M ragged against the 128-row
    tile; one launch a call."""
    x, wp, gamma, lam = _w1a8_matmul_inputs(m, k, n, cuda_device, m + k + n)
    dt = getattr(torch, out_dtype)
    before = _cuda.LAUNCHES["w1a8_matmul"]
    got = w1a8_matmul(x, wp, gamma, lam, dt)
    assert _cuda.LAUNCHES["w1a8_matmul"] == before + 1
    assert got.dtype == dt and got.shape == (m, n)
    torch.testing.assert_close(got, w1a8_matmul_plain(x, wp, gamma, lam, dt), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_w1a8_matmul_route(cuda_device):
    """The route each shape takes: wgmma where K and N are multiples of 16,
    at every row count above the decode tier; mma otherwise."""
    for m in (33, 64, 512, 1024, 8192):
        for k, n in ((2048, 2048), (5024, 2048), (16, 64)):
            assert w1a8_matmul_route(m, k, n) == "wgmma", (m, k, n)
        assert w1a8_matmul_route(m, 400, 72) == "mma"
        assert w1a8_matmul_route(m, 2048, 2056) == "mma"


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 2048), (400, 72)])
def test_cuda_w1a8_matmul_alignment_by_route(cuda_device, k, n):
    """w_packed 4-byte but not 16-byte aligned: the wgmma route (N 2048)
    raises ValueError and launches nothing (its TMA descriptor needs 16
    bytes); the mma route (N 72) reads bytes and takes it, equal to the
    plain version."""
    m = 64
    x, wp, gamma, lam = _w1a8_matmul_inputs(m, k, n, cuda_device, k + n)
    buf = torch.zeros(wp.numel() + 16, dtype=torch.uint8, device=cuda_device)
    view = buf[4:4 + wp.numel()].view(wp.shape)
    view.copy_(wp)
    assert view.data_ptr() % 16 and not view.data_ptr() % 4
    before = _cuda.LAUNCHES["w1a8_matmul"]
    if w1a8_matmul_route(m, k, n) == "wgmma":
        with pytest.raises(ValueError, match="aligned"):
            w1a8_matmul(x, view, gamma, lam)
        assert _cuda.LAUNCHES["w1a8_matmul"] == before
    else:
        torch.testing.assert_close(w1a8_matmul(x, view, gamma, lam),
                                   w1a8_matmul_plain(x, wp, gamma, lam), rtol=0, atol=0)
        assert _cuda.LAUNCHES["w1a8_matmul"] == before + 1


def _decoupled_matmul_inputs(m, k, n, r, dev, seed):
    rng = np.random.default_rng(seed)
    x = _t(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
    wp = _t(rng.integers(0, 256, (k // 8, n)).astype(np.uint8)).to(dev)
    w8 = _t(rng.integers(-127, 128, (k, r)).astype(np.int8)).to(dev)
    gamma = _t((rng.random(m) * 50 + 10).astype(np.float32)).to(dev)
    sc = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (0.027, 1 / 0.0021, 1.3, 0.45)]
    return x, wp, w8, gamma, sc


def _decoupled_matmul_exact(m, k, n, r, out_dtype, dev, route):
    x, wp, w8, gamma, sc = _decoupled_matmul_inputs(m, k, n, r, dev, m + k + n + r)
    dt = getattr(torch, out_dtype)
    assert decoupled_matmul_route(m, k, n, r) == route
    before = _cuda.LAUNCHES["decoupled_matmul"]
    y1, y8 = decoupled_matmul(x, wp, w8, gamma, *sc, out_dtype=dt)
    assert _cuda.LAUNCHES["decoupled_matmul"] == before + 1
    assert y1.dtype == y8.dtype == dt and y1.shape == (m, n) and y8.shape == (m, r)
    p1, p8 = decoupled_matmul_plain(x, wp, w8, gamma, *sc, out_dtype=dt)
    torch.testing.assert_close(y1, p1, rtol=0, atol=0)
    torch.testing.assert_close(y8, p8, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n,r", [(2048, 5024, 384), (2880, 7168, 512)])
@pytest.mark.parametrize("m", [33, 64, 136, 512, 1000])
def test_cuda_decoupled_matmul_wgmma_equals_plain_version(cuda_device, m, k, n, r, out_dtype):
    """decoupled_matmul's wgmma route, bit for bit against its plain
    version: pquant-1.3b's FFN (trunk N 5024 ragged against its tiles) and
    pquant-2.6b's (K 2880 = 22 x 128 + 64: a ragged K tail), M under one
    128-row block, over it and ragged, at both trunk widths; one launch a
    call."""
    _decoupled_matmul_exact(m, k, n, r, out_dtype, cuda_device, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n,r", [(400, 72, 36), (256, 160, 20)])
@pytest.mark.parametrize("m", [33, 136, 1000])
def test_cuda_decoupled_matmul_mma_route_equals_plain_version(cuda_device, m, k, n, r,
                                                              out_dtype):
    """Shapes off 16 (N 72, r 36 and 20, as reduced configurations have)
    take the mma route, also bit for bit against the plain version."""
    _decoupled_matmul_exact(m, k, n, r, out_dtype, cuda_device, "mma")


@pytest.mark.cuda
def test_cuda_decoupled_matmul_route(cuda_device):
    """wgmma where K, N and r are multiples of 16, at every row count above
    the decode tier; mma where N or r is not."""
    for m in (33, 64, 128, 256, 512, 1024, 8192):
        for k, n, r in ((2048, 5024, 384), (2880, 7168, 512), (16, 16, 16)):
            assert decoupled_matmul_route(m, k, n, r) == "wgmma", (m, k, n, r)
        for k, n, r in ((400, 72, 36), (2048, 5024, 100), (2048, 5032, 384)):
            assert decoupled_matmul_route(m, k, n, r) == "mma", (m, k, n, r)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,r", [(2048, 5024, 384), (400, 72, 36)])
def test_cuda_decoupled_matmul_alignment_by_route(cuda_device, k, n, r):
    """w8 4-byte but not 16-byte aligned: the wgmma route raises ValueError
    and launches nothing (its TMA descriptor needs 16 bytes); the mma route
    reads words and takes it, equal to the plain version."""
    m = 64
    x, wp, w8, gamma, sc = _decoupled_matmul_inputs(m, k, n, r, cuda_device, k + n + r)
    buf = torch.zeros(w8.numel() + 16, dtype=torch.int8, device=cuda_device)
    view = buf[4:4 + w8.numel()].view(w8.shape)
    view.copy_(w8)
    assert view.data_ptr() % 16 and not view.data_ptr() % 4
    before = _cuda.LAUNCHES["decoupled_matmul"]
    if decoupled_matmul_route(m, k, n, r) == "wgmma":
        with pytest.raises(ValueError, match="aligned"):
            decoupled_matmul(x, wp, view, gamma, *sc)
        assert _cuda.LAUNCHES["decoupled_matmul"] == before
    else:
        for a, b in zip(decoupled_matmul(x, wp, view, gamma, *sc),
                        decoupled_matmul_plain(x, wp, w8, gamma, *sc)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert _cuda.LAUNCHES["decoupled_matmul"] == before + 1


# the decode GEMVs on the card: every row count of the decode tier, the
# pquant-1.3b shapes (K 5024 = 157 k32 steps) and ragged ones (K 2056 not a
# multiple of 32, N 72 not a multiple of 16, K 264 leaving cluster blocks
# without a K slice, N 160 a ragged column tile), all four (x, output) types
GEMV_SHAPES = [(2048, 2048), (5024, 2048), (2056, 72), (264, 160)]
TYPE_PAIRS = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32"),
              ("bfloat16", "bfloat16")]


def _gemv_case(m, k, n, r, x_dtype, dev, seed):
    x, packed, w8 = _inputs(m, k, n, r, seed=seed)
    xs = _t(x).to(dev).to(getattr(torch, x_dtype))
    sc = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (0.03, 410.0, 1.5, 0.25)]
    return xs, _t(packed).to(dev), None if w8 is None else _t(w8).to(dev), sc


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,out_dtype", TYPE_PAIRS)
@pytest.mark.parametrize("k,n", GEMV_SHAPES)
def test_cuda_w1a8_gemv_equals_plain_version_at_every_row_count(cuda_device, k, n, x_dtype,
                                                                 out_dtype):
    dt = getattr(torch, out_dtype)
    for m in range(1, 33):
        xs, ps, _, sc = _gemv_case(m, k, n, None, x_dtype, cuda_device, m + k + n)
        before = _cuda.LAUNCHES["w1a8_gemv"]
        got = w1a8_gemv(xs, ps, sc[0], dt)
        assert _cuda.LAUNCHES["w1a8_gemv"] == before + 1
        assert got.shape == (m, n) and got.dtype == dt
        torch.testing.assert_close(got, w1a8_gemv_plain(xs, ps, sc[0], dt), rtol=0, atol=0,
                                   msg=lambda e, m=m: f"M {m}: {e}")


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,out_dtype", TYPE_PAIRS)
@pytest.mark.parametrize("r", [384, 16])
@pytest.mark.parametrize("k,n", GEMV_SHAPES)
def test_cuda_decoupled_gemv_equals_plain_version_at_every_row_count(cuda_device, k, n, r,
                                                                      x_dtype, out_dtype):
    dt = getattr(torch, out_dtype)
    for m in range(1, 33):
        xs, ps, ws, sc = _gemv_case(m, k, n, r, x_dtype, cuda_device, m + k + n + r)
        before = _cuda.LAUNCHES["decoupled_gemv"]
        got = decoupled_gemv(xs, ps, ws, *sc, dt)
        assert _cuda.LAUNCHES["decoupled_gemv"] == before + 1
        want = decoupled_gemv_plain(xs, ps, ws, *sc, dt)
        for a, b, cols in zip(got, want, (n, r)):
            assert a.shape == (m, cols) and a.dtype == dt
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=lambda e, m=m: f"M {m}: {e}")


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(24576, None), (6144, 1280), (7168, 1024)])
def test_cuda_gemvs_at_long_k_equal_plain_versions(cuda_device, k, r):
    """The K of granite-20b's w1_down (24576) and the int8 branches of
    granite-20b (K 6144, r 1280) and deepseek-coder-33b (K 7168, r 1024),
    whose weight slices do not fit a block's shared memory beside 32 rows'
    codes and sums: staged and multiplied in passes, still bit for bit the
    plain versions, one launch a call, at 1, 4 and 32 rows."""
    n = 256
    for m in (1, 4, 32):
        xs, ps, ws, sc = _gemv_case(m, k, n, r or 16, "float32", cuda_device, m + k)
        before = dict(_cuda.LAUNCHES)
        if r is None:
            torch.testing.assert_close(w1a8_gemv(xs, ps, sc[0]), w1a8_gemv_plain(xs, ps, sc[0]),
                                       rtol=0, atol=0, msg=lambda e, m=m: f"M {m}: {e}")
            assert _cuda.LAUNCHES["w1a8_gemv"] == before.get("w1a8_gemv", 0) + 1
            continue
        for a, b in zip(decoupled_gemv(xs, ps, ws, *sc), decoupled_gemv_plain(xs, ps, ws, *sc)):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=lambda e, m=m: f"M {m}: {e}")
        assert _cuda.LAUNCHES["decoupled_gemv"] == before.get("decoupled_gemv", 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_cuda_gemvs_constant_and_zero_rows(cuda_device, x_dtype):
    """The act-quant's edges on the card: constant rows (every value at the
    row's abs-max, so x * gamma = 127 |c| / (|c| + 1e-5) rounds up to the
    clip), all-zero rows (amax 0: gamma from the 1e-5 alone, zero codes
    and outputs) beside ordinary rows, for M across the tiles' edges."""
    dev = cuda_device
    k, n, r = 2056, 160, 16
    for m in (1, 8, 9, 17, 32):
        xs, ps, ws, sc = _gemv_case(m, k, n, r, "float32", dev, m)
        for i in range(m):
            if i % 3 == 0:
                xs[i] = 0.0
            elif i % 3 == 1:
                xs[i] = (-1.5, 0.75, 2.0)[i % 9 // 3]
        xs = xs.to(getattr(torch, x_dtype))
        torch.testing.assert_close(w1a8_gemv(xs, ps, sc[0]), w1a8_gemv_plain(xs, ps, sc[0]),
                                   rtol=0, atol=0)
        y1, y8 = decoupled_gemv(xs, ps, ws, *sc)
        p1, p8 = decoupled_gemv_plain(xs, ps, ws, *sc)
        torch.testing.assert_close(y1, p1, rtol=0, atol=0)
        torch.testing.assert_close(y8, p8, rtol=0, atol=0)
        assert not y1[0::3].any() and not y8[0::3].any()
