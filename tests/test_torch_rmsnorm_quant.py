"""The port's ``rmsnorm_quant`` kernel: its warp route emulated in NumPy
against the JAX package, its route rule, and (on a card) both routes
against the plain version.

The warp route's arithmetic is emulated step for step, for R warps a row:
chunk c of 8 consecutive values goes to thread c % (32 R), each thread
sums its chunks' squares in order with a fused multiply-add, a 32-lane xor
tree adds each warp's sums and the R warps' results are added in warp
order; each thread scales its chunks and takes their AbsMax before the
same trees with max.  The emulation is held to the Pallas kernel (interpret mode) and
to ``repro.kernels.ref.rmsnorm_quant_ref`` within the stated tolerance:
gamma to rtol 1e-5, every code within one step, at most 0.1% of the codes
different (the sum of squares runs in another order, and ``rsqrt`` is not
correctly rounded on either side).  The emulation's fused multiply-add is
the exact f64 product plus the sum, rounded to f32 (it may round twice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rmsnorm_quant import rmsnorm_quant as pallas_rmsnorm_quant
from repro_torch.kernels import _cuda
from repro_torch.kernels.rmsnorm_quant import (
    CHUNK,
    EPS,
    MAX_BLOCK_D,
    MAX_LANE_CHUNKS,
    MAX_WARP_D,
    WIDE_ROWS,
    rmsnorm_quant,
    rmsnorm_quant_plain,
    rmsnorm_quant_route,
    row_warps,
)

RMS_RTOL, RMS_CODE_SHARE = 1e-5, 1e-3
LANES = 32
PAPER_WIDTHS = (768, 1024, 1536, 2048, 2880)  # configs/pquant_paper.py d_model


def _assert_codes_close(q, jq, g, jg):
    np.testing.assert_allclose(g, jg, rtol=RMS_RTOL, atol=0)
    diff = np.abs(np.asarray(q, np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= RMS_CODE_SHARE


def lane_chunks(d: int, r: int = 1) -> list[list[int]]:
    """The chunks each thread of a row's r warps holds on the warp route,
    in the order it holds them: chunk c (values 8c ... 8c + 7) is thread
    c % (32 r)'s (c // (32 r))-th."""
    chunks, lanes = d // CHUNK, LANES * r
    per_lane = -(-chunks // lanes)
    return [[t + lanes * j for j in range(per_lane) if t + lanes * j < chunks]
            for t in range(lanes)]


def _row_tree(v: np.ndarray, op, r: int) -> np.ndarray:
    """(M, 32 r) thread values -> (M,): the __shfl_xor_sync tree (offsets
    16 .. 1) in each warp, then the r warps' results in warp order."""
    w = v.reshape(v.shape[0], r, LANES)
    for o in (16, 8, 4, 2, 1):
        w = op(w, w[:, :, np.arange(LANES) ^ o]).astype(np.float32)
    assert (w == w[:, :, :1]).all()  # every lane of a warp holds its result
    out = w[:, 0, 0]
    for k in range(1, r):
        out = op(out, w[:, k, 0]).astype(np.float32)
    return out


def emulate_warp_route(x: np.ndarray, scale: np.ndarray, r: int = 1, eps: float = EPS):
    """x (M, D) f32 (the f32 values of bf16 rows, exactly), scale (D,) f32
    -> (q (M, D) int8, gamma (M,) f32) as the warp route computes them with
    r warps a row."""
    m, d = x.shape
    owned = lane_chunks(d, r)
    lanes = LANES * r
    per_lane = max(len(c) for c in owned)
    # (M, per_lane, 32 r, 8): slot (j, t) holds chunk t + 32 r j, or zeros
    # past the row's end (the kernel skips them; a zero adds nothing)
    held = np.zeros((m, per_lane, lanes, CHUNK), np.float32)
    for lane, chunks in enumerate(owned):
        for j, c in enumerate(chunks):
            held[:, j, lane] = x[:, c * CHUNK:(c + 1) * CHUNK]
    ss = np.zeros((m, lanes), np.float32)
    for j in range(per_lane):
        for e in range(CHUNK):
            v = held[:, j, :, e].astype(np.float64)
            ss = (v * v + ss.astype(np.float64)).astype(np.float32)
    var = _row_tree(ss, np.add, r) / np.float32(d)
    inv = (1.0 / np.sqrt((var + np.float32(eps)).astype(np.float64))).astype(np.float32)
    s = np.zeros((per_lane, lanes, CHUNK), np.float32)
    for lane, chunks in enumerate(owned):
        for j, c in enumerate(chunks):
            s[j, lane] = scale[c * CHUNK:(c + 1) * CHUNK]
    normed = (held * inv[:, None, None, None]) * s[None]
    amax = _row_tree(np.abs(normed).max(axis=(1, 3)), np.maximum, r)
    gamma = np.float32(127.0) / (amax + np.float32(1e-5))
    codes = np.clip(np.rint(normed * gamma[:, None, None, None]), -127, 127).astype(np.int8)
    q = np.empty((m, d), np.int8)
    for lane, chunks in enumerate(owned):
        for j, c in enumerate(chunks):
            q[:, c * CHUNK:(c + 1) * CHUNK] = codes[:, j, lane]
    return q, gamma.astype(np.float32)


def _rows(m, d, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, d)) * 3).astype(np.float32)
    scale = (rng.random(d) + 0.5).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, np.array(jx.astype(jnp.float32)), scale


# ---------------------------------------------------------------------------
# The warp route, emulated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", PAPER_WIDTHS)
@pytest.mark.parametrize("r", [1, 8])
def test_lane_chunks_cover_each_value_once(d, r):
    """Every chunk on exactly one thread and the threads' counts within one
    of each other."""
    owned = lane_chunks(d, r)
    flat = sorted(c for chunks in owned for c in chunks)
    assert flat == list(range(d // CHUNK))
    counts = [len(c) for c in owned]
    assert max(counts) - min(counts) <= 1
    if d == 2880 and r == 1:  # 360 chunks: lanes 0-7 hold 12, the rest 11
        assert counts == [12] * 8 + [11] * 24


def test_row_warps_rule():
    """The fewest warps a row that leave a thread at most 2 chunks below
    WIDE_ROWS rows and at most 4 from there up; every width of the warp
    route within the 4 chunks a thread the CUDA source instantiates."""
    assert [row_warps(33, d) for d in PAPER_WIDTHS] == [2, 2, 4, 4, 8]
    assert [row_warps(WIDE_ROWS, d) for d in PAPER_WIDTHS] == [1, 1, 2, 2, 4]
    assert [row_warps(8192, d) for d in PAPER_WIDTHS] == [1, 1, 2, 2, 4]
    for m in (1, WIDE_ROWS - 1, WIDE_ROWS):
        for d in range(CHUNK, MAX_WARP_D + 1, CHUNK):
            r = row_warps(m, d)
            assert r in (1, 2, 4, 8)
            assert max(len(c) for c in lane_chunks(d, r)) <= MAX_LANE_CHUNKS


@pytest.mark.parametrize("d", [768, 2048, 2880])
@pytest.mark.parametrize("m", [1, 7, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_emulated_warp_route_matches_jax(d, m, dtype, r):
    jx, x, scale = _rows(m, d, dtype, seed=d + m)
    q, g = emulate_warp_route(x, scale, r)
    assert q.shape == (m, d) and g.shape == (m,)
    assert np.abs(q).max() == 127  # each row's AbsMax element maps to the rail
    jq, jg = pallas_rmsnorm_quant(jx, jnp.asarray(scale), interpret=True)
    _assert_codes_close(q, jq, g, jg)
    rq, rg = jref.rmsnorm_quant_ref(jx, jnp.asarray(scale))
    _assert_codes_close(q, rq, g, rg)
    pq, pg = rmsnorm_quant_plain(torch.from_numpy(x), torch.from_numpy(scale))
    _assert_codes_close(q, pq.numpy(), g, pg.numpy())


# ---------------------------------------------------------------------------
# The route rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", PAPER_WIDTHS + (8, MAX_WARP_D))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_warp_at_paper_widths(d, dtype):
    assert rmsnorm_quant_route(8192, d, dtype, 0x7F0000000000) == "warp"
    assert rmsnorm_quant_route(1, d, dtype, 16) == "warp"


@pytest.mark.parametrize("d,ptr", [
    (100, 0),  # not a multiple of 8
    (2044, 0),
    (MAX_WARP_D + CHUNK, 0),  # wider than 16 chunks a lane
    (MAX_BLOCK_D, 0),  # the widest row a block's shared memory holds
    (2048, 8),  # x only 8-byte aligned
    (2048, 2),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_block_elsewhere(d, ptr, dtype):
    assert rmsnorm_quant_route(33, d, dtype, ptr) == "block"


@pytest.mark.parametrize("m,d,dtype", [
    (0, 2048, torch.float32),
    (33, 0, torch.float32),
    (33, MAX_BLOCK_D + 1, torch.bfloat16),
    (33, 2048, torch.float16),
])
def test_route_raises_where_no_route_takes(m, d, dtype):
    with pytest.raises(ValueError):
        rmsnorm_quant_route(m, d, dtype, 0)


def test_wrapper_runs_plain_on_cpu_with_bf16_scale():
    """A CPU tensor runs the plain version, which reads scale as f32."""
    x = torch.randn(5, 64, dtype=torch.bfloat16)
    s = (torch.rand(64) + 0.5).to(torch.bfloat16)
    _cuda.reset_launches()
    q, g = rmsnorm_quant(x, s)
    assert sum(_cuda.LAUNCHES.values()) == 0
    rq, rg = rmsnorm_quant_plain(x, s.float())
    assert torch.equal(q, rq) and torch.equal(g, rg)


# ---------------------------------------------------------------------------
# On the card (skip without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_rows(m, d, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((m, d)) * 3).astype(np.float32)).to(dev, dtype)
    s = torch.from_numpy((rng.random(d) + 0.5).astype(np.float32)).to(dev)
    return x, s


def _launch_once(x, s):
    before = _cuda.LAUNCHES["rmsnorm_quant"]
    q, g = rmsnorm_quant(x, s)
    assert _cuda.LAUNCHES["rmsnorm_quant"] == before + 1
    return q, g


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 2048, 2880, 100, MAX_WARP_D + CHUNK])
@pytest.mark.parametrize("m", [1, 33, 300, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_within_tolerance(cuda_device, d, m, dtype):
    x, s = _card_rows(m, d, dtype, cuda_device, seed=d + m)
    route = rmsnorm_quant_route(m, d, dtype, x.data_ptr())
    assert route == ("warp" if d % CHUNK == 0 and d <= MAX_WARP_D else "block")
    q, g = _launch_once(x, s)
    rq, rg = rmsnorm_quant_plain(x, s)
    _assert_codes_close(q.cpu().numpy(), rq.cpu().numpy(), g.cpu().numpy(), rg.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_misaligned_rows_take_block_route(cuda_device, dtype):
    """x 8 bytes past an aligned address: contiguous, on the block route."""
    m, d = 33, 2048
    x, s = _card_rows(m, d, dtype, cuda_device, seed=5)
    off = 8 // x.element_size()
    buf = torch.empty(m * d + off, dtype=dtype, device=cuda_device)
    xv = buf[off:].view(m, d)
    xv.copy_(x)
    assert xv.data_ptr() % 16 == 8
    assert rmsnorm_quant_route(m, d, dtype, xv.data_ptr()) == "block"
    q, g = _launch_once(xv, s)
    rq, rg = rmsnorm_quant_plain(x, s)
    _assert_codes_close(q.cpu().numpy(), rq.cpu().numpy(), g.cpu().numpy(), rg.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 100])
def test_cuda_scale_of_any_float_type(cuda_device, d):
    """A bf16 scale, and an f32 scale at an address off 16 bytes, give what
    the plain version gives: the wrapper reads scale as aligned f32."""
    m = 33
    x, s = _card_rows(m, d, torch.bfloat16, cuda_device, seed=d)
    s16 = s.to(torch.bfloat16)
    q, g = _launch_once(x, s16)
    rq, rg = rmsnorm_quant_plain(x, s16)
    _assert_codes_close(q.cpu().numpy(), rq.cpu().numpy(), g.cpu().numpy(), rg.cpu().numpy())
    buf = torch.empty(d + 1, dtype=torch.float32, device=cuda_device)
    sv = buf[1:]
    sv.copy_(s)
    q, g = _launch_once(x, sv)
    rq, rg = rmsnorm_quant_plain(x, s)
    _assert_codes_close(q.cpu().numpy(), rq.cpu().numpy(), g.cpu().numpy(), rg.cpu().numpy())


@pytest.mark.cuda
def test_cuda_route_rule_matches_source(cuda_device):
    """The Python rule equals ``rmsnorm_quant_route`` of the CUDA source:
    the warps a row on the warp route, 0 on the block route, -1 for none."""
    from repro_torch.kernels.rmsnorm_quant import _SIGNATURES

    lib = _cuda.load("rmsnorm_quant", _SIGNATURES)
    widths = PAPER_WIDTHS + (8, 100, 520, 2044, MAX_WARP_D, MAX_WARP_D + 8, MAX_BLOCK_D)
    for m in (1, 33, WIDE_ROWS - 1, WIDE_ROWS, 8192):
        for d in widths:
            for dtype in (torch.float32, torch.bfloat16):
                for ptr in (0, 8, 4096):
                    got = lib.rmsnorm_quant_route(m, d, _cuda.float_code(dtype, "x"), ptr)
                    route = rmsnorm_quant_route(m, d, dtype, ptr)
                    assert got == (row_warps(m, d) if route == "warp" else 0), (m, d, ptr)
    assert lib.rmsnorm_quant_route(33, MAX_BLOCK_D + 1, 0, 0) == -1
    assert lib.rmsnorm_quant_route(0, 2048, 0, 0) == -1
