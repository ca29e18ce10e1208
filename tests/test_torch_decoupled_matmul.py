"""The wgmma route of the port's ``decoupled_matmul`` kernel
(``src/repro_torch/csrc/decoupled_matmul.cu``), emulated in NumPy on the
CPU and held exactly against JAX's ``decoupled_matmul`` (the Pallas kernel
in interpret mode) and the port's plain version, on the same numpy-seeded
inputs.

The CUDA kernel runs only on the card.  What it does with indices is
emulated here step for step, with the kernel's own integer arithmetic:

* the tile list of each 128-row block of x (the 8-bit branch's tiles of
  128 columns first, then the trunk's tiles of 128 or 256), walked by
  persistent blocks that each take every gridDim-th tile;
* the stage boxes as TMA leaves them in shared memory, zero past M, K, N
  and r; the int8 box with the 128-byte swizzle;
* each lane's 16-bit shared loads and its A fragments: the trunk's
  nibbles through ``sign_word``, the 8-bit branch's bytes through the
  ``__byte_perm`` joins of ``int8_fragment`` (rows read in the lane's
  order, which keeps a warp's loads free of bank conflicts);
* ``wgmma.m64n128k32``: A rebuilt from the 128 lanes' registers at the
  places the PTX fragment layout gives them, times the activation box;
* the epilogue's lane -> column and accumulator -> (row, column) maps and
  its f32 scales in the Pallas kernel's order.

The integer sums are exact in any order and the epilogue keeps the Pallas
kernel's order of operations, so the emulation must equal both references
bit for bit, in f32 and in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decoupled_matmul import decoupled_matmul as pallas_decoupled_matmul
from repro_torch.kernels.decoupled_matmul import decoupled_matmul_plain

BM, BK, BN8, CONSUMERS = 128, 128, 128, 2
SMS = 132  # an H100's SMs: the persistent grid's width
U32 = np.uint32


def tile_list(m, n, r, slices):
    """(row0, col0, eight) of every tile, in the kernel's order."""
    bn1 = 64 * slices * CONSUMERS
    t8, t1 = -(-r // BN8), -(-n // bn1)
    per_row = t8 + t1
    tiles = []
    for tile in range(-(-m // BM) * per_row):
        j = tile % per_row
        eight = j < t8
        tiles.append((tile // per_row * BM, j * BN8 if eight else (j - t8) * bn1, eight))
    return tiles


def blocks_of(ntiles, sms=SMS):
    """The tiles each persistent block walks: every gridDim.x-th."""
    grid = min(ntiles, sms)
    return [list(range(b, ntiles, grid)) for b in range(grid)]


# ---- the kernel's integer helpers (uint32 lanes) ----


def sign_word(nib):
    ones = (nib * U32(0x00204081)) & U32(0x01010101)
    return ones * U32(0xFFFFFF02) + U32(0xFFFFFFFF)


def sign_fragment(lo, hi, shift):
    lo, hi = lo >> shift, hi >> shift
    return [sign_word(lo & U32(0xF)), sign_word((lo >> U32(8)) & U32(0xF)),
            sign_word(hi & U32(0xF)), sign_word((hi >> U32(8)) & U32(0xF))]


def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel): byte n of the result is byte (sel >> 4 n) & 7
    of the eight bytes y:x."""
    pool = np.stack([(x >> U32(8 * i)) & U32(0xFF) for i in range(4)]
                    + [(y >> U32(8 * i)) & U32(0xFF) for i in range(4)])
    sel = np.broadcast_to(np.asarray(sel, dtype=U32), x.shape)
    out = np.zeros(x.shape, U32)
    for n in range(4):
        idx = ((sel >> U32(4 * n)) & U32(7)).astype(np.intp)
        out |= np.take_along_axis(pool, idx[None], 0)[0] << U32(8 * n)
    return out


def int8_fragment(lo, hi, sel):
    l01, l23 = byte_perm(lo[0], lo[1], sel), byte_perm(lo[2], lo[3], sel)
    h01, h23 = byte_perm(hi[0], hi[1], sel), byte_perm(hi[2], hi[3], sel)
    return [byte_perm(l01, l23, 0x5410), byte_perm(l01, l23, 0x7632),
            byte_perm(h01, h23, 0x5410), byte_perm(h01, h23, 0x7632)]


def lds16(buf, addr):
    """16-bit little-endian shared loads of every lane."""
    return buf[addr].astype(U32) | (buf[addr + 1].astype(U32) << U32(8))


def swizzled(q, c):
    """Byte offset of (row q, byte c) in a 128-byte-wide box with TMA's
    128-byte swizzle: chunk c / 16 of row q moves to (c / 16) ^ (q & 7)."""
    return q * 128 + ((((c >> 4) ^ (q & 7)) << 4) | (c & 15))


# the 128 lanes of a consumer warpgroup: warp, g, t
WARP, G, T = (a.ravel() for a in np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                                             indexing="ij"))


def wgmma(d, a, xbox, s, accumulate):
    """d (64 x 128 int64) = (d if accumulate else 0) + A (64 x 32, rebuilt
    from the lanes' four registers at the PTX fragment's places) x B (the
    activation box's K bytes 32 s .. 32 s + 31 of its 128 rows)."""
    A = np.zeros((64, 32), np.int64)
    for reg in range(4):
        rows = 16 * WARP + G + 8 * (reg & 1)
        for b in range(4):
            byte = ((a[reg] >> U32(8 * b)) & U32(0xFF)).astype(np.uint8).view(np.int8)
            A[rows, (reg >> 1) * 16 + 4 * T + b] = byte
    prod = A @ xbox[:, 32 * s:32 * s + 32].astype(np.int64).T
    d[...] = d + prod if accumulate else prod


def emulate(x, packed, w8, gamma, lam, w8s, alpha, beta, slices, sms=SMS):
    """y1 (M, N), y8 (M, r) in f32 as the wgmma route computes them."""
    m, k = x.shape
    n, r = packed.shape[1], w8.shape[1]
    bn1 = 64 * slices * CONSUMERS
    nk = -(-k // BK)
    y1 = np.full((m, n), np.nan, np.float32)
    y8 = np.full((m, r), np.nan, np.float32)
    f32 = np.float32
    bl, alpha, w8s = f32(beta) * f32(lam), f32(alpha), f32(w8s)
    tiles = tile_list(m, n, r, slices)
    for walk in blocks_of(len(tiles), sms):
        # a block's accumulators live across its tiles: each tile's first
        # wgmma overwrites them (accumulate 0), none is cleared between
        acc = np.zeros((CONSUMERS, slices, 64, 128), np.int64)
        for row0, col0, eight in (tiles[i] for i in walk):
            rows = min(BM, m - row0)
            for kt in range(nk):
                xbox = np.zeros((BM, BK), np.int8)  # TMA: zero past M and K
                blk = x[row0:row0 + BM, kt * BK:(kt + 1) * BK]
                xbox[:blk.shape[0], :blk.shape[1]] = blk
                if eight:
                    wbox = np.zeros(BK * BN8, np.uint8)
                    blk = w8[kt * BK:(kt + 1) * BK, col0:col0 + BN8].view(np.uint8)
                    q, c = np.meshgrid(np.arange(blk.shape[0]), np.arange(blk.shape[1]),
                                       indexing="ij")
                    wbox[swizzled(q, c)] = blk
                else:
                    wbox = np.zeros((BK // 8, bn1), np.uint8)
                    blk = packed[kt * (BK // 8):(kt + 1) * (BK // 8), col0:col0 + bn1]
                    wbox[:blk.shape[0], :blk.shape[1]] = blk
                    wbox = wbox.ravel()
                for cw in range(CONSUMERS):
                    if eight:
                        c8 = cw * 64 + 16 * WARP + 2 * G
                        off8 = [swizzled(4 * T + (i ^ (T >> 1)), c8) for i in range(4)]
                        sel = np.where(T & 2, U32(0x1504), U32(0x5140))
                        for s in range(BK // 32):
                            lo = [lds16(wbox, (32 * s) * BN8 + off8[i]) for i in range(4)]
                            hi = [lds16(wbox, (32 * s + 16) * BN8 + off8[i]) for i in range(4)]
                            wgmma(acc[cw, 0], int8_fragment(lo, hi, sel), xbox, s,
                                  kt > 0 or s > 0)
                    else:
                        wcol = cw * 64 * slices + 16 * WARP + 2 * G
                        kb_lane, shift = T >> 1, (4 * (T & 1)).astype(U32)
                        for i in range(slices):
                            v = [lds16(wbox, (kb_lane + 2 * j) * bn1 + wcol + 64 * i)
                                 for j in range(8)]
                            for s in range(BK // 32):
                                wgmma(acc[cw, i], sign_fragment(v[2 * s], v[2 * s + 1], shift),
                                      xbox, s, kt > 0 or s > 0)
            # epilogue: per lane, accumulator d[4 j + 2 h + e] is A row
            # 16 warp + g + 8 h (column 2 g + h of the lane's pair) at
            # activation row 8 j + 2 t + e
            assert np.abs(acc).max() < 2**31  # int32 accumulators
            gv = gamma[row0:row0 + rows].astype(f32)
            sc = alpha / (gv * w8s) if eight else bl * (f32(1) / gv)
            for cw in range(CONSUMERS):
                for i in range(1 if eight else slices):
                    d = acc[cw, i]
                    if eight:
                        out, ncols, col = y8, r, col0 + cw * 64 + 16 * WARP + 2 * G
                    else:
                        out, ncols = y1, n
                        col = col0 + cw * 64 * slices + 16 * WARP + 2 * G + 64 * i
                    for j in range(16):
                        for e in range(2):
                            q = 8 * j + 2 * T + e
                            ok = (q < rows) & (col < ncols)
                            for h in range(2):
                                val = d[(16 * WARP + G + 8 * h)[ok], q[ok]].astype(f32)
                                out[row0 + q[ok], col[ok] + h] = val * sc[q[ok]]
    return y1, y8


def _case(m, k, n, r, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    packed = rng.integers(0, 256, (k // 8, n)).astype(np.uint8)
    w8 = rng.integers(-127, 128, (k, r)).astype(np.int8)
    gamma = (rng.random(m) * 50 + 10).astype(np.float32)
    sc = [np.float32(v) for v in (0.027, 1 / 0.0021, 1.3, 0.45)]
    return x, packed, w8, gamma, sc


# (M, K, N, r): M under one row block and over two (the second ragged); K
# tails of 16 and 64 past a 128-byte stage (2880's is 64); N and r ragged
# against their tiles, r over one 8-bit tile.  The Pallas kernel takes r <= N.
SHAPES = [(40, 144, 96, 32), (136, 256, 160, 48), (48, 192, 272, 144)]


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("m,k,n,r", SHAPES)
def test_emulated_wgmma_route_equals_jax_exactly(m, k, n, r, slices):
    x, packed, w8, gamma, sc = _case(m, k, n, r, seed=m + k + n + r)
    y1, y8 = emulate(x, packed, w8, gamma, *sc, slices=slices)
    args = (jnp.asarray(x), jnp.asarray(packed), jnp.asarray(w8), jnp.asarray(gamma),
            *map(jnp.asarray, sc))
    j1, j8 = pallas_decoupled_matmul(*args, bm=8, bk=k, bn=n, interpret=True)
    np.testing.assert_array_equal(y1, np.asarray(j1))
    np.testing.assert_array_equal(y8, np.asarray(j8))
    p1, p8 = decoupled_matmul_plain(*(torch.from_numpy(a) for a in (x, packed, w8, gamma)),
                                    *(torch.tensor(v) for v in sc))
    np.testing.assert_array_equal(y1, p1.numpy())
    np.testing.assert_array_equal(y8, p8.numpy())
    # bf16 out: the f32 epilogue rounded once to nearest even, as the
    # kernel's store rounds it
    b1, b8 = pallas_decoupled_matmul(*args, bm=8, bk=k, bn=n, out_dtype=jnp.bfloat16,
                                     interpret=True)
    for got, want in ((y1, b1), (y8, b8)):
        got = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, np.asarray(want).astype(np.float32))


def test_emulated_persistent_walk_with_few_blocks():
    """A grid narrower than the tile list (each block walking several tiles
    of both kinds, its accumulators never cleared between them) gives the
    same outputs as one block a tile."""
    m, k, n, r = 136, 144, 160, 48
    x, packed, w8, gamma, sc = _case(m, k, n, r, seed=3)
    wide = emulate(x, packed, w8, gamma, *sc, slices=1)
    for sms in (1, 3):
        for a, b in zip(emulate(x, packed, w8, gamma, *sc, slices=1, sms=sms), wide):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("m,n,r", [(8192, 5024, 384), (33, 5024, 384), (1000, 7168, 512),
                                   (136, 96, 144)])
def test_tile_list_order_and_cover(m, n, r, slices):
    """Each row block lists its 8-bit tiles first, then the trunk's; the
    tiles cover every output column of both branches once per row block,
    and the persistent blocks take every tile once."""
    tiles = tile_list(m, n, r, slices)
    bn1 = 64 * slices * CONSUMERS
    per_row = -(-r // BN8) + -(-n // bn1)
    assert len(tiles) == -(-m // BM) * per_row
    for rb in range(-(-m // BM)):
        row = tiles[rb * per_row:(rb + 1) * per_row]
        assert all(t[0] == rb * BM for t in row)
        kinds = [t[2] for t in row]
        assert kinds == sorted(kinds, reverse=True)  # 8-bit tiles lead
        cols8 = np.concatenate([np.arange(c, c + BN8) for _, c, e in row if e])
        cols1 = np.concatenate([np.arange(c, c + bn1) for _, c, e in row if not e])
        np.testing.assert_array_equal(np.sort(cols8[cols8 < r]), np.arange(r))
        np.testing.assert_array_equal(np.sort(cols1[cols1 < n]), np.arange(n))
    walked = sorted(i for b in blocks_of(len(tiles)) for i in b)
    assert walked == list(range(len(tiles)))


def test_eight_bit_loads_free_of_bank_conflicts():
    """Every 16-bit load instruction of a warp on an 8-bit tile touches 32
    distinct banks or shares a word: the lanes of one column read four
    K rows with four distinct (row & 7), which the box's swizzle sends to
    four chunks.  Without the lane's row order (every lane reading row
    4 t + i at load i) two rows of the four share a bank."""
    def conflicts(order):
        worst = 1
        for cw in range(CONSUMERS):
            for w in range(4):
                lane = WARP == w
                c8 = cw * 64 + 16 * WARP[lane] + 2 * G[lane]
                for s in range(BK // 32):
                    for h in range(2):
                        for i in range(4):
                            q = 32 * s + 16 * h + 4 * T[lane] + order(i, T[lane])
                            word = swizzled(q, c8) // 4
                            banks = {}
                            for wd in np.unique(word):
                                banks.setdefault(wd % 32, set()).add(wd)
                            worst = max(worst, max(len(v) for v in banks.values()))
        return worst

    assert conflicts(lambda i, t: i ^ (t >> 1)) == 1
    assert conflicts(lambda i, t: i + 0 * t) == 2


def test_sign_word_and_int8_fragment_bytes():
    """sign_word maps bit j to byte j as +1 / -1; int8_fragment joins the
    loads of rows in either order into one column's four K values."""
    nib = np.arange(16, dtype=U32)
    got = sign_word(nib).astype(np.uint32).view(np.uint8).view(np.int8).reshape(16, 4)
    want = np.where((nib[:, None] >> np.arange(4)) & 1, 1, -1)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(0)
    col = rng.integers(0, 256, (2, 2, 4)).astype(U32)  # (half, column, K row)
    words = col[:, 0] | (col[:, 1] << U32(8))  # (half, K row): the 16-bit loads
    for order, sel in (((0, 1, 2, 3), 0x5140), ((1, 0, 3, 2), 0x1504)):
        lo = [words[0, o:o + 1] for o in order]
        hi = [words[1, o:o + 1] for o in order]
        a = int8_fragment(lo, hi, U32(sel))
        for reg, (h, c) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            np.testing.assert_array_equal(
                [(int(a[reg][0]) >> (8 * b)) & 0xFF for b in range(4)], col[h, c])
