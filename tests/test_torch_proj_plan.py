"""Launch plans of the projection tiles, checked on the CPU: rows 1 / 2
(csrc/w4a8_matmul.cu above 8 rows, mirrored by ops/w4a8_matmul.tile_plan),
row 3 (csrc/qkv_rope.cu, ops/qkv_rope.tile_plan) and row 14
(csrc/w8a8_matmul.cu at every row count, ops/w8a8_matmul.tile_plan), all on
csrc/tc_tile.cuh; the column map and the rows a K split finishes are
mirrored here from the kernels.

For every registry shape they serve (TinyLlama, StableLM, Gemma-2B: qkv, o,
w2 and the head at its padded width Vp), M = 9 .. 2048, SM counts of 132
(H100 SXM), 114 (H100 PCIe) and 7, and two widths off the 128-column grid
(one not a multiple of 16, the 4-byte-copy edition's):
  - every (row, column) of the output is written by one tile, none past it;
  - every packed-row chunk is read once per tile, by one K split, and the
    splits of a tile fit one portable thread-block cluster, which finishes
    each row of the tile once after its meeting (no workspace);
  - at head_dim 256 every column sits in its tile beside its RoPE partner
    (at head_dim <= 128 a tile holds whole heads);
  - the workspace the decode path (M <= 8) is given covers its layout.
Row 14 likewise at every W8 width of the three models (qkv, o, w13, w2) and
the two off-grid widths, at M = 1, 2, 8, 9, 32, 33, 128: its tiles finish
only the tile's valid rows (tc_rows_of with the row count).
"""

from __future__ import annotations

import pytest

from mobilequant_tpu_torch.models.registry import get_config
from mobilequant_tpu_torch.ops import qkv_rope as Q
from mobilequant_tpu_torch.ops import w4a8_matmul as W
from mobilequant_tpu_torch.ops import w8a8_matmul as W8

MODELS = ("tinyllama-1.1b", "stablelm-2-1.6b", "gemma-2b", "qwen2-1.5b", "llama-3-8b",
          "llama-2-7b")
SMS = (132, 114, 7)
MS = (9, 17, 32, 63, 64, 65, 128, 1024, 2048)


def _shapes(name: str):
    """{tag: (K, N)} of a model's W4A8 projections, and (K, Nq, hd, rot) of
    its qkv."""
    c = get_config(name)
    hd, Hq, Hkv = c.head_dim_, c.num_heads, c.num_kv_heads
    D, F = c.hidden_size, c.intermediate_size
    Nq = (Hq + 2 * Hkv) * hd
    Vp = -(-c.vocab_size // 4096) * 4096          # engine.pack_head's padding
    return ({"qkv": (D, Nq), "o": (Hq * hd, D), "w2": (F, D), "head": (D, Vp)},
            (D, Nq, hd, c.rotary_dim))


def _colmap(x, hd):
    """(colA, colB, split, na, nb) of row 3's column tile x (qkv_rope.cu's
    ColMap): at head_dim 256 two 64-column runs of head x // 2, 128 apart."""
    if hd == 256:
        pa = (x >> 1) * 256 + (x & 1) * 64
        return pa, pa + 128, 64, 64, 64
    return 128 * x, 0, 128, 128, 0


def _split_rows(z, ks, rows=W.TILE_ROWS):
    """the rows of a tile that K split z of ks finishes after the cluster's
    meeting (tc_tile.cuh tc_rows_of: z, z + ks, ... below the tile's valid
    rows)"""
    n = (rows - z + ks - 1) // ks
    assert n >= 0
    return range(z, z + ks * n, ks)


def _gcol(cm, n):
    colA, colB, split, _, _ = cm
    return colA + n if n < split else colB + (n - split)


def _valid(cm, n):
    _, _, split, na, nb = cm
    return n < na if n < split else n - split < nb


def _check_spans(spans, total):
    """[a, b) spans cover [0, total) once, in order, none empty"""
    assert spans[0][0] == 0 and spans[-1][1] == total
    assert all(a < b for a, b in spans)
    assert all(spans[z][1] == spans[z + 1][0] for z in range(len(spans) - 1))


def _check_splits(M, K, tiles, ks, cps, sms, rows=W.TILE_ROWS):
    """The K splits: chunks [z·cps, min(nch, (z+1)·cps)) cover [0, nch)
    once, none empty; the chunks cover K/2 packed rows; one split once the
    tiles fill the SMs; the splits of a tile fit one portable cluster and,
    after its meeting, finish each of the tile's first `rows` rows once."""
    nch = -(-(K // 2) // W.CHUNK_ROWS)
    assert (nch - 1) * W.CHUNK_ROWS < K // 2 <= nch * W.CHUNK_ROWS
    _check_spans([(z * cps, min(nch, (z + 1) * cps)) for z in range(ks)], nch)
    if tiles >= sms:
        assert ks == 1
    assert 1 <= ks <= W.MAX_SPLITS
    done = sorted(r for z in range(ks) for r in _split_rows(z, ks, rows))
    assert done == list(range(rows))


def _check_rows(M, tm):
    _check_spans([(y * W.TILE_ROWS, min(M, (y + 1) * W.TILE_ROWS)) for y in range(tm)], M)


def _check_workspace(M, N):
    """the decode path's workspace (M <= 8): a counter and 64 row sums a
    128-column tile, then (M, N) int32 partials"""
    tiles = -(-N // 128)
    assert W.workspace_ints(M, N) >= max(tiles + tiles * W.TILE_ROWS, 65 * tiles + M * N)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("name", MODELS + ("tails",))
def test_w4a8_tile_plan_covers_each_output_once(name, sms):
    shapes = ({"N%16=4": (2048, 500), "N%128=16": (2048, 1040)} if name == "tails"
              else _shapes(name)[0])
    for tag, (K, N) in shapes.items():
        tn = W.tile_plan(9, K, N, sms)[0]
        # column tile x (ColMap{128 x, 0, 128, na, 0}) writes 128 x + [0, na)
        _check_spans([(128 * x, 128 * x + min(128, N - 128 * x)) for x in range(tn)], N)
        assert N % 4 == 0             # the 4-byte edition (N % 16 != 0): whole units
        for M in MS:
            tn_, tm, ks, cps = W.tile_plan(M, K, N, sms)
            assert tn_ == tn
            _check_rows(M, tm)
            _check_splits(M, K, tn * tm, ks, cps, sms)
        for M in range(1, W.GEMV_ROWS + 1):
            _check_workspace(M, N)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("name", MODELS)
def test_qkv_rope_tile_plan_covers_each_output_once(name, sms):
    K, Nq, hd, rot = _shapes(name)[1]
    assert Q.qkv_rope_kernel_takes(hd, rot)
    tn = Q.tile_plan(9, K, Nq, sms)[0]
    maps = [_colmap(x, hd) for x in range(tn)]
    cols = sorted(_gcol(cm, n) for cm in maps for n in range(128) if _valid(cm, n))
    assert cols == list(range(Nq))
    shift = rot // 2
    for cm in maps:
        for n in range(128):
            col = _gcol(cm, n)
            # the kernel's head dim and partner column (csrc/qkv_rope.cu)
            d = col % hd if hd == 256 else n % hd
            assert d == col % hd
            if hd == 256:
                pl = n + 64 if n < 64 else n - 64
            else:
                pl = n + shift if d < shift else n - shift
            if d >= rot:                  # past rotary_dim: cos 1, sin 0
                continue
            assert 0 <= pl < 128
            want = col + shift if d < shift else col - shift
            assert _gcol(cm, pl) == want and want // hd == col // hd
    for M in MS:
        tn_, tm, ks, cps = Q.tile_plan(M, K, Nq, sms)
        assert tn_ == tn
        _check_rows(M, tm)
        _check_splits(M, K, tn * tm, ks, cps, sms)


W8_MS = (1, 2, 8, 9, 32, 33, 128)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("name", MODELS + ("tails",))
def test_w8a8_tile_plan_covers_each_output_once(name, sms):
    """Row 14 (tc_matmul_kernel<8, V16, SKIP>) at every row count: each
    output written once by one tile and one K split, the splits of a tile
    one portable cluster that finishes only the tile's valid rows, the last
    column tile ragged, and a width N % 16 != 0 (the 4-byte-copy edition's)
    in whole 4-byte units."""
    if name == "tails":
        shapes = {"N%16=4": (2048, 500), "N%128=16": (2048, 1040)}
    else:
        c = get_config(name)
        D, F, hd = c.hidden_size, c.intermediate_size, c.head_dim_
        shapes = {"qkv": (D, (c.num_heads + 2 * c.num_kv_heads) * hd),
                  "o": (c.num_heads * hd, D), "w13": (D, 2 * F), "w2": (F, D)}
    for tag, (K, N) in shapes.items():
        assert K % 64 == 0 and N % 4 == 0         # the kernel's shape rule
        for M in W8_MS:
            tn, tm, ks, cps = W8.tile_plan(M, K, N, sms)
            # column tile x writes 128 x + [0, na), na = min(128, N - 128 x)
            spans = [(128 * x, 128 * x + min(128, N - 128 * x)) for x in range(tn)]
            _check_spans(spans, N)
            assert spans[-1][1] - spans[-1][0] == (N % 128 or 128)
            _check_rows(M, tm)
            for y in range(tm):
                _check_splits(M, K, tn * tm, ks, cps, sms,
                              rows=min(W.TILE_ROWS, M - y * W.TILE_ROWS))
