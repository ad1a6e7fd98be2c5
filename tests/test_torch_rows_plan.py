"""Launch plans of the row kernels' matvec stages, checked on the CPU: the
chunk step (row 11), the MLP tiles kernel (rows 8, 16, 17, 19) and the o-tail
(row 18) run every matvec stage on the tile core of csrc/tc_tile.cuh
(csrc/fused_rows.cuh rows_matvec, its plan RowPlan mirrored by
ops/mlp_block.rows_plan); the item order, the column maps, the K splits'
slabs and the output walks are mirrored here from the kernel.

For the registry's TinyLlama-1.1B, StableLM-2-1.6B and Gemma-2B widths, W4
and W8, B = 16, 17, 32, 33, 48, 64, 65, 128 and SM counts of 132 (H100 SXM),
114 (H100 PCIe) and 7, on grids of one and two blocks an SM:
  - each (row, column) of every stage (qkv, o, the w13 gate, w2, the head at
    its padded width) is produced once: by its tile, or after a K split by
    the epilogue walk over the grid; each packed-row chunk is read once per
    tile, by one split of at least 2 chunks; the slabs fit the workspace the
    wrappers allocate;
  - the MLP tiles kernel's walk over 128-row steps covers M = 1024;
  - the shared-memory union (the tile ring of the widest weights, the
    attention stages' layouts) fits 227 KB a block at the two blocks an SM
    the launch asks for.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np
import pytest

from mobilequant_tpu_torch.models.registry import get_config
from mobilequant_tpu_torch.ops import chunk_model as C
from mobilequant_tpu_torch.ops import mlp_block as MB

MODELS = ("tinyllama-1.1b", "stablelm-2-1.6b", "gemma-2b", "qwen2-1.5b", "llama-3-8b",
          "llama-2-7b")
BS = (16, 17, 32, 33, 48, 64, 65, 128)
SMS = (132, 114, 7)
FT = 256                        # threads a block (fused_common.cuh)
BLOCK_SMEM = 227 * 1024         # shared memory a block can use (H100)
SM_SMEM = 228 * 1024            # an SM's, 1 KB of it reserved a block
CSRC = Path(MB.__file__).resolve().parents[1] / "csrc"


def _stages(name: str, head: bool = True):
    """{stage: (kin, N, gate)} of a model's row-kernel matvec stages; the head
    at engine.pack_head's padded width."""
    c = get_config(name)
    D, F, hd = c.hidden_size, c.intermediate_size, c.head_dim_
    Nq = (c.num_heads + 2 * c.num_kv_heads) * hd
    st = {"qkv": (D, Nq, False), "o": (c.num_heads * hd, D, False), "gate": (D, 2 * F, True),
          "w2": (F, D, False)}
    if head:
        st["head"] = (D, -(-c.vocab_size // 4096) * 4096, False)
    return st


def _colmap(c: int, N: int, gate: bool):
    """(colA, colB, split, na, nb) of column tile c (rows_matvec's ColMap)"""
    if gate:
        F = N // 2
        return 64 * c, F + 64 * c, 64, 64, 64
    return 128 * c, 0, 128, min(128, N - 128 * c), 0


def _tile_cols(cm):
    """the weight columns a tile reads, by local column (valid ones only)"""
    colA, colB, split, na, nb = cm
    return [colA + n if n < split else colB + n - split
            for n in range(128) if (n < na if n < split else n - split < nb)]


@functools.lru_cache(maxsize=None)
def _check_columns(N: int, gate: bool, ct: int) -> bool:
    """the tiles' weight columns cover [0, N) once (the gate: w1 column j
    beside w3 column F + j at the same local column), and their outputs
    cover the stage's outputs once"""
    maps = [_colmap(c, N, gate) for c in range(ct)]
    cols = np.concatenate([_tile_cols(cm) for cm in maps])
    assert np.array_equal(np.sort(cols), np.arange(N))
    assert not gate or all(cm[1] - cm[0] == N // 2 for cm in maps)
    no = N // 2 if gate else N
    outs = np.concatenate([[n for n in _tile_cols(cm) if n < no] for cm in maps])
    assert np.array_equal(np.sort(outs), np.arange(no))
    return True


def _check_stage(M: int, kin: int, N: int, gate: bool, grid: int):
    rt, ct, nch, ks, cps = MB.rows_plan(M, kin, N, gate, grid)
    assert (nch - 1) * MB.CHUNK_ROWS < kin // 2 <= nch * MB.CHUNK_ROWS
    assert rt == -(-M // 64) <= 2
    # the splits: non-empty spans [sp·cps, min(nch, (sp+1)·cps)) covering
    # the chunks once, at least MIN_SPLIT_CHUNKS each; split only below the grid
    spans = [(sp * cps, min(nch, (sp + 1) * cps)) for sp in range(ks)]
    assert spans[0][0] == 0 and spans[-1][1] == nch
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(ks - 1))
    if ks > 1:
        assert rt * ct * ks <= grid and cps >= MB.MIN_SPLIT_CHUNKS
    else:
        assert 2 * rt * ct > grid or nch < 2 * MB.MIN_SPLIT_CHUNKS
    # item it -> (row tile, split, column tile): every triple once, the row
    # tiles of a (column tile, split) on consecutive items
    items = [(it % rt, (it // rt) % ks, it // (rt * ks)) for it in range(rt * ct * ks)]
    assert sorted(items) == sorted((y, sp, c) for y in range(rt) for sp in range(ks)
                                   for c in range(ct))
    assert all(items[i][1:] == items[i + rt - 1][1:] for i in range(0, len(items), rt))
    assert _check_columns(N, gate, ct)
    # each output (r, c) once: unsplit, from its tile (the row tiles
    # partition the rows, the tiles' output columns the outputs); split,
    # from the epilogue walk: thread t of block b takes i = b·FT + t + k·grid·FT,
    # whose residues modulo grid·FT are distinct and cover them all
    rows = np.concatenate([np.arange(64 * y, min(M, 64 * y + 64)) for y in range(rt)])
    assert np.array_equal(rows, np.arange(M))
    if ks > 1:
        res = (np.arange(grid)[:, None] * FT + np.arange(FT)).ravel()
        assert np.array_equal(np.sort(res), np.arange(grid * FT))
        # slab sp of (ks, M, N) partials, then the (ks, M) row sums: inside
        # what the wrappers allocate (at the most blocks a launch takes)
        assert ks * M * N + ks * M <= MB.slab_ints(M, [(kin, N, gate)], grid)
    return ks


@pytest.mark.parametrize("per_sm", (1, 2))
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("name", MODELS)
def test_rows_plan_produces_each_output_once(name, sms, per_sm):
    grid = per_sm * sms
    for M in BS:
        stages = _stages(name)
        for tag, (kin, N, gate) in stages.items():
            _check_stage(M, kin, N, gate, grid)
        # the workspace sized at two blocks an SM covers any grid up to it
        need = MB.slab_ints(M, stages.values(), grid)
        assert need <= MB.slab_ints(M, stages.values(), MB.BLOCKS_PER_SM * sms)


def test_rows_plan_splits_the_small_stages():
    """TinyLlama at B = 32 on 132 SMs, two blocks each: the o and qkv stages
    take 8 splits of 2 chunks, the gate 3, w2 15, the head none."""
    st = _stages("tinyllama-1.1b")
    ks = {tag: MB.rows_plan(32, kin, N, gate, 264)[3] for tag, (kin, N, gate) in st.items()}
    assert ks == {"qkv": 8, "o": 8, "gate": 3, "w2": 15, "head": 1}


@pytest.mark.parametrize("M", (1, 3, 17, 65, 128, 200, 1024))
def test_mlp_tiles_walk_covers_every_row(M):
    """the MLP tiles kernel's walk: 128-row steps m0 = 0, 128, ... of
    min(128, M - m0) rows, each step's stages on at most two row tiles; the
    workspace sized for the steps' row counts covers every step"""
    steps = [(m0, min(MB.MAX_ROWS, M - m0)) for m0 in range(0, M, MB.MAX_ROWS)]
    rows = np.concatenate([np.arange(m0, m0 + n) for m0, n in steps])
    assert np.array_equal(rows, np.arange(M))
    K, F = 2048, 5632
    stages = ((K, 2 * F, True), (F, K, False))
    sizes = {n for _, n in steps}
    assert sizes == {min(M, MB.MAX_ROWS), M % MB.MAX_ROWS or MB.MAX_ROWS} - {0}
    need = max(MB.slab_ints(n, stages, 264) for n in sizes)
    for n in sizes:
        for kin, N, gate in stages:
            ks = _check_stage(n, kin, N, gate, 264)
            if ks > 1:
                assert ks * n * (N + 1) <= need


@pytest.mark.parametrize("name", MODELS)
def test_row_kernels_shared_memory_fits_two_blocks(name):
    c = get_config(name)
    G = c.num_heads // c.num_kv_heads
    for wb in (4, 8):
        sizes = [MB.rows_smem(wb)]
        for hb in (0, 4, 8):
            for S, ncs in ((1024, 32), (2048, 32)):
                sizes.append(C.chunk_smem(wb, hb, c.head_dim_, S, ncs, G))
        for sm in sizes:
            assert sm <= BLOCK_SMEM
            assert MB.BLOCKS_PER_SM * (sm + 1024) <= SM_SMEM, (wb, sm)
    # the ring and its offset as the kernels lay them out
    src = (CSRC / "fused_rows.cuh").read_text()
    assert int(re.search(r"constexpr int RING_OFF = (\d+);", src).group(1)) \
        == MB.ROW_RING_OFFSET
    tc = (CSRC / "tc_tile.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (TC_\w+) = (\d+);", tc)}
    assert (consts["TC_BM"], consts["TC_BN"], consts["TC_KP"], consts["TC_STAGES"]) \
        == (MB.TILE_ROWS, MB.TILE_COLS, MB.CHUNK_ROWS, 4)
    assert MB.ring_bytes(4) == 65536 and MB.ring_bytes(8) == 98304
