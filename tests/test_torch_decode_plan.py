"""Work plans of two kernels, checked on the CPU: the whole-model decode
kernel's ring partition (rows 6 / 7, csrc/fused_layer.cuh, mirrored by
ops/fused_layer.ring_stream and ring_smem) and the w13-gate kernel's tile
plan (row 5, csrc/w13_gate.cu, mirrored by ops/w13_gate.w13_gate_plan).

For every registry edition the port serves on these kernels (TinyLlama,
StableLM, Gemma-2B, and the head-dim-128 Qwen2-1.5B, Llama-3-8B and
Llama-2-7B; W4 and W8; B = 1, 2, 4, 8) and SM counts of 132 (H100 SXM), 114
(H100 PCIe) and 7:
  - every block's chunk stream, walked as the kernel walks it, together
    covers every (stage, layer, 32-column item, sub-item, 512-row chunk) of
    the launch exactly once, the head included;
  - the ring's shared memory (the attention stage's at S = 1024 beside it)
    fits the 232,448 bytes a block may use, with at least two slots;
  - the w13-gate launch covers every (row, gate column) once and every
    packed-row chunk once per tile, for M = 1..2048.
"""

from __future__ import annotations

import functools

import pytest

from mobilequant_tpu_torch.models.registry import get_config
from mobilequant_tpu_torch.ops import fused_layer as FL
from mobilequant_tpu_torch.ops.w13_gate import (
    CHUNK_ROWS, TILE_GATES, TILE_ROWS, w13_gate_plan)

MODELS = ("tinyllama-1.1b", "stablelm-2-1.6b", "gemma-2b")
HD128 = ("qwen2-1.5b", "llama-3-8b", "llama-2-7b")
SMS = (132, 114, 7)
# the rotation's spread of chunks a block, as a share of the mean, where it
# passes 10%: Qwen2-1.5B at 132 SMs (64 qkv, 48 o, 280 w13 and 48 w2 items a
# layer of 2 / 2 / 2 x 2 / 9 chunks, 440 items a layer against 132 blocks) is
# pinned at its value, 15.5% W4 and 20.8% W8 (PERF.md, open questions)
SPREAD = {("qwen2-1.5b", 132, 4): 0.16, ("qwen2-1.5b", 132, 8): 0.21}
S_MAX = 1024


def _dims(name: str, wbits: int):
    c = get_config(name)
    hd, Hq, Hkv = c.head_dim_, c.num_heads, c.num_kv_heads
    K, F, Ko, Nq = c.hidden_size, c.intermediate_size, Hq * hd, (Hq + 2 * Hkv) * hd
    Vp = -(-c.vocab_size // 4096) * 4096          # engine.pack_head's padding
    return c, K, F, Ko, Nq, Vp


@functools.lru_cache(maxsize=None)
def _coverage(name: str, wbits: int, sms: int):
    """(every (stage, layer, item, sub-item, chunk) of the launch once: bool;
    the most and the fewest chunks a block streams; the mean)."""
    c, K, F, Ko, Nq, Vp = _dims(name, wbits)
    dims = FL.ring_plan_dims(K, Ko, Nq, F, wbits, Vp, wbits)
    items, rows = dims
    L = c.num_layers
    nch = [-(-r // FL.RING_ROWS) for r in rows]
    want = {(st, l, i, sub, ch)
            for st in range(5) for l in ([L] if st == 4 else range(L))
            for i in range(items[st]) for sub in range(2 if st == 2 else 1)
            for ch in range(nch[st])}
    seen, per = [], []
    for b in range(sms):
        s = FL.ring_stream(dims, L, sms, b, True)
        seen += s
        per.append(len(s))
    # every column of every stage in an item: 32 columns an item (w13: 32
    # gate outputs, their w1 and w3 columns), the rows in whole chunks
    cols_ok = (items[0] * FL.RING_W == Nq and items[1] * FL.RING_W == K
               and items[2] * FL.RING_W == F and items[3] * FL.RING_W == K
               and items[4] * FL.RING_W == Vp)
    return (len(seen) == len(set(seen)) and set(seen) == want and cols_ok,
            max(per), min(per), len(seen) / sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B", (1, 2, 4, 8))
@pytest.mark.parametrize("wbits", (4, 8))
@pytest.mark.parametrize("name", MODELS + HD128)
def test_ring_plan_covers_each_chunk_once_and_fits(name, wbits, B, sms):
    c, K, F, Ko, Nq, Vp = _dims(name, wbits)
    assert FL.layer_kernel_supported(c, S_MAX)
    once, most, fewest, mean = _coverage(name, wbits, sms)
    assert once                               # every chunk once, none twice
    # the rotation keeps the blocks' shares within a few chunks of the mean
    spread = SPREAD.get((name, sms, wbits))
    if spread is None:
        assert most - fewest <= max(8, 0.1 * mean)
    else:
        assert (most - fewest) / mean <= spread
    MR = 1 << (B - 1).bit_length()
    base, nslot, smem = FL.ring_smem(c.head_dim_, S_MAX, K, FL.kmax_of(K, Ko, F), MR)
    assert 2 <= nslot <= FL.RING_MAX_SLOTS
    assert smem <= FL.SMEM_MAX and base % 128 == 0
    # the attention stage's region lies below the ring
    attn = c.head_dim_ * 24 + 8 * c.head_dim_ * 8 + 4 * (32 if c.head_dim_ <= 128 else 64) \
        + S_MAX * 4 + 256 * c.head_dim_
    assert 1280 + attn <= base


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("name", MODELS + HD128)
def test_w13_gate_plan_covers_each_output_once(name, sms):
    c = get_config(name)
    K, F = c.hidden_size, c.intermediate_size
    nch = -(-(K // 2) // CHUNK_ROWS)
    for M in range(1, 2049):
        tn, tm, ks, cps = w13_gate_plan(M, K, F, sms)
        # gate tiles and row tiles: [0, F) and [0, M) each once, none past
        assert tn * TILE_GATES == F and (tm - 1) * TILE_ROWS < M <= tm * TILE_ROWS
        # the K splits: chunks [z·cps, min(nch, (z+1)·cps)) cover [0, nch)
        # once, none empty
        spans = [(z * cps, min(nch, (z + 1) * cps)) for z in range(ks)]
        assert spans[0][0] == 0 and spans[-1][1] == nch
        assert all(a < b for a, b in spans)
        assert all(spans[z][1] == spans[z + 1][0] for z in range(ks - 1))
        if tn * tm >= sms:
            assert ks == 1
        else:
            assert cps >= 2 or nch < 4
