"""The whole MLP block of one layer in one kernel:

  x (M, K) fp32 -> [fq16] -> RMSNorm or LayerNorm -> quantize -> W4 or W8
  w1|w3 -> output fq -> gate chain (SiLU with its sigmoid fq, or gelu_tanh)
  -> fq -> ·g3 -> w2-input int8 -> W4 or W8 w2 -> output fq -> resid_add_2
  -> (M, K) fp32

Kernel: csrc/fused_layer.cu (mqt_fused_mlp_block, dp4a, M <= DP4A_ROWS) and
csrc/fused_rows.cu / fused_rows_w8.cu (mqt_fused_mlp_tiles through
mlp_tiles: the MLP tiles kernel of fused_rows.cuh in its MLP_BLOCK kind, on
the int8 tensor-core tile core of csrc/tc_tile.cuh, DP4A_ROWS < M), which
replace the JAX package's mobilequant_tpu/ops/pallas_mlp.py
fused_mlp_block_w4_stacked
(_w4_mlp_block_kernel, phase body _w4_mlp_phase) in both of its editions: the
JAX kernel takes the bit width from the packs' shapes (W4: w13 (L, K/2, 2F),
w2 (L, F/2, K); W8: (L, K, 2F), (L, F, K)), the port's kernels from the packs'
`bits` field. norm_kind "layernorm" (the JAX kernel's LayerNorm edition, for
StableLM) adds a mean pass before the sum of squares, both fp64, to the norm
stage of either kernel (both read the argument block's `ln` flag: the dp4a
kernel at run time, the row kernel's entry to pick its LayerNorm
instantiation). Bound: the
bytes of the two weight matrices at decode-sized M (<= stacked_bt_max: 64
rows, 128 in the decode loop). Design: one cooperative launch. The dp4a
kernel runs two stages split by a grid barrier: every block normalises and
quantizes the rows itself, the w13 matvec runs over tiles that hold the w1
and w3 columns of 64 gate outputs and finishes the gate chain in the block
that completes a tile; after the barrier the w2 matvec and its
epilogue write the output. In the row kernel the norm is a stage of its own
(one block per row) and the matvec stages run 64-row tiles whose row tiles
of a column tile run side by side, so each weight byte comes once per
128-row step from device memory; K splits meet in the SLABS workspace with
plain stores and a grid barrier (rows_plan mirrors the plan). The (M, F)
int8 gate output is the only intermediate that leaves the chip's caches.

meta is the JAX engine's 32-float _mlp_block_meta (engine._mlp_block_meta):
[0..1] MLP-input encoding, [2..13] the w1 / sigmoid / act / w3 fake-quant
sites, [14..15] the w2-input encoding, [16..18] the norm-input fq16, [19]
norm_eps, [20..31] the w2-output and resid_add_2 fq16 sites; a site is off
when its qmax entry is 0. site_on gives the nine sites' static enables (the
plain version skips a site that is off, as the JAX phase body does).

This module also holds the ctypes mirror of the argument block that the
fused kernels of csrc/fused_layer.cu take (FusedArgs).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.qops import quantize_act
from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack, w4a8_matmul_plain, weight_bits
from mobilequant_tpu_torch.ops.w13_gate import _fq, w13_gate_plain
from mobilequant_tpu_torch.quant.quantizer import true_div

_P = ctypes.c_void_p
_I = ctypes.c_int


class StackedW4(ctypes.Structure):
    """MqtStackedW4: one layer-stacked W4 or W8 pack as the kernels read it."""
    _fields_ = [("wq", _P), ("scale", _P), ("offset", _P), ("colsum", _P),
                ("bias", _P), ("s_l", ctypes.c_longlong), ("s_c", _I),
                ("kin", _I), ("n", _I), ("bits", _I)]


MLP_META_LEN = 46       # 32 MLP-block entries + the o-tail's 14 (ops/otail)


class FusedArgs(ctypes.Structure):
    """MqtFusedArgs of csrc/fused_common.cuh (field for field)."""
    _fields_ = ([(n, _P) for n in (
        "x_in", "x_out", "kv_new", "logits", "pos", "cs", "meta", "ofq", "anw",
        "anb", "mnw", "mnb", "kcache", "vcache", "hwq", "hscale", "hoffset",
        "fnw", "fnb", "yq", "resid", "a8", "act8", "ws", "bar", "trace",
        "kcs", "sk", "sv", "h8", "sx")]
                + [(n, StackedW4) for n in ("qkv", "o", "w13", "w2")]
                + [(n, _I) for n in ("M", "K", "Hq", "Hkv", "hd", "rot", "S", "F",
                                     "Vp", "L", "l0", "l1", "gelu", "ln", "ncs", "mst",
                                     "qk_fq", "pv_fq", "hbits")]
                + [("inv_sqrt_hd", ctypes.c_float),
                   ("mlp_meta", ctypes.c_float * MLP_META_LEN)])


WS_COUNTERS = 8192       # tile counters at the head of the dp4a kernel's split-K workspace
BARRIER = _build.Workspace()   # per-device grid-barrier words
SLABS = _build.Workspace()     # per-device split-K slabs of the row kernels (written
                               # before they are read: never zeroed again)
MAX_ROWS = 128           # rows of the MLP-block, o-tail and chunk kernels
# The MLP block takes the dp4a kernel of csrc/fused_layer.cu up to DP4A_ROWS
# rows and the row kernel of csrc/fused_rows.cu above: on an H100 (80GB HBM3,
# 700 W; chip_smoke.py phase 2) the row kernel's time is flat near 0.045 ms
# for M = 1..8 while the dp4a kernel's grows from 0.032 ms at M=1 through
# 0.044 at M=2 to 0.076 at M=8.
DP4A_ROWS = 2


# the row kernels' matvec stages (csrc/fused_rows.cuh rows_matvec on the tile
# core of csrc/tc_tile.cuh): 64-row x 128-column tiles, K in chunks of 64
# packed rows, at least MIN_SPLIT_CHUNKS chunks a K split
TILE_ROWS, TILE_COLS, CHUNK_ROWS, MIN_SPLIT_CHUNKS = 64, 128, 64, 2
ROW_RING_OFFSET = 640    # RowSmem before the tile ring (fused_rows.cuh RING_OFF)
BLOCKS_PER_SM = 2        # the row kernels' launch bounds: two blocks an SM at most


def ring_bytes(wbits: int) -> int:
    """The tile core's four-stage ring (tc_tile.cuh tc_smem_bytes): a
    64 x 128-byte activation chunk and 64 (W4) or 128 (W8) 128-byte weight
    rows a stage."""
    return 4 * (TILE_ROWS * 128 + (1 if wbits == 4 else 2) * CHUNK_ROWS * TILE_COLS)


def rows_smem(wbits: int) -> int:
    """Dynamic shared memory of the MLP tiles and o-tail kernels (fused_rows.cuh
    rows_smem)."""
    return ROW_RING_OFFSET + ring_bytes(wbits)


def rows_plan(M: int, kin: int, N: int, gate: bool, grid: int) -> tuple:
    """(row tiles, column tiles, chunks, K splits, chunks a split) of one
    matvec stage of M <= 128 rows over kin inputs and N weight columns (gate:
    N = 2F, 64 gate outputs a tile) on a grid of `grid` blocks, as every
    block of the launch computes it (fused_rows.cuh RowPlan): K is split
    only where the tiles leave blocks idle, into as many items as blocks at
    most, with at least MIN_SPLIT_CHUNKS chunks a split."""
    rt = -(-M // TILE_ROWS)
    ct = N // 2 // (TILE_COLS // 2) if gate else -(-N // TILE_COLS)
    nch = -(-(kin // 2) // CHUNK_ROWS)
    ks = 1
    if rt * ct < grid:
        ks = min(grid // (rt * ct), max(1, nch // MIN_SPLIT_CHUNKS))
    cps = -(-nch // ks)
    return rt, ct, nch, -(-nch // cps), cps


def slab_ints(M: int, stages, grid: int) -> int:
    """Ints of the split-K slabs a launch of M <= 128 rows needs over its
    matvec stages ((kin, N, gate) each): a split stage's ks (M, N) partial
    slabs and its (ks, M) row sums."""
    need = 0
    for kin, N, gate in stages:
        ks = rows_plan(M, kin, N, gate, grid)[3]
        if ks > 1:
            need = max(need, ks * M * (N + 1))
    return need


def rows_workspace(dev, rows, stages) -> torch.Tensor:
    """The split-K slabs of a row kernel's launch whose steps take the row
    counts `rows` over its matvec stages ((kin, N, gate) each), at the most
    blocks a launch takes (a K split never shrinks as the grid grows)."""
    grid = BLOCKS_PER_SM * _build.sm_count(dev)
    return SLABS.get(dev, max(slab_ints(M, stages, grid) for M in rows))


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def stacked_w4(pack: dict, keep: list, kin: int) -> StackedW4:
    """The StackedW4 of a layer-stacked pack over kin inputs: W4 {wq (L,
    kin/2, n)} or W8 {wq (L, kin, n)}, scale / offset (L, 1, n) per channel
    or (L,) per tensor, colsum (L, n), bias. Converted operands are appended
    to `keep` so they outlive the launch."""
    wq = _build.aligned(pack["wq"], 16)
    L, _, n = wq.shape
    bits = weight_bits(wq, kin)
    sc = pack["scale"].to(torch.float32).contiguous()
    of = pack["offset"].to(torch.float32).contiguous()
    if sc.shape != of.shape:
        raise ValueError("scale and offset must share one layout")
    if sc.numel() == L:
        s_l, s_c = 1, 0
    elif sc.numel() == L * n:
        s_l, s_c = n, 1
    else:
        raise ValueError(f"scale of {sc.numel()} entries for L={L}, n={n}")
    cs = pack["colsum"].to(torch.float32).contiguous().reshape(L, n)
    b = pack.get("bias")
    b = None if b is None else b.to(torch.float32).contiguous().reshape(L, n)
    keep += [wq, sc, of, cs, b]
    return StackedW4(ptr(wq), ptr(sc), ptr(of), ptr(cs), ptr(b), s_l, s_c,
                     kin, n, bits)


def sum_f32(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Σ over `dim` (keepdim) accumulated in fp64 and rounded once to fp32: the
    same fp32 value whatever the summation order, as the fused kernels sum."""
    return t.to(torch.float64).sum(dim, keepdim=True).to(torch.float32)


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x / sqrt(mean(x²) + eps), the sum of squares by sum_f32, the mean one
    true division by K as in the kernels (true_div: on the card PyTorch
    divides by a host scalar as a multiply by its reciprocal, which for a K
    that is not a power of two, Qwen2-1.5B's 1536, moves the norm by an ulp
    and an int8 rounding at a tie by a step)."""
    return x * (1.0 / torch.sqrt(true_div(sum_f32(x * x), x.shape[-1]) + eps))


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(x − mean(x)) / sqrt(mean((x − mean)²) + eps), both sums by sum_f32,
    both means true divisions (rms_norm)."""
    d = x - true_div(sum_f32(x), x.shape[-1])
    return d * (1.0 / torch.sqrt(true_div(sum_f32(d * d), x.shape[-1]) + eps))


def mlp_block_supported(K: int, F: int) -> bool:
    """Shapes the MLP-block and o-tail row kernels take."""
    return K % 128 == 0 and F % 64 == 0


def pick_block_fh(K: int, half_f: int, wbits: int = 4) -> int:
    """The JAX package's w2 row-block width of its stacked MLP-block kernel
    (pallas_mlp._pick_block_fh); 0: no aligned tiling."""
    per_tfh = 3 * K if wbits == 4 else 6 * K
    cap = max(128, min(1024, (4 * 1024 * 1024) // per_tfh, half_f // 2))
    for t in (1024, 512, 256, 128):
        if t <= cap and half_f % t == 0:
            return t
    return 0


def stacked_mlp_supported(K: int, F: int, wbits: int) -> bool:
    """The JAX engine's gate of its stacked MLP-block and o-tail routes
    (pallas_mlp.w4_mlp_block_supported / w8_mlp_block_supported), with the
    row kernels' own shape rule."""
    return (K % 256 == 0 and F % 256 == 0 and pick_block_fh(K, F // 2, wbits) != 0
            and mlp_block_supported(K, F))


def fused_mlp_block_w4_plain(x: torch.Tensor, norm_w: torch.Tensor,
                             norm_b: torch.Tensor, w13: dict, w2: dict,
                             meta: Sequence[float], act_kind: str = "silu",
                             site_on: tuple = (True,) * 9,
                             norm_kind: str = "rmsnorm") -> torch.Tensor:
    """The kernel's function in PyTorch operators, over one layer's packs and
    norm vectors (K,); the order of fp32 operations is the JAX phase body's,
    the norm's sums are order-independent (sum_f32). norm_kind "layernorm":
    the mean-centred norm."""
    m = [float(v) for v in meta]
    s_x16, s_w1, s_sig, s_act, s_w3, s_w2o, s_r1, s_r2, s_ro = site_on

    def fq(v, i, on):
        return _fq(v, m[i], m[i + 1], m[i + 2]) if on else v

    xf = x.to(torch.float32)
    xx = fq(xf, 16, s_x16)
    norm = layer_norm if norm_kind == "layernorm" else rms_norm
    h8 = quantize_act(norm(xx, m[19]) * norm_w + norm_b, m[0], m[1])
    act8 = w13_gate_plain(h8, w13, m[:16], act_kind, (s_w1, s_sig, s_act, s_w3))
    y2 = w4a8_matmul_plain(act8, w2["wq"], w2["scale"], w2["offset"], w2["colsum"],
                           w2.get("bias"), m[14], m[15])
    y2 = fq(y2, 20, s_w2o)
    xr = fq(xf, 23, s_r1)
    y2 = fq(y2, 26, s_r2)
    return fq(xr + y2, 29, s_ro)


def mlp_pack_bits(K: int, w13: dict, w2: dict) -> int:
    """4 or 8: the bit width of a stacked MLP pack pair (w13 (L, K/2, 2F) and
    w2 (L, F/2, K), or (L, K, 2F) and (L, F, K)); 0 when they fit neither."""
    _, rows, F2 = w13["wq"].shape
    F = F2 // 2
    for bits, div in ((4, 2), (8, 1)):
        if rows * div == K and tuple(w2["wq"].shape[1:]) == (F // div, K):
            return bits
    return 0


def check_mlp_packs(M: int, K: int, w13: dict, w2: dict, act_kind: str, name: str):
    """(L, F) of the stacked W4 or W8 MLP packs; raises on what the kernels
    do not take."""
    L, _, F2 = w13["wq"].shape
    F = F2 // 2
    if not mlp_pack_bits(K, w13, w2):
        raise NotImplementedError(f"the {name} kernel takes W4 or W8 packs")
    if not mlp_block_supported(K, F) or M > MAX_ROWS:
        raise NotImplementedError(f"{name} kernel: M={M}, K={K}, F={F}")
    if act_kind not in ("silu", "gelu_tanh"):
        raise NotImplementedError(f"{name} kernel: act {act_kind!r}")
    return L, F


def check_norm_kind(norm_kind: str, name: str) -> None:
    if norm_kind not in ("rmsnorm", "layernorm"):
        raise NotImplementedError(f"{name} kernel: norm {norm_kind!r}")


def mlp_args(x: torch.Tensor, norm_w, norm_b, w13: dict, w2: dict, meta, layer: int,
             act_kind: str, keep: list, norm_kind: str = "rmsnorm"):
    """(FusedArgs, out) of the dp4a MLP-block launch over x (M, K) with the
    MLP section of its meta; the o-tail fills in its o-proj fields and its
    row-kernel workspace after."""
    M, K = x.shape
    L, F = w13["wq"].shape[0], w13["wq"].shape[2] // 2
    dev = x.device
    xin = _build.aligned(x.to(torch.float32))
    nw = norm_w.to(torch.float32).contiguous()
    nb = norm_b.to(torch.float32).contiguous()
    out = torch.empty((M, K), dtype=torch.float32, device=dev)
    act8 = torch.empty((M, F), dtype=torch.int8, device=dev)
    h8 = torch.empty((M, K), dtype=torch.int8, device=dev)
    resid = torch.empty((M, K), dtype=torch.float32, device=dev)
    keep += [xin, nw, nb, act8, h8, resid]
    a = FusedArgs()
    a.x_in, a.x_out, a.mnw, a.mnb = ptr(xin), ptr(out), ptr(nw), ptr(nb)
    a.act8, a.h8, a.resid = ptr(act8), ptr(h8), ptr(resid)
    a.ws = ptr(_build.WORKSPACE.get(dev, WS_COUNTERS + M * 2 * F))
    a.bar = ptr(BARRIER.get(dev, 2))
    a.w13 = stacked_w4(w13, keep, K)
    a.w2 = stacked_w4(w2, keep, F)
    a.M, a.K, a.F, a.L, a.l0, a.l1 = M, K, F, L, int(layer), int(layer) + 1
    a.gelu = int(act_kind == "gelu_tanh")
    a.ln = int(norm_kind == "layernorm")
    vals = [float(v) for v in meta]
    if len(vals) > MLP_META_LEN:
        raise ValueError(f"a meta of {len(vals)} entries")
    for i, v in enumerate(vals):
        a.mlp_meta[i] = v
    return a, out


MLP_BLOCK, MLP_RAW, MLP_W2 = 0, 1, 2   # modes of mqt_fused_mlp_tiles


def tiles_supported(K: int, F: int) -> bool:
    """Shapes the MLP tiles kernel (any M) takes."""
    return K % 64 == 0 and F % 64 == 0


def layer_stack(pack: dict) -> dict:
    """One layer's pack as a one-layer stack (views, no copy)."""
    return {k: v[None] for k, v in pack.items() if isinstance(v, torch.Tensor)}


def mlp_tiles(mode: int, x: torch.Tensor, w13: dict, w2: dict, meta: Sequence[float],
              layer: int, act_kind: str, norm_w=None, norm_b=None,
              norm_kind: str = "rmsnorm"):
    """Launch the MLP tiles kernel of csrc/fused_rows.cuh over every row of x
    for layer `layer` of the stacked W4 or W8 packs: x (M, K) fp32 with the
    stacked norm vectors (L, K) and the norm's kind (MLP_BLOCK; "layernorm"
    sets a.ln, and the entry launches the LayerNorm instantiation), or int8 (MLP_RAW, MLP_W2)
    -> (out (M, K) fp32, the rows' g8 sums (M,) fp32, written by MLP_RAW)."""
    M, K = x.shape
    R = min(M, MAX_ROWS)
    L, F = w13["wq"].shape[0], w13["wq"].shape[2] // 2
    dev = x.device
    keep = []
    a = FusedArgs()
    if mode == MLP_BLOCK:
        xin = _build.aligned(x.to(torch.float32))
        nw = norm_w.to(torch.float32).contiguous()
        nb = norm_b.to(torch.float32).contiguous()
        h8 = torch.empty((R, K), dtype=torch.int8, device=dev)
        keep += [xin, nw, nb]
        a.x_in, a.mnw, a.mnb = ptr(xin), ptr(nw), ptr(nb)
    else:
        h8 = _build.aligned(x)
    out = torch.empty((M, K), dtype=torch.float32, device=dev)
    rsum = torch.empty((M,), dtype=torch.float32, device=dev)
    act8 = torch.empty((R, F), dtype=torch.int8, device=dev)
    keep += [h8, act8]
    a.x_out, a.h8, a.act8, a.sx = ptr(out), ptr(h8), ptr(act8), ptr(rsum)
    steps = {R, M % MAX_ROWS} - {0}
    a.ws = ptr(rows_workspace(dev, steps, ((K, 2 * F, True), (F, K, False))))
    a.bar = ptr(BARRIER.get(dev, 2))
    a.w13 = stacked_w4(w13, keep, K)
    a.w2 = stacked_w4(w2, keep, F)
    a.M, a.K, a.F, a.L, a.l0, a.l1 = M, K, F, L, int(layer), int(layer) + 1
    a.gelu = int(act_kind == "gelu_tanh")
    a.ln = int(norm_kind == "layernorm")
    vals = [float(v) for v in meta]
    if len(vals) > 32:
        raise ValueError(f"an MLP meta of {len(vals)} entries")
    for i, v in enumerate(vals):
        a.mlp_meta[i] = v
    code = _build.lib().mqt_fused_mlp_tiles(ctypes.addressof(a), mode, _build.stream_ptr(dev))
    return code, out, rsum


def fused_mlp_block_w4(x: torch.Tensor, norm_w: torch.Tensor, norm_b: torch.Tensor,
                       w13: dict, w2: dict, meta: Sequence[float], layer: int,
                       act_kind: str = "silu", site_on: tuple = (True,) * 9,
                       norm_kind: str = "rmsnorm") -> torch.Tensor:
    """x (M, K) fp32 residual -> x + MLP(norm(x)) for layer `layer` of the
    stacked W4 packs (w13 wq (L, K/2, 2F), w2 wq (L, F/2, K)) or W8 packs
    ((L, K, 2F), (L, F, K)) and the stacked norm vectors (L, K); norm_kind
    "rmsnorm" or "layernorm". M <= 128."""
    M, K = x.shape
    check_mlp_packs(M, K, w13, w2, act_kind, "MLP-block")
    check_norm_kind(norm_kind, "MLP-block")
    if x.device.type == "cpu":
        fused_mlp_block_w4.plain_calls += 1
        return fused_mlp_block_w4_plain(x, norm_w[layer], norm_b[layer],
                                        layer_pack(w13, layer), layer_pack(w2, layer),
                                        meta, act_kind, site_on, norm_kind)
    dev = _build.require_cuda(x, norm_w, norm_b, w13["wq"], w2["wq"])
    meta = list(meta)[:32]
    if M <= DP4A_ROWS:
        keep = []
        a, out = mlp_args(x, norm_w, norm_b, w13, w2, meta, layer, act_kind, keep, norm_kind)
        code = _build.lib().mqt_fused_mlp_block(ctypes.addressof(a), _build.stream_ptr(dev))
    else:
        code, out, _ = mlp_tiles(MLP_BLOCK, x, w13, w2, meta, layer, act_kind, norm_w, norm_b,
                                 norm_kind)
    _build.check(code, "fused_mlp_block_w4")
    fused_mlp_block_w4.launches += 1
    return out


fused_mlp_block_w4.launches = 0
fused_mlp_block_w4.plain_calls = 0
