"""Weight-only (W4A16 / W8A16) matmul: fp activations × an integer weight,
+ bias -> fp32.

  out = x.float() @ ((q − offset)·scale) + bias

Kernel: csrc/wonly_matmul.cu, which replaces two kernels of the JAX
package's mobilequant_tpu/ops/pallas_matmul.py:
  * wonly_matmul_stacked (_wonly_kernel_stacked; wrapper
    `wonly_matmul_stacked`): x (M <= 8, K) × layer `layer` of a stacked W4
    (L, K/2, N) or W8 (L, K, N) pack with per-tensor (L,), per-channel
    (L, 1, N) or grouped (L, G, 1, N) scales and offsets, + the (L, N) fp32
    bias. The weight-only decode path takes it for every projection
    (runtime/wonly.WeightOnlyOps).
  * w4a16_matmul (_w4a16_kernel; wrapper `w4a16_matmul`): x (any M, K) ×
    one nibble-packed W4 (K/2, N) matrix with per-channel (or per-tensor)
    scales, + bias. No runtime path of the JAX package calls it; its test
    pins it.
Bound: device-memory bytes at M <= 8 (the packed weights, scales and
offsets), the products at M = 128. The scalar edition it replaces
dequantized every weight to fp32 on the CUDA cores and read the weight once
per 8 rows of x. Design: the weight side is the centred integer q − c (W4:
nibble − 8, W8: the int8 byte), exact in bf16; per group the tensor cores
(bf16 mma.sync, fp32 accumulation) form Σ x·(q − c) and, by one more MMA
of ones, Σ x; the offset comes in as the correction
Σ x·(q − offset) = Σ x·(q − c) − (offset − c)·Σ x, beside the scale in
fp32. So any offset is served. fp32 x runs as three bf16 terms (24 bits),
bf16 x as one. Operands swapped (the weight's 16 columns are the MMA's
rows, up to 8 rows of x its columns); above 8 rows a block takes 64 rows of
x, so the weight is read once per 64 rows (8 past 2048 weight rows, whose x
slices 16 splits cannot stage). The weight streams through a cp.async ring. K splits over up to 16 blocks, one
thread-block cluster, which add the splits' sums in order from each other's
shared memory: no float atomics, no workspace. The layer is a pointer
offset from an int: no slice copy. The products are exact, so the kernel
differs from the plain version (fp32 (q − offset)·scale, then an fp32
matmul) by the fp32 rounding of the sums and of the correction (small for
the JAX packs, whose zero-point lies in the code range).

The wrappers launch the kernel for CUDA tensors and run their plain versions
(`wonly_matmul_stacked_plain`, `w4a16_matmul_plain`: qops.weight_only_linear
on the selected layer) for CPU tensors; they never fall back from one to the
other.
"""

from __future__ import annotations

from typing import Optional

import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.qops import weight_only_linear

MAX_ROWS = 8            # the decode gate of runtime/wonly.WeightOnlyOps
MAX_SPLITS = 16         # K splits of a tile: one thread-block cluster (Hopper: up to 16)
_TN = 128               # columns of a block


def _split(device: torch.device, Kr: int, tiles: int, max_rows: int):
    """(rows per split, splits): splits a power of two up to MAX_SPLITS (one
    thread-block cluster), the most that keep the grid within a block a
    streaming multiprocessor (within two for clusters of up to 4: a larger
    cluster of a fuller grid waits for room in a GPC), but enough to keep a
    split within max_rows weight rows; at least 16 rows (one MMA step) a
    split."""
    sms = _build.sm_count(device)
    ks = 1
    while ks < MAX_SPLITS and Kr >= 32 * ks and (
            tiles * 2 * ks <= sms or (2 * ks <= 4 and tiles * 2 * ks <= 2 * sms)
            or _cdiv(Kr, ks) > max_rows):
        ks *= 2
    rps = 16 * _cdiv(_cdiv(Kr, ks), 16)
    if rps > max_rows:
        raise NotImplementedError(f"{Kr} weight rows need more than {MAX_SPLITS} splits")
    return rps, _cdiv(Kr, rps)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plane(v: torch.Tensor, L: int, N: int):
    """(tensor, layer stride, group stride, column stride, groups) of a
    stacked scale / offset: (L,) per tensor, (L, 1, N) per channel, or
    (L, G, 1, N) grouped."""
    if v.dim() == 1:
        return _build.aligned(v.to(torch.float32), 4), 1, 0, 0, 1
    if v.dim() == 3 and v.shape[1] == 1:
        return _build.aligned(v.to(torch.float32)), N, 0, 1, 1
    if v.dim() == 4 and v.shape[2] == 1:
        G = v.shape[1]
        return _build.aligned(v.to(torch.float32)), G * N, N, 1, G
    raise ValueError(f"scale / offset of shape {tuple(v.shape)} for L={L}, N={N}")


def _launch(name: str, x: torch.Tensor, wq_L: torch.Tensor, scale_L, offset_L,
            bias_L: Optional[torch.Tensor], layer: int) -> torch.Tensor:
    M, K = x.shape
    L, Kr, N = wq_L.shape
    bits = 4 if Kr * 2 == K else 8
    dev = _build.require_cuda(x, wq_L, scale_L, offset_L)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be fp32 or bf16, got {x.dtype}")
    if N % 16 or K % 16:
        raise NotImplementedError(f"{name}: K={K}, N={N} (the kernel takes multiples of 16)")
    if not 0 <= layer < L:
        raise IndexError(f"{name}: layer {layer} of {L}")
    sc, sl, sg, sn, G = _plane(scale_L, L, N)
    of, *strides = _plane(offset_L, L, N)
    if strides != [sl, sg, sn, G]:
        raise ValueError(f"{name}: scale and offset shapes differ")
    if G > 1 and (K % G or (bits == 4 and G % 2)):
        raise ValueError(f"{name}: {G} groups for K={K} (W4 needs an even count)")
    if G > 1 and (K // G) % 16:
        raise NotImplementedError(f"{name}: groups of {K // G} rows (the kernel takes "
                                  "multiples of 16)")
    if M > MAX_ROWS and (bits != 4 or G > 1):
        raise NotImplementedError(f"{name}: M={M} rows take W4 per-channel packs only")
    b = None if bias_L is None else _build.aligned(bias_L.to(torch.float32).reshape(L, N), 4)
    xa = _build.aligned(x)
    w = _build.aligned(wq_L)
    # rows of x a block: 64 while the K splits can hold their x slices
    mrows = 64 if M > MAX_ROWS and Kr <= MAX_SPLITS * 128 else 8
    max_rows = 1024 if mrows == 8 else 128      # weight rows a split (x in shared memory)
    if G > 1:
        max_rows = min(max_rows, 16 * (K // G))   # at most 16 groups a split
    rps, ks = _split(dev, Kr, _cdiv(N, _TN) * _cdiv(M, mrows), max_rows)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    code = _build.lib().mqt_wonly_matmul(
        xa.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), bits, sc.data_ptr(),
        of.data_ptr(), sl, sg, sn, G, None if b is None else b.data_ptr(), out.data_ptr(),
        M, K, N, int(layer), rps, ks, _build.stream_ptr(dev))
    _build.check(code, name)
    return out


def wonly_matmul_stacked_plain(x: torch.Tensor, wq_L: torch.Tensor, scale_L: torch.Tensor,
                               offset_L: torch.Tensor, bias_L: Optional[torch.Tensor],
                               layer: int) -> torch.Tensor:
    """The stacked kernel's function in PyTorch operators:
    qops.weight_only_linear of fp32 x on layer `layer`, + its fp32 bias."""
    pack = {"wq": wq_L[layer], "scale": scale_L[layer], "offset": offset_L[layer]}
    bias = None if bias_L is None else bias_L[layer].to(torch.float32)
    return weight_only_linear(x.to(torch.float32), pack, bias)


def wonly_matmul_stacked(x: torch.Tensor, wq_L: torch.Tensor, scale_L: torch.Tensor,
                         offset_L: torch.Tensor, bias_L: Optional[torch.Tensor],
                         layer: int) -> torch.Tensor:
    """fp32 / bf16 x (M <= 8, K) × layer `layer` of a stacked weight-only pack
    (wq (L, K/2, N) W4 or (L, K, N) W8; scale / offset (L,), (L, 1, N) or
    (L, G, 1, N)) + bias (L, N) -> fp32 (M, N)."""
    M, K = x.shape
    if wq_L.shape[1] * 2 != K and wq_L.shape[1] != K:
        raise ValueError(f"wq rows {wq_L.shape[1]} match neither W4 nor W8 for K={K}")
    if M > MAX_ROWS:
        raise NotImplementedError(f"wonly_matmul_stacked: M={M} > {MAX_ROWS}")
    if x.device.type == "cpu":
        wonly_matmul_stacked.plain_calls += 1
        return wonly_matmul_stacked_plain(x, wq_L, scale_L, offset_L, bias_L, layer)
    out = _launch("wonly_matmul_stacked", x, wq_L, scale_L, offset_L, bias_L, layer)
    wonly_matmul_stacked.launches += 1
    return out


wonly_matmul_stacked.launches = 0
wonly_matmul_stacked.plain_calls = 0


def w4a16_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                       offset: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """w4a16_matmul in PyTorch operators: fp32 x × the per-channel W4 dequant."""
    N = wq.shape[-1]
    pack = {"wq": wq, "scale": scale.reshape(1, -1).expand(1, N),
            "offset": offset.reshape(1, -1).expand(1, N)}
    bias = None if bias is None else bias.reshape(-1).to(torch.float32)
    return weight_only_linear(x.to(torch.float32), pack, bias)


def w4a16_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 offset: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 / bf16 x (M, K) × nibble-packed W4 (K/2, N) with per-channel (or
    per-tensor) scale / offset, + bias (N,) -> fp32 (M, N)."""
    M, K = x.shape
    K2, N = wq.shape
    if K2 * 2 != K:
        raise ValueError(f"w4a16_matmul takes a packed (K/2, N) wq, got {K2} rows for K={K}")
    if x.device.type == "cpu":
        w4a16_matmul.plain_calls += 1
        return w4a16_matmul_plain(x, wq, scale, offset, bias)

    def chan(v):                      # (1, 1, N) per channel, (1,) per tensor
        v = v.reshape(-1)
        return v.reshape(1, 1, N) if v.numel() == N else v.reshape(1)
    out = _launch("w4a16_matmul", x, wq.reshape(1, K2, N), chan(scale), chan(offset),
                  None if bias is None else bias.reshape(1, N), 0)
    w4a16_matmul.launches += 1
    return out


w4a16_matmul.launches = 0
w4a16_matmul.plain_calls = 0
