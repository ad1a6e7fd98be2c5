"""Write a decode step's pending K/V rows into column m of the staging buffers.

  sk[:, :, :, m] = pk[:, :, :, 0];  sv[:, :, :, m] = pv[:, :, :, 0]

sk / sv (L, B, Hkv, cs, hd) int8 are the chunk's staged columns of the
chunked-staging decode loop (runtime/engine.decode_loop); pk / pv are the
step's rows (L, B, Hkv, 1, hd), as forward() returns them (views of the chunk
kernel's kv_new are taken as they are: rows of one (layer, sequence) are
contiguous, and the stride between (layer, sequence) groups is an argument).

Kernel: csrc/staged_append.cu, which replaces the JAX package's
mobilequant_tpu/ops/pallas_scatter.py staged_append (_append_kernel). The JAX
kernel exists to make XLA update the buffers in place (input_output_aliases)
and blends an 8-column window because Mosaic needs 8-aligned sublane starts;
here the buffers are updated in place by construction and any column is
addressable, so the kernel copies exactly the 2·L·B·Hkv·hd bytes of the rows,
16 bytes a thread. Bound: those bytes (read once, written once), far below a
launch's fixed cost: the kernel is launch-bound.
"""

from __future__ import annotations

import torch

from mobilequant_tpu_torch.ops import _build


def staged_append_plain(sk: torch.Tensor, sv: torch.Tensor, pk: torch.Tensor,
                        pv: torch.Tensor, m: int):
    """The kernel's function in PyTorch operators (in place)."""
    sk[:, :, :, m] = pk[:, :, :, 0]
    sv[:, :, :, m] = pv[:, :, :, 0]
    return sk, sv


def _group_stride(p: torch.Tensor, L: int, B: int, Hkv: int, hd: int) -> int:
    """Elements between consecutive (layer, sequence) row groups of a pending
    (L, B, Hkv, 1, hd) tensor whose Hkv rows of hd bytes are contiguous; -1
    when its layout is not of that form."""
    if tuple(p.shape) != (L, B, Hkv, 1, hd):
        return -1
    st = p.stride()
    if st[4] != 1 or st[2] != hd or st[0] != B * st[1] or st[1] < Hkv * hd:
        return -1
    return st[1]


def staged_append(sk: torch.Tensor, sv: torch.Tensor, pk: torch.Tensor,
                  pv: torch.Tensor, m: int):
    """(sk, sv) with the pending rows written at column m, in place."""
    L, B, Hkv, cs, hd = sk.shape
    m = int(m)
    if sv.shape != sk.shape or tuple(pk.shape) != (L, B, Hkv, 1, hd) \
            or pv.shape != pk.shape:
        raise ValueError(f"staged_append: sk {tuple(sk.shape)}, pk {tuple(pk.shape)}")
    if not 0 <= m < cs:
        raise ValueError(f"staged_append: column {m} outside [0, {cs})")
    if sk.device.type == "cpu":
        staged_append.plain_calls += 1
        return staged_append_plain(sk, sv, pk, pv, m)
    dev = _build.require_cuda(sk, sv, pk, pv)
    if sk.dtype != torch.int8 or pk.dtype != torch.int8 or hd % 16 \
            or not (sk.is_contiguous() and sv.is_contiguous()):
        raise NotImplementedError("staged_append: contiguous int8 buffers, hd % 16 == 0")
    gk, gv = _group_stride(pk, L, B, Hkv, hd), _group_stride(pv, L, B, Hkv, hd)
    if gk < 0 or gk != gv or (pk.data_ptr() | pv.data_ptr()) % 16:
        pk, pv = pk.contiguous(), pv.contiguous()
        gk = Hkv * hd
    code = _build.lib().mqt_staged_append(
        sk.data_ptr(), sv.data_ptr(), pk.data_ptr(), pv.data_ptr(), L * B, Hkv, cs, hd,
        gk, m, _build.stream_ptr(dev))
    _build.check(code, "staged_append")
    staged_append.launches += 1
    return sk, sv


staged_append.launches = 0
staged_append.plain_calls = 0
