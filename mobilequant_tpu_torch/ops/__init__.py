"""Integer primitives and the hand-written CUDA kernels of the port.

Each kernel wrapper carries two plain integer counts: `launches` (CUDA kernel
launches) and `plain_calls` (runs of its plain PyTorch version on CPU
tensors). A kernel's W4 and W8 editions count on its one wrapper."""

from __future__ import annotations


def kernel_wrappers() -> dict:
    """name -> wrapper function of every kernel of the slice."""
    from mobilequant_tpu_torch.ops.chunk_model import fused_model_w4_chunk
    from mobilequant_tpu_torch.ops.decode_attention import decode_attention
    from mobilequant_tpu_torch.ops.fused_layer import fused_layer_w4, fused_model_w4
    from mobilequant_tpu_torch.ops.fused_mlp import fused_mlp
    from mobilequant_tpu_torch.ops.fused_mlp_block import fused_mlp_block
    from mobilequant_tpu_torch.ops.kv4_attention import kv4_decode_attention
    from mobilequant_tpu_torch.ops.mlp_block import fused_mlp_block_w4
    from mobilequant_tpu_torch.ops.otail import fused_otail_block_w4
    from mobilequant_tpu_torch.ops.prefill_attention import prefill_attention
    from mobilequant_tpu_torch.ops.qkv_rope import qkv_rope
    from mobilequant_tpu_torch.ops.staged_append import staged_append
    from mobilequant_tpu_torch.ops.w13_gate import w13_gate
    from mobilequant_tpu_torch.ops.w13_gate_w2 import w13_gate_w2
    from mobilequant_tpu_torch.ops.w4a8_matmul import w4a8_matmul, w4a8_matmul_stacked
    from mobilequant_tpu_torch.ops.w8a8_matmul import w8a8_matmul
    from mobilequant_tpu_torch.ops.wonly_matmul import w4a16_matmul, wonly_matmul_stacked
    return {"w4a8_matmul": w4a8_matmul, "w4a8_matmul_stacked": w4a8_matmul_stacked,
            "w8a8_matmul": w8a8_matmul, "qkv_rope": qkv_rope,
            "prefill_attention": prefill_attention, "w13_gate": w13_gate,
            "fused_mlp_block_w4": fused_mlp_block_w4, "fused_layer_w4": fused_layer_w4,
            "fused_model_w4": fused_model_w4, "staged_append": staged_append,
            "fused_otail_block_w4": fused_otail_block_w4,
            "fused_model_w4_chunk": fused_model_w4_chunk,
            "kv4_decode_attention": kv4_decode_attention, "decode_attention": decode_attention,
            "wonly_matmul_stacked": wonly_matmul_stacked, "w4a16_matmul": w4a16_matmul,
            "fused_mlp": fused_mlp, "fused_mlp_block": fused_mlp_block,
            "w13_gate_w2": w13_gate_w2}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        fn.plain_calls = 0


def counts(kind: str = "launches") -> dict:
    return {name: getattr(fn, kind) for name, fn in kernel_wrappers().items()}
