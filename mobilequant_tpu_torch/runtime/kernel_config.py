"""Typed kernel-dispatch flags of the port's engine.

Only the flags this port dispatches on, with the JAX package's meanings
(mobilequant_tpu/runtime/kernel_config.py). All off = the plain engine: the
same function computed by PyTorch operators alone (the counterpart of the JAX
package's XLA engine body). A flag set routes a site through its kernel
wrapper, which launches the CUDA kernel on a CUDA tensor and runs the kernel's
plain version on a CPU tensor. The kernels take W4 and W8 packs alike (each
in the edition of the pack's bit width) unless a flag says otherwise.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    w4_matmul: bool = False     # nibble-packed W4 projections and the W4 head
                                # through ops/w4a8_matmul (W8 packs take the
                                # plain integer matmul, as in the JAX engine)
    w8_matmul: bool = False     # W8 projections of at most 32 rows through
                                # ops/w8a8_matmul (the JAX "all" set)
    gate_kernel: bool = False   # prefill qkv epilogue kernel (ops/qkv_rope, W4
                                # packs, as in the JAX engine) and w13+gate
                                # epilogue kernel (ops/w13_gate, W4 and W8)
    attn_kernel: bool = False   # attention kernels over the int8 cache: the
                                # prefill kernel (ops/prefill_attention) at
                                # T > 1, the decode kernel
                                # (ops/decode_attention) at T = 1
    stacked_mlp_kernel: bool = False  # whole MLP block in one kernel
                                      # (ops/mlp_block) at B·T <= stacked_bt_max
    otail_kernel: bool = False  # o-proj + resid_add_1 + the whole MLP block in
                                # one kernel (ops/otail.fused_otail_block_w4) at
                                # B·T <= stacked_bt_max; W4 packs only
    stacked_bt_max: int = 64    # the MLP-block and o-tail kernels' row limit
                                # (decode_loop's entry config raises it to 128)
    layer_kernel: bool = False  # whole decoder layer at B=1, T=1
                                # (ops/fused_layer.fused_layer_w4)
    model_kernel: bool = False  # whole decode step, B <= 8, T=1: every layer
                                # and the folded W4 or W8 head
                                # (ops/fused_layer.fused_model_w4)
    chunk_kernel: bool = False  # whole staged decode step, B = 16..128, T=1:
                                # every layer and the folded W4 or W8 head
                                # (ops/chunk_model.fused_model_w4_chunk)
    kv4_attn_kernel: bool = False  # staged decode attention over the int4
                                   # cache, one launch per layer
                                   # (ops/kv4_attention); int4-cache packs only

    @property
    def any_kernel(self) -> bool:
        return (self.w4_matmul or self.w8_matmul or self.gate_kernel or self.attn_kernel
                or self.stacked_mlp_kernel or self.otail_kernel or self.layer_kernel
                or self.model_kernel or self.chunk_kernel or self.kv4_attn_kernel)

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def none(cls) -> "KernelConfig":
        return cls()

    @classmethod
    def prefill(cls) -> "KernelConfig":
        """The main path's prefill set (the JAX package's "w4_attn_gatek")."""
        return cls(w4_matmul=True, gate_kernel=True, attn_kernel=True,
                   stacked_mlp_kernel=True)

    @classmethod
    def decode(cls) -> "KernelConfig":
        """The main path's decode set (the JAX package's default()): one
        whole-model launch per step at B <= 8 on the int8 cache; on the int4
        cache every step is staged and its attention runs the kv4 kernel."""
        return cls(w4_matmul=True, stacked_mlp_kernel=True, layer_kernel=True,
                   model_kernel=True, kv4_attn_kernel=True)

    @classmethod
    def decode_per_layer(cls) -> "KernelConfig":
        """decode() without the whole-model kernel (the JAX package's
        "w4nomodelk"): one whole-layer launch per layer at B=1."""
        return cls.decode().replace(model_kernel=False)

    @classmethod
    def serving(cls, config, packed: dict, batch: int) -> "KernelConfig":
        """decode() as the JAX package's decode_loop makes it for its entry
        point (use_pallas=True): stacked_bt_max raised to 128, so decode steps
        up to B = 128 take the MLP-block kernel, and the chunk kernel switched
        on for W8 packs at 8 < B <= 48 (never for W4 packs; the JAX package
        measured it faster only there, on its TPU)."""
        kc = cls.decode()
        kc = kc.replace(stacked_bt_max=max(kc.stacked_bt_max, 128))
        w13 = packed.get("layers", {}).get("w13_proj")
        if (kc.model_kernel and w13 is not None and 8 < batch <= 48
                and w13["wq"].shape[1] == config.hidden_size):
            kc = kc.replace(chunk_kernel=True)
        return kc

    @classmethod
    def chunk(cls) -> "KernelConfig":
        """The staged serving-batch route with the whole-step chunk kernel
        (the JAX package's "chunkk" set)."""
        return cls.decode().replace(stacked_bt_max=128, chunk_kernel=True)

    @classmethod
    def otail(cls) -> "KernelConfig":
        """The staged serving-batch route with the o-tail kernel in every
        layer (the JAX package's "otail" set)."""
        return cls.decode().replace(stacked_bt_max=128, otail_kernel=True)

    @classmethod
    def attn(cls) -> "KernelConfig":
        """The JAX package's "attn" set: the W4A8 kernel, the attention kernels
        (a T = 1 step writes its row into the cache and runs the decode
        attention kernel), the MLP-block kernel and the kv4 kernel; no
        whole-layer or whole-model kernel."""
        return cls(w4_matmul=True, attn_kernel=True, stacked_mlp_kernel=True,
                   kv4_attn_kernel=True)

    @classmethod
    def attn_all(cls) -> "KernelConfig":
        """The JAX package's "attn_all" set: attn() plus w8_matmul (W8
        projections of at most 32 rows through the W8A8 kernel)."""
        return cls.attn().replace(w8_matmul=True)
