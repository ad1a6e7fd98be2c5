"""Typed kernel-dispatch flags of the port's engine.

Only the flags this port dispatches on, with the JAX package's meanings
(mobilequant_tpu/runtime/kernel_config.py). All off = the plain engine: the
same function computed by PyTorch operators alone (the counterpart of the JAX
package's XLA engine body). A flag set routes a site through its kernel
wrapper, which launches the CUDA kernel on a CUDA tensor and runs the kernel's
plain version on a CPU tensor. The kernels take W4 and W8 packs alike (each
in the edition of the pack's bit width) unless a flag says otherwise.

Legacy values (the JAX package's use_pallas: a bool or a mode string) map to a
KernelConfig through `coerce`, a copy of the JAX mapping: False / None /
"none" -> nothing; True / "w4" -> decode() (the JAX default set); a string ->
w4_matmul plus a flag per token: "all" w8_matmul, "attn" attn_kernel, "mlp"
(alone: it is also a substring of "mlpblock" and "nomlpk") mlp_kernel,
"mlpblock" mlp_block_kernel, "vpu" vpu_matvec, "gatek" gate_kernel, "w2fold"
w2fold_kernel, "otail" otail_kernel, "chunkk" chunk_kernel; "nokv4k",
"nomlpk", "nolayerk", "nomodelk" switch off the kv4, stacked MLP-block,
whole-layer and whole-model kernels, and an alternate route ("attn", "mlp",
"mlpblock") switches off the whole-layer and whole-model kernels. The JAX
"pad8" token (an XLA row-padding tweak) has no counterpart here.
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
                                # B·T <= stacked_bt_max
    mlp_block_kernel: bool = False  # the whole MLP block on one layer's W8
                                    # packs in one kernel, any B·T
                                    # (ops/fused_mlp_block)
    vpu_matvec: bool = False    # mlp_block_kernel's M = 1 "vpu" formulation
                                # (the same kernel here)
    mlp_kernel: bool = False    # W8 w13 + gate + the raw w2 sums in one
                                # kernel (ops/fused_mlp), the w2 epilogue in
                                # the engine; any B·T
    w2fold_kernel: bool = False  # with gate_kernel: w2 folded into the
                                 # prefill w13+gate kernel (ops/w13_gate_w2)
                                 # where w13_gate_w2_supported
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
                or self.stacked_mlp_kernel or self.otail_kernel or self.mlp_kernel
                or self.mlp_block_kernel or self.layer_kernel or self.model_kernel
                or self.chunk_kernel or self.kv4_attn_kernel)

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def none(cls) -> "KernelConfig":
        return cls()

    @classmethod
    def coerce(cls, mode) -> "KernelConfig":
        """A KernelConfig as it is, or a legacy use_pallas value mapped as the
        JAX package's KernelConfig.coerce maps it."""
        if isinstance(mode, cls):
            return mode
        if mode is None or mode is False or mode == "none":
            return cls.none()
        if mode is True:
            return cls.decode()
        s = str(mode)
        mlp_kernel = "mlp" in s and "mlpblock" not in s and "nomlpk" not in s
        mlp_block = "mlpblock" in s
        alt = "attn" in s or mlp_kernel or mlp_block
        return cls(
            w4_matmul=True,
            w8_matmul="all" in s,
            attn_kernel="attn" in s,
            mlp_kernel=mlp_kernel,
            mlp_block_kernel=mlp_block,
            gate_kernel="gatek" in s,
            otail_kernel="otail" in s,
            chunk_kernel="chunkk" in s,
            kv4_attn_kernel="nokv4k" not in s,
            w2fold_kernel="w2fold" in s,
            vpu_matvec="vpu" in s,
            stacked_mlp_kernel="nomlpk" not in s and not mlp_kernel and not mlp_block,
            layer_kernel="nolayerk" not in s and not alt,
            model_kernel="nomodelk" not in s and not alt,
        )

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
    def serving(cls, config, packed: dict, batch: int, mode=True) -> "KernelConfig":
        """A legacy use_pallas value (True: decode(), the entry point's) as
        the JAX package's decode_loop makes it: stacked_bt_max raised to 128,
        so decode steps up to B = 128 take the MLP-block kernel, and the chunk
        kernel switched on beside the whole-model kernel for W8 packs at
        8 < B <= 48 (never for W4 packs; the JAX package measured it faster
        only there, on its TPU)."""
        kc = cls.coerce(mode)
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
        layer (the JAX package's "otail" set, with the gate raised to 128
        rows), W4 and W8."""
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
