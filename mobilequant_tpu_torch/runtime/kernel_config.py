"""Typed kernel-dispatch flags of the port's engine.

Only the flags this port dispatches on. All off = the plain engine: the same
function computed by PyTorch operators alone (the counterpart of the JAX
package's XLA engine body). A flag set routes a site through its kernel
wrapper, which launches the CUDA kernel on a CUDA tensor and runs the kernel's
plain version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    w4_matmul: bool = False     # nibble-packed W4 projections and the W4 head
                                # through ops/w4a8_matmul
    gate_kernel: bool = False   # prefill qkv epilogue kernel (ops/qkv_rope) and
                                # w13+gate epilogue kernel (ops/w13_gate)
    attn_kernel: bool = False   # prefill attention kernel
                                # (ops/prefill_attention); T>1 only

    @property
    def any_kernel(self) -> bool:
        return self.w4_matmul or self.gate_kernel or self.attn_kernel

    @classmethod
    def none(cls) -> "KernelConfig":
        return cls()

    @classmethod
    def prefill(cls) -> "KernelConfig":
        """The main path's prefill set (the JAX package's "w4_attn_gatek")."""
        return cls(w4_matmul=True, gate_kernel=True, attn_kernel=True)

    @classmethod
    def decode(cls) -> "KernelConfig":
        """The main path's decode set: every W4 projection and the head through
        the W4A8 matmul kernel; decode-light attention in PyTorch."""
        return cls(w4_matmul=True)
