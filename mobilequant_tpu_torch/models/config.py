"""Unified decoder configuration (a copy of mobilequant_tpu/models/config.py;
the port imports nothing of the JAX package).

One config dataclass covers the Llama / Gemma / StableLM (and Phi/Qwen2-shaped)
decoder families. Knobs map 1:1 to the architectural differences:

  norm_class            rmsnorm (llama) | layernorm (stablelm/phi) | skiprms (gemma,
                        weight stored as w-1 in HF; the converter folds the +1 so the
                        runtime always computes plain rmsnorm)
  num_linears_per_mlp   3 = gated SwiGLU/GeGLU (w1·act ⊙ w3 → w2), 2 = plain MLP
  partial_rotary_factor StableLM-2 rotates only the first 25% of head dims
  use_qkv_bias_only     StableLM-2: bias on q/k/v but not o/mlp
  shared_attention_norm / parallel_residual   StableLM-zephyr variants
  normalize_embed       Gemma scales embeddings by sqrt(hidden_size)
  neg_inf               additive causal-mask value: -40000 instead of dtype-min, so
                        that learned softmax-input ranges stay finite.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: Optional[int] = None          # defaults to hidden_size // num_heads

    norm_class: Literal["rmsnorm", "layernorm", "skiprms"] = "rmsnorm"
    norm_eps: float = 1e-5
    num_linears_per_mlp: Literal[2, 3] = 3
    hidden_act: Literal["silu", "gelu_tanh", "gelu"] = "silu"

    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0
    max_position_embeddings: int = 2048

    attention_bias: bool = False            # bias on q/k/v/o
    use_qkv_bias_only: bool = False         # bias on q/k/v only (StableLM-2)
    mlp_bias: bool = False

    shared_attention_norm: bool = False
    parallel_residual: bool = False
    normalize_embed: bool = False           # Gemma: embed * sqrt(hidden_size)
    tie_word_embeddings: bool = False

    # MoE (present in the reference's model zoo, unused by the 3 headline models)
    num_local_experts: int = 1
    num_experts_per_tok: int = 1

    neg_inf: float = -40000.0

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim_

    @property
    def rotary_dim(self) -> int:
        # StableLM-2 uses partial rotary 0.25 (ref hf_model.py:489-501)
        rd = int(self.head_dim_ * self.partial_rotary_factor)
        return rd - (rd % 2)

    @property
    def has_qkv_bias(self) -> bool:
        return self.attention_bias or self.use_qkv_bias_only

    @property
    def has_o_bias(self) -> bool:
        return self.attention_bias and not self.use_qkv_bias_only

    @property
    def has_norm_bias(self) -> bool:
        return self.norm_class == "layernorm"

    @property
    def is_moe(self) -> bool:
        return self.num_local_experts > 1

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
