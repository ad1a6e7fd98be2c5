"""Named model configurations (own copies of every entry in
mobilequant_tpu/models/registry.py, field for field; the port imports nothing
of the JAX package).

  tinyllama-1.1b  : n_layer=22 n_head=32 n_kv=4 head_dim=64 d=2048 ffn=5632 vocab=32000
  gemma-2b        : n_layer=18 n_head=8 n_kv=1 head_dim=256 d=2048 ffn=16384
                    vocab=256000, RMSNorm on (1 + w), gelu_tanh, the embedding
                    scaled by sqrt(d), the head tied to the embedding
  stablelm-2-1.6b : n_layer=24 n_head=32 n_kv=32 head_dim=64 d=2048 ffn=5632
                    vocab=100352, LayerNorm with a bias, rotary on a quarter of
                    each head, a bias on q/k/v only
  qwen2-1.5b      : n_layer=28 n_head=12 n_kv=2 head_dim=128 d=1536 ffn=8960
                    vocab=151936, a bias on q/k/v only, rope theta 1e6, the
                    head tied to the embedding (G = 6 q heads a kv head)
  llama-2-7b      : n_layer=32 n_head=32 n_kv=32 head_dim=128 d=4096 ffn=11008
                    vocab=32000
  llama-3-8b      : n_layer=32 n_head=32 n_kv=8 head_dim=128 d=4096 ffn=14336
                    vocab=128256, rope theta 5e5
  phi-2           : n_layer=32 n_head=32 n_kv=32 head_dim=80 d=2560 ffn=10240
                    vocab=51200, parallel residual, one shared LayerNorm, a
                    2-linear gelu_tanh MLP, biases everywhere, rotary on 0.4
                    of each head

The integer engine (runtime/engine.py) refuses the Phi family (phi-2,
test-phi): their entries serve the HF converter (convert.py) and the FP model
(models/model.py) only.

The small test configurations of the parity tests: test-llama, test-gemma,
test-mixtral, test-stablelm, test-qwen2, test-phi (the JAX package's), and
test-llama-256 / test-stablelm-256 at the narrowest widths the prefill
kernels take (the port's own).
"""

from __future__ import annotations

from mobilequant_tpu_torch.models.config import ModelConfig

MODEL_CONFIGS: dict[str, ModelConfig] = {
    "tinyllama-1.1b": ModelConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_layers=22, num_heads=32, num_kv_heads=4, head_dim=64,
        norm_class="rmsnorm", norm_eps=1e-5, num_linears_per_mlp=3,
        hidden_act="silu", rope_theta=10000.0, max_position_embeddings=2048,
    ),
    "gemma-2b": ModelConfig(
        vocab_size=256000, hidden_size=2048, intermediate_size=16384,
        num_layers=18, num_heads=8, num_kv_heads=1, head_dim=256,
        norm_class="skiprms", norm_eps=1e-6, num_linears_per_mlp=3,
        hidden_act="gelu_tanh", rope_theta=10000.0, max_position_embeddings=8192,
        normalize_embed=True, tie_word_embeddings=True,
    ),
    "stablelm-2-1.6b": ModelConfig(
        vocab_size=100352, hidden_size=2048, intermediate_size=5632,
        num_layers=24, num_heads=32, num_kv_heads=32, head_dim=64,
        norm_class="layernorm", norm_eps=1e-5, num_linears_per_mlp=3,
        hidden_act="silu", rope_theta=10000.0, max_position_embeddings=4096,
        partial_rotary_factor=0.25, use_qkv_bias_only=True,
    ),
    "phi-2": ModelConfig(
        vocab_size=51200, hidden_size=2560, intermediate_size=10240,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=80,
        norm_class="layernorm", norm_eps=1e-5, num_linears_per_mlp=2,
        hidden_act="gelu_tanh", rope_theta=10000.0, max_position_embeddings=2048,
        partial_rotary_factor=0.4, shared_attention_norm=True,
        parallel_residual=True, attention_bias=True,
    ),
    "qwen2-1.5b": ModelConfig(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_layers=28, num_heads=12, num_kv_heads=2, head_dim=128,
        norm_class="rmsnorm", norm_eps=1e-6, num_linears_per_mlp=3,
        hidden_act="silu", rope_theta=1000000.0, max_position_embeddings=32768,
        use_qkv_bias_only=True, tie_word_embeddings=True,
    ),
    "llama-2-7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        norm_class="rmsnorm", norm_eps=1e-5, num_linears_per_mlp=3,
        hidden_act="silu", rope_theta=10000.0, max_position_embeddings=4096,
    ),
    "llama-3-8b": ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        norm_class="rmsnorm", norm_eps=1e-5, num_linears_per_mlp=3,
        hidden_act="silu", rope_theta=500000.0,
        max_position_embeddings=8192,
    ),
    "test-qwen2": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        norm_class="rmsnorm", num_linears_per_mlp=3, hidden_act="silu",
        use_qkv_bias_only=True, max_position_embeddings=128,
    ),
    "test-phi": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
        norm_class="layernorm", num_linears_per_mlp=2, hidden_act="gelu_tanh",
        partial_rotary_factor=0.5, shared_attention_norm=True,
        parallel_residual=True, attention_bias=True,
        max_position_embeddings=128,
    ),
    "test-llama": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=3, num_heads=4, num_kv_heads=2, head_dim=16,
        norm_class="rmsnorm", num_linears_per_mlp=3, hidden_act="silu",
        max_position_embeddings=128,
    ),
    "test-gemma": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=2, num_kv_heads=1, head_dim=32,
        norm_class="skiprms", norm_eps=1e-6, num_linears_per_mlp=3,
        hidden_act="gelu_tanh", normalize_embed=True, tie_word_embeddings=True,
        max_position_embeddings=128,
    ),
    "test-mixtral": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        norm_class="rmsnorm", num_linears_per_mlp=3, hidden_act="silu",
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128,
    ),
    "test-stablelm": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
        norm_class="layernorm", num_linears_per_mlp=3, hidden_act="silu",
        partial_rotary_factor=0.25, use_qkv_bias_only=True,
        max_position_embeddings=128,
    ),
    # test-llama at the narrowest widths the prefill kernels take (head_dim
    # 64, hidden and F multiples of 128): the port's kernel and engine tests
    "test-llama-256": ModelConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
        norm_class="rmsnorm", num_linears_per_mlp=3, hidden_act="silu",
        max_position_embeddings=128,
    ),
    # test-stablelm at the same widths (the JAX kernel tests'
    # stablelm_mha64_partial: MHA, rotary on 16 of 64 head dims)
    "test-stablelm-256": ModelConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=8, num_kv_heads=8, head_dim=64,
        norm_class="layernorm", num_linears_per_mlp=3, hidden_act="silu",
        partial_rotary_factor=0.25, use_qkv_bias_only=True,
        max_position_embeddings=128,
    ),
}


def get_config(name: str) -> ModelConfig:
    if name not in MODEL_CONFIGS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_CONFIGS)}")
    return MODEL_CONFIGS[name]
