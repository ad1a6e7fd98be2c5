"""Guards of the port: it imports neither jax nor the JAX package, builds no
kernel on import, and never runs on the CPU when asked for the card."""

import ast
import hashlib
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mobilequant_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "mobilequant_tpu"), \
            f"{path.name} imports {mod}"


def test_importing_every_module_builds_nothing():
    import mobilequant_tpu_torch
    from mobilequant_tpu_torch.ops import _build
    for info in pkgutil.walk_packages(mobilequant_tpu_torch.__path__, "mobilequant_tpu_torch."):
        importlib.import_module(info.name)
    assert _build._lib is None


def test_generator_on_cuda_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this guard is for CPU-only hosts")
    from mobilequant_tpu_torch.convert import build_synthetic_packed
    from mobilequant_tpu_torch.runtime.generate import Generator
    packed, cfg, policy, ecfg = build_synthetic_packed("test-llama-256", max_seq_len=32,
                                                       device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(packed, cfg, policy, ecfg, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        Generator(packed, cfg, policy, ecfg)          # the default device is the card


def test_unported_configurations_raise():
    """What stays unported raises: attn_kernel on the int4 cache (the JAX
    engine refuses it too), MoE configurations and the Phi family (parallel
    residual, a shared attention norm, 2-linear MLPs) in the integer engine.
    W8 packs under the other kernel flags run (test_torch_w8), the o-tail
    kernel among them (test_torch_w2fold_otail), on the int4 cache too: the
    entry config's decode_loop (kc=None) and the prefill kernel set run there
    (test_torch_w8_kv4 holds them against the JAX package). A LayerNorm pack
    (StableLM) under a kernel flag runs the kernels' LayerNorm editions: on
    the CPU their plain versions, one call a layer, not the engine's plain
    path (test_torch_stablelm* hold them against the JAX package)."""
    from mobilequant_tpu_torch import ops
    from mobilequant_tpu_torch.convert import build_synthetic_packed
    from mobilequant_tpu_torch.quant.policy import relax_16bit
    from mobilequant_tpu_torch.runtime import engine as E
    from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
    tok = torch.zeros((1, 1), dtype=torch.long)
    pos = torch.zeros(1, dtype=torch.int32)
    packed, cfg, policy, ecfg = build_synthetic_packed("test-llama-256", max_seq_len=32,
                                                       device="cpu", kv_bits=4)
    policy = relax_16bit(policy)
    with pytest.raises(NotImplementedError):
        E.forward(packed, tok, cfg, policy, kv_cache=E.init_kv_cache(ecfg, 1, device="cpu"),
                  cache_position=pos, kc=KernelConfig.attn())
    with pytest.raises(NotImplementedError):
        E.decode_loop(packed, tok, E.init_kv_cache(ecfg, 1, device="cpu"), pos, 2, cfg,
                      policy, kc=KernelConfig.attn())
    packed, cfg, policy, ecfg = build_synthetic_packed("test-llama-256", w_bits=8,
                                                       max_seq_len=32, device="cpu")
    prompt = torch.zeros((1, 4), dtype=torch.long)
    ops.reset_counts()
    logits, _ = E.forward(packed, prompt, cfg, relax_16bit(policy),
                          kc=KernelConfig(otail_kernel=True))                 # runs
    assert ops.counts("plain_calls")["fused_otail_block_w4"] == cfg.num_layers
    assert bool(torch.isfinite(logits).all())
    E.forward(packed, prompt, cfg, relax_16bit(policy), kc=KernelConfig.prefill())   # runs
    with pytest.raises(NotImplementedError):
        E.forward(packed, tok, cfg.replace(num_local_experts=4, num_experts_per_tok=2),
                  relax_16bit(policy))
    packed, cfg, policy, ecfg = build_synthetic_packed("test-llama-256", w_bits=8,
                                                       max_seq_len=32, device="cpu", kv_bits=4)
    policy = relax_16bit(policy)
    toks, cache, last = E.decode_loop(packed, tok, E.init_kv_cache(ecfg, 1, device="cpu"),
                                      pos, 2, cfg, policy, kc=None)               # runs
    assert toks.shape == (1, 2) and bool(torch.isfinite(last).all())
    E.forward(packed, prompt, cfg, policy, kv_cache=E.init_kv_cache(ecfg, 1, device="cpu"),
              cache_position=pos, kc=KernelConfig.prefill())                      # runs
    E.decode_loop(packed, tok, E.init_kv_cache(ecfg, 1, device="cpu"), pos, 2, cfg, policy,
                  kc=KernelConfig.none())                                         # runs
    for phi in (dict(parallel_residual=True), dict(shared_attention_norm=True),
                dict(num_linears_per_mlp=2, hidden_act="gelu_tanh")):
        with pytest.raises(NotImplementedError):
            E.forward(packed, prompt, cfg.replace(norm_class="layernorm", **phi), policy)
    packed, cfg, policy, ecfg = build_synthetic_packed("test-stablelm-256", max_seq_len=32,
                                                       device="cpu")
    policy = relax_16bit(policy)
    cache = E.init_kv_cache(ecfg, 1, device="cpu")
    E.forward(packed, prompt, cfg, policy, kv_cache=cache, cache_position=pos,
              kv_valid_len=torch.full((1,), 4, dtype=torch.int32))
    p = torch.full((1,), 4, dtype=torch.int32)
    ops.reset_counts()
    logits, _ = E.forward(packed, tok, cfg, policy, positions=p[:, None], kv_cache=cache,
                          cache_position=p, kv_valid_len=p + 1,
                          kc=KernelConfig.decode_per_layer())                     # runs
    plain = ops.counts("plain_calls")
    assert plain["fused_layer_w4"] == cfg.num_layers, plain
    assert bool(torch.isfinite(logits).all())
    ops.reset_counts()
    E.forward(packed, tok, cfg, policy, positions=p[:, None], kv_cache=cache,
              cache_position=p, kv_valid_len=p + 1, kc=KernelConfig.decode())   # runs
    assert {k: v for k, v in ops.counts("plain_calls").items() if v} == {"fused_model_w4": 1}


def test_synthetic_pack_runs_the_plain_path_on_cpu():
    from mobilequant_tpu_torch.convert import build_synthetic_packed
    from mobilequant_tpu_torch.quant.policy import relax_16bit
    from mobilequant_tpu_torch.runtime.generate import Generator
    packed, cfg, policy, ecfg = build_synthetic_packed("test-llama-256", max_seq_len=48,
                                                       device="cpu")
    gen = Generator(packed, cfg, relax_16bit(policy), ecfg, device="cpu")
    prompt = np.arange(20, dtype=np.int32)[None] % cfg.vocab_size
    out = gen.generate_fast(prompt, 6)
    assert out.shape == (1, 6) and (out >= 0).all() and (out < cfg.vocab_size).all()
    np.testing.assert_array_equal(out, gen.generate(prompt, 6))


def _digest(packed: dict) -> str:
    """sha256 (16 hex digits) of every tensor of a packed model, keys sorted."""
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, dict):
            for k in sorted(v):
                if k != "ranges":
                    walk(v[k])
        elif isinstance(v, torch.Tensor):
            h.update(v.contiguous().numpy().tobytes())
    walk(packed)
    return h.hexdigest()[:16]


@pytest.mark.parametrize("head_bits", [4, 8, 16])
@pytest.mark.parametrize("name", ["test-gemma", "gemma-2b", "qwen2-1.5b"])
def test_synthetic_tied_pack_heads_from_the_embedding(name, head_bits, monkeypatch):
    """A tied config's synthetic pack takes its head from the embedding it
    draws, as the JAX pack does: the quantized head is pack_head of the
    embedding's transpose, and the fp head is the embedding itself (no
    lm_head). gemma-2b and qwen2-1.5b keep their widths, cut to 1 layer and
    a 1,024-token vocabulary so that they build on the CPU."""
    from mobilequant_tpu_torch import convert
    from mobilequant_tpu_torch.models import get_config
    from mobilequant_tpu_torch.quant.quantizer import QuantConfig
    from mobilequant_tpu_torch.runtime import engine as E
    if name != "test-gemma":
        monkeypatch.setattr(convert, "get_config", lambda n: get_config(n).replace(
            num_layers=1, vocab_size=1024))
    packed, cfg, policy, ecfg = convert.build_synthetic_packed(
        name, head_bits=head_bits, max_seq_len=32, device="cpu")
    assert cfg.tie_word_embeddings and "lm_head" not in packed
    if name == "gemma-2b":
        assert (cfg.hidden_size, cfg.head_dim_, cfg.num_kv_heads) == (2048, 256, 1)
    if name == "qwen2-1.5b":
        assert (cfg.hidden_size, cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads) == \
            (1536, 128, 12, 2)
        assert packed["layers"]["qkv_proj"]["bias"].abs().max() > 0     # the q/k/v bias
    if head_bits == 16:
        assert "head_q" not in packed
        return
    want = E.pack_head(packed["embed"].T, QuantConfig(bitwidth=head_bits, is_symmetric=True,
                                                      is_per_channel=True))
    assert set(want) == set(packed["head_q"])
    for k, v in want.items():
        assert torch.equal(packed["head_q"][k], v), k


@pytest.mark.parametrize("name,w_bits,head_bits,want", [
    ("test-llama-256", 4, 16, "1e234356676318ac"),
    ("test-stablelm-256", 4, 4, "73c6924e01ff0690"),
    ("test-stablelm-256", 8, 8, "b932e376a0cf7799"),
    ("test-stablelm-256", 4, 16, "c81b2aa47947847f"),
    ("test-llama", 8, 8, "f0551b11c564dc5e")])
def test_synthetic_untied_packs_keep_their_bits(name, w_bits, head_bits, want):
    """Untied packs keep the bits they had before tied configs took their head
    from the embedding (the head is still drawn after the embedding)."""
    from mobilequant_tpu_torch.convert import build_synthetic_packed
    packed, _, _, _ = build_synthetic_packed(name, w_bits=w_bits, head_bits=head_bits,
                                             max_seq_len=32, device="cpu")
    assert _digest(packed) == want


@pytest.mark.parametrize("name", ["llama-3-8b", "llama-2-7b"])
def test_synthetic_untied_hd128_packs(name, monkeypatch):
    """The untied head-dim-128 models' synthetic packs at their widths (cut to
    1 layer and a 1,024-token vocabulary): the fused q|k|v and w1|w3 packs,
    the drawn W4 head, no bias (neither model has one)."""
    from mobilequant_tpu_torch import convert
    from mobilequant_tpu_torch.models import get_config
    monkeypatch.setattr(convert, "get_config", lambda n: get_config(n).replace(
        num_layers=1, vocab_size=1024))
    packed, cfg, _, _ = convert.build_synthetic_packed(name, max_seq_len=32, device="cpu")
    ly = packed["layers"]
    D, F, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    assert (D, hd) == (4096, 128) and not cfg.tie_word_embeddings
    assert ly["qkv_proj"]["wq"].shape == (1, D // 2, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd)
    assert ly["w13_proj"]["wq"].shape == (1, D // 2, 2 * F)
    assert ly["qkv_proj"]["bias"].abs().max() == 0
    assert packed["head_q"]["wq"].shape == (D // 2, 4096)


def test_hf_converter_imports_neither_safetensors_nor_transformers():
    mods = {m.split(".")[0] for m in _imports(PORT / "models" / "convert.py")}
    assert not mods & {"safetensors", "transformers"}, mods
