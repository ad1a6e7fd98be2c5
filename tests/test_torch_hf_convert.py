"""The port's HF converter (mobilequant_tpu_torch/models/convert.py) held
against the JAX package's (mobilequant_tpu/models/convert.py) and against
transformers' own models.

Tiny random transformers models of every family the JAX converter takes
(llama, gemma, stablelm, qwen2, mixtral, phi) go through both converters:
the trees are equal leaf for leaf (the same fp32 transposes and Gemma's +1),
and the port's FP model (models/model.py) gives HF's logits at
tests/test_model_parity.py's tolerances (rtol = atol = 2e-4; 3e-4 for
Mixtral). load_checkpoint reads save_pretrained directories: sharded
.safetensors in fp32 and bf16 (the port's own reader) and a .bin checkpoint,
to the tree convert_hf_model makes. No JAX program is compiled here.
"""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from mobilequant_tpu.models import convert as JC
from mobilequant_tpu.models.registry import MODEL_CONFIGS as J_CONFIGS

from mobilequant_tpu_torch.models import convert as C
from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.models.registry import MODEL_CONFIGS

transformers = pytest.importorskip("transformers")

NEW_ENTRIES = ["phi-2", "qwen2-1.5b", "llama-2-7b", "llama-3-8b", "test-qwen2", "test-phi"]


def _common(cfg):
    return dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
                num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
                rope_theta=cfg.rope_theta,
                max_position_embeddings=cfg.max_position_embeddings)


def make_llama(cfg):
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **_common(cfg), head_dim=cfg.head_dim_, rms_norm_eps=cfg.norm_eps,
        attention_bias=False, tie_word_embeddings=False))


def make_gemma(cfg):
    return transformers.GemmaForCausalLM(transformers.GemmaConfig(
        **_common(cfg), head_dim=cfg.head_dim_, rms_norm_eps=cfg.norm_eps,
        hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True))


def make_stablelm(cfg):
    return transformers.StableLmForCausalLM(transformers.StableLmConfig(
        **_common(cfg), layer_norm_eps=cfg.norm_eps,
        partial_rotary_factor=cfg.partial_rotary_factor, use_qkv_bias=True,
        use_parallel_residual=False, tie_word_embeddings=False))


def make_qwen2(cfg):
    return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **_common(cfg), head_dim=cfg.head_dim_, rms_norm_eps=cfg.norm_eps,
        tie_word_embeddings=cfg.tie_word_embeddings))


def make_mixtral(cfg):
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **_common(cfg), head_dim=cfg.head_dim_, rms_norm_eps=cfg.norm_eps,
        num_local_experts=cfg.num_local_experts,
        num_experts_per_tok=cfg.num_experts_per_tok, tie_word_embeddings=False,
        router_aux_loss_coef=0.0))


def make_phi(cfg):
    return transformers.PhiForCausalLM(transformers.PhiConfig(
        **_common(cfg), layer_norm_eps=cfg.norm_eps,
        partial_rotary_factor=cfg.partial_rotary_factor, hidden_act="gelu_new",
        tie_word_embeddings=False))


# family -> (registry config, maker, logits tolerance)
FAMILIES = {
    "llama": ("test-llama", make_llama, 2e-4),
    "gemma": ("test-gemma", make_gemma, 2e-4),
    "stablelm": ("test-stablelm", make_stablelm, 2e-4),
    "qwen2": ("test-qwen2", make_qwen2, 2e-4),
    "mixtral": ("test-mixtral", make_mixtral, 3e-4),
    "phi": ("test-phi", make_phi, 2e-4),
}


def _hf(family, seed=0, cfg=None):
    name, maker, tol = FAMILIES[family]
    cfg = cfg or MODEL_CONFIGS[name]
    torch.manual_seed(seed)
    return cfg, maker(cfg).float().eval(), tol


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_trees_equal(port, ref):
    """port (torch leaves) == ref (numpy / jax / torch leaves), key for key, bit
    for bit."""
    pl, rl = dict(_leaves(port)), dict(_leaves(ref))
    assert sorted(pl) == sorted(rl)
    for k in pl:
        r = rl[k]
        r = r.float().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
        assert tuple(pl[k].shape) == r.shape, k
        np.testing.assert_array_equal(pl[k].float().numpy(), r, err_msg=k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_matches_jax_and_hf_logits(family):
    cfg, hf, tol = _hf(family)
    params = C.convert_hf_model(hf, cfg, family, device="cpu")
    _assert_trees_equal(params, JC.convert_hf_model(hf, J_CONFIGS[FAMILIES[family][0]], family))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 13), dtype=np.int64)
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.float().numpy()
        ours, _ = M.forward(params, torch.from_numpy(tokens), cfg)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("fmt", ["safetensors_fp32", "safetensors_bf16", "bin"])
def test_load_checkpoint_reads_save_pretrained(fmt, tmp_path):
    """A sharded save_pretrained directory (Qwen2: q/k/v biases, the tied
    head) -> load_checkpoint's tree equals convert_hf_model's on the same
    model; bf16 shards convert to the fp32 values of the bf16 weights."""
    cfg = dataclasses.replace(MODEL_CONFIGS["test-qwen2"], tie_word_embeddings=True)
    _, hf, _ = _hf("qwen2", seed=1, cfg=cfg)
    if fmt == "safetensors_bf16":
        hf = hf.to(torch.bfloat16)
    hf.save_pretrained(tmp_path, safe_serialization=fmt != "bin", max_shard_size="40KB")
    suffix = ".bin" if fmt == "bin" else ".safetensors"
    assert len(list(tmp_path.glob("*" + suffix))) > 1            # sharded
    got = C.load_checkpoint(tmp_path, cfg, "qwen2", device="cpu")
    _assert_trees_equal(got, C.convert_hf_model(hf, cfg, "qwen2", device="cpu"))
    assert "lm_head" not in got
    if fmt == "safetensors_bf16":
        half = C.load_checkpoint(tmp_path, cfg, "qwen2", dtype=torch.bfloat16, device="cpu")
        assert half["embed"]["w"].dtype == torch.bfloat16
        assert torch.equal(half["embed"]["w"].float(), got["embed"]["w"])


def _write_safetensors(path, tensors, dtype_name):
    """A minimal .safetensors writer: the header of dtypes, shapes and byte
    offsets, padded to 8 bytes, then the raw bytes."""
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        b = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": dtype_name, "shape": list(t.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    path.write_bytes(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def test_read_safetensors_dtypes(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5), generator=g)
    for dt, name in ((torch.float32, "F32"), (torch.float16, "F16"), (torch.bfloat16, "BF16")):
        _write_safetensors(tmp_path / "a.safetensors", {"x": x.to(dt), "e": x[:0].to(dt)}, name)
        got = C.read_safetensors(tmp_path / "a.safetensors")
        assert got["x"].dtype == dt and torch.equal(got["x"], x.to(dt))
        assert got["e"].shape == (0, 5)
    _write_safetensors(tmp_path / "a.safetensors", {"x": x.to(torch.int8)}, "I8")
    with pytest.raises(ValueError, match="I8"):
        C.read_safetensors(tmp_path / "a.safetensors")


def test_missing_weight_raises_keyerror():
    cfg, hf, _ = _hf("llama")
    sd = dict(hf.state_dict())
    del sd["model.layers.1.mlp.down_proj.weight"]
    with pytest.raises(KeyError, match="model.layers.1.mlp.w2.weight"):
        C.convert_state_dict(sd, cfg, "llama", device="cpu")


@pytest.mark.parametrize("name", NEW_ENTRIES)
def test_new_registry_entries_are_the_jax_ones(name):
    assert dataclasses.asdict(MODEL_CONFIGS[name]) == dataclasses.asdict(J_CONFIGS[name])
