"""HF checkpoint -> the port's layer-stacked FP parameter tree (the port of
mobilequant_tpu/models/convert.py).

  * the same family rename maps (gate / down / up_proj -> w1 / w2 / w3, Phi's
    dense -> o_proj, fc1 / fc2 -> w1 / w2, final_layernorm -> norm; Mixtral's
    block_sparse_moe -> mlp);
  * Gemma's norm weights get the +1 folded in, so the runtime computes plain
    RMSNorm;
  * every linear weight is transposed to (in, out) for `x @ w`, and zero biases
    are made where the architecture has none (models/model.py's tree).

The tree is the one models/model.py, quant/* and runtime/engine.pack take:
{"embed": {"w"}, "layers": {...}, "norm": {"w", "b"}[, "lm_head": {"w"}]},
each per-layer leaf stacked over the layers (MoE experts over (L, E)).

convert_state_dict takes any {name: tensor or numpy array} state dict;
load_checkpoint reads a checkpoint directory: `.safetensors` shards through
the reader below (the format's own layout: an 8-byte little-endian header
length, a JSON header of dtype, shape and byte offsets, then the raw bytes;
F32, F16 and BF16), or PyTorch `.bin` shards through torch.load(...,
weights_only=True). A checkpoint's tensors stay on the host until a stacked
leaf is built; each leaf then moves to `device` in the target dtype, so a
full-width checkpoint is never held twice on the card.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from mobilequant_tpu_torch.models.config import ModelConfig

# family-specific HF name -> unified name fragments
WEIGHT_RENAME_MAPS = {
    "llama": {"gate_proj": "w1", "down_proj": "w2", "up_proj": "w3"},
    "mistral": {"gate_proj": "w1", "down_proj": "w2", "up_proj": "w3"},
    "gemma": {"gate_proj": "w1", "down_proj": "w2", "up_proj": "w3"},
    "stablelm": {"gate_proj": "w1", "down_proj": "w2", "up_proj": "w3"},
    "qwen2": {"gate_proj": "w1", "down_proj": "w2", "up_proj": "w3"},
    "phi": {"fc1": "w1", "fc2": "w2", "dense": "o_proj", "final_layernorm": "norm"},
    "mixtral": {"block_sparse_moe": "mlp"},
}

# safetensors dtype names -> torch dtypes (the ones a float checkpoint holds)
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def rename_key(name: str, model_type: str) -> str:
    for a, b in WEIGHT_RENAME_MAPS.get(model_type, {}).items():
        if a in name:
            return name.replace(a, b)
    return name


def _host_f32(x) -> torch.Tensor:
    """A state-dict value (torch tensor on any device, or array-like) as an
    fp32 tensor on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def convert_state_dict(sd: Mapping[str, object], config: ModelConfig,
                       model_type: str = "llama", dtype=torch.float32,
                       device="cuda") -> dict:
    """An HF state dict ({name: tensor or array}) -> the stacked parameter
    tree on `device`, each leaf in `dtype` (fp32 arithmetic on the host
    first: the transposes and Gemma's +1, as the JAX converter computes
    them)."""
    c = config
    dev = torch.device(device)
    sd = {rename_key(k, model_type): v for k, v in sd.items()}
    is_gemma = model_type == "gemma" or c.norm_class == "skiprms"
    L, D, F = c.num_layers, c.hidden_size, c.intermediate_size
    qd, kvd = c.q_dim, c.kv_dim

    def get(name, transpose=False, plus_one=False, required=True):
        if name not in sd:
            if required:
                raise KeyError(f"missing weight {name!r}; have e.g. {sorted(sd)[:8]}")
            return None
        w = _host_f32(sd[name])
        if transpose:
            w = w.T
        if plus_one:
            w = w + 1.0
        return w

    def leaf(w):
        return w.contiguous().to(device=dev, dtype=dtype)

    def stack(fmt, transpose=False, plus_one=False, zeros_shape=None):
        out = []
        for i in range(L):
            w = get(fmt.format(i=i), transpose=transpose, plus_one=plus_one,
                    required=zeros_shape is None)
            out.append(torch.zeros(zeros_shape) if w is None else w)
        return leaf(torch.stack(out))

    P = "model.layers.{i}."
    layers = {
        "attn_norm": {
            "w": stack(P + "input_layernorm.weight", plus_one=is_gemma),
            "b": stack(P + "input_layernorm.bias", zeros_shape=(D,)),
        },
        "q_proj": {"w": stack(P + "self_attn.q_proj.weight", transpose=True),
                   "b": stack(P + "self_attn.q_proj.bias", zeros_shape=(qd,))},
        "k_proj": {"w": stack(P + "self_attn.k_proj.weight", transpose=True),
                   "b": stack(P + "self_attn.k_proj.bias", zeros_shape=(kvd,))},
        "v_proj": {"w": stack(P + "self_attn.v_proj.weight", transpose=True),
                   "b": stack(P + "self_attn.v_proj.bias", zeros_shape=(kvd,))},
        "o_proj": {"w": stack(P + "self_attn.o_proj.weight", transpose=True),
                   "b": stack(P + "self_attn.o_proj.bias", zeros_shape=(D,))},
    }
    if c.is_moe:
        E = c.num_local_experts

        def stack_experts(wname):
            # "model.layers.{i}.mlp.experts.{e}.w1.weight" (Mixtral's layout
            # after the block_sparse_moe -> mlp rename)
            return leaf(torch.stack([
                torch.stack([get(f"model.layers.{i}.mlp.experts.{e}.{wname}.weight",
                                 transpose=True) for e in range(E)])
                for i in range(L)]))

        def zeros(*shape):
            return torch.zeros(shape, device=dev, dtype=dtype)

        layers["router"] = {"w": stack(P + "mlp.gate.weight", transpose=True)}
        layers["w1"] = {"w": stack_experts("w1"), "b": zeros(L, E, F)}
        layers["w2"] = {"w": stack_experts("w2"), "b": zeros(L, E, D)}
        if c.num_linears_per_mlp == 3:
            layers["w3"] = {"w": stack_experts("w3"), "b": zeros(L, E, F)}
    else:
        layers["w1"] = {"w": stack(P + "mlp.w1.weight", transpose=True),
                        "b": stack(P + "mlp.w1.bias", zeros_shape=(F,))}
        layers["w2"] = {"w": stack(P + "mlp.w2.weight", transpose=True),
                        "b": stack(P + "mlp.w2.bias", zeros_shape=(D,))}
        if c.num_linears_per_mlp == 3:
            layers["w3"] = {"w": stack(P + "mlp.w3.weight", transpose=True),
                            "b": stack(P + "mlp.w3.bias", zeros_shape=(F,))}
    if not c.shared_attention_norm:
        layers["mlp_norm"] = {
            "w": stack(P + "post_attention_layernorm.weight", plus_one=is_gemma),
            "b": stack(P + "post_attention_layernorm.bias", zeros_shape=(D,)),
        }

    norm_b = get("model.norm.bias", required=False)
    params = {
        "embed": {"w": leaf(get("model.embed_tokens.weight"))},
        "layers": layers,
        "norm": {"w": leaf(get("model.norm.weight", plus_one=is_gemma)),
                 "b": leaf(norm_b if norm_b is not None else torch.zeros(D))},
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = {"w": leaf(get("lm_head.weight", transpose=True))}
    return params


def convert_hf_model(hf_model, config: ModelConfig, model_type: str = "llama",
                     dtype=torch.float32, device="cuda") -> dict:
    """A live transformers model -> the stacked parameter tree."""
    return convert_state_dict(hf_model.state_dict(), config, model_type, dtype, device)


def read_safetensors(path: str | Path) -> dict:
    """{name: tensor} of one .safetensors file, on the host: the file is read
    once into memory and every tensor is a view of it (torch.frombuffer)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(bytes(data[8:8 + n]).decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"the reader takes {sorted(_ST_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        numel = int(np.prod(shape, dtype=np.int64))
        if end - begin != numel * dt.itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes for "
                             f"shape {shape} {info['dtype']}")
        t = (torch.frombuffer(data, dtype=dt, count=numel, offset=base + begin) if numel
             else torch.empty(0, dtype=dt))
        out[name] = t.reshape(shape)
    return out


def load_checkpoint(checkpoint_dir: str | Path, config: ModelConfig,
                    model_type: str = "llama", dtype=torch.float32,
                    device="cuda") -> dict:
    """An HF checkpoint directory (.safetensors or PyTorch .bin shards) -> the
    stacked parameter tree on `device`."""
    checkpoint_dir = Path(checkpoint_dir)
    sd: dict = {}
    st_files = sorted(checkpoint_dir.glob("*.safetensors"))
    bin_files = sorted(checkpoint_dir.glob("*.bin"))
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(f))
    elif bin_files:
        for f in bin_files:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
    else:
        raise FileNotFoundError(f"no .safetensors/.bin files in {checkpoint_dir}")
    return convert_state_dict(sd, config, model_type, dtype, device)
