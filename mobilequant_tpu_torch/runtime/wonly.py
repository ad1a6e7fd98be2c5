"""Weight-only (W4A16 / W8A16) serving mode (the port of
mobilequant_tpu/runtime/wonly.py): the auto_gptq-style path where the
activations and the KV cache stay floating point and only the weights are
integer, dequantized on the fly.

  pack_weight_only()  FP params (models/model layout) -> skeleton + packs
  WeightOnlyOps       the FP model's Ops with every projection on its pack
  init_kv_cache()     the fp KV cache (L, B, S, Hkv, hd) in act_dtype
  forward()           prefill / decode through models/model.forward_hidden
  decode_loop()       one T = 1 forward a step, sampled with loop_next_token

The forward IS the FP model: `WeightOnlyOps.linear` swaps each projection's
fp weight for its pack. Two routes per call site, as in the JAX package:
  * decode-sized calls (rows <= 8, with a layer index) under a kernel flag:
    the wonly_matmul_stacked kernel (ops/wonly_matmul.py) reads layer `li`
    straight out of the stacked pack, dequantizes in registers and adds the
    packs' fp32 bias; its fp32 output is cast to the activations' dtype;
  * everything else (the prefill, or no kernel): qops.weight_only_linear on
    the layer's slice, with the skeleton's bias in act_dtype.
The head is the fp head (x.float() @ head_w.float()), or with head_bits 8 / 4
the quantized head of the integer engine (engine.quantized_head_logits: a W4
head at decode rows through the W4A8 kernel under a kernel flag).
"""

from __future__ import annotations

from typing import Optional

import torch

from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.ops import qops
from mobilequant_tpu_torch.ops.wonly_matmul import MAX_ROWS, wonly_matmul_stacked
from mobilequant_tpu_torch.quant.policy import WEIGHT_ONLY_PROJ_KEYS as _PROJ_KEYS
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime.engine import pack_head, quantized_head_logits
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
from mobilequant_tpu_torch.runtime.sampling import loop_next_token


def default_weight_cfg(weight_bits: int = 4, group_size: int = 128) -> QuantConfig:
    """The auto_gptq default: grouped per-channel asymmetric, g128."""
    return QuantConfig(bitwidth=weight_bits, is_per_channel=True,
                       group_size=group_size, is_symmetric=False)


def _check_groups(config: ModelConfig, wcfg: QuantConfig) -> None:
    gs = wcfg.group_size
    if gs == -1:
        return
    d_ins = {"q_proj": config.hidden_size, "k_proj": config.hidden_size,
             "v_proj": config.hidden_size, "o_proj": config.q_dim,
             "w1": config.hidden_size, "w3": config.hidden_size,
             "w2": config.intermediate_size}
    for k, d in d_ins.items():
        if d % gs or (wcfg.bitwidth == 4 and (d // gs) % 2 and d // gs != 1):
            raise ValueError(f"group_size {gs} must divide {k}'s input dim {d} evenly "
                             "(and into an even group count for W4 nibble halves)")


def pack_weight_only(params: dict, config: ModelConfig, wcfg: QuantConfig,
                     act_dtype=torch.float32, head_bits: int = 16) -> dict:
    """FP params (models/model layout, torch tensors on one device) -> the
    weight-only packed model {"skeleton", "packs"[, "head_q"]}.

    packs[key]: the layer-stacked pack of each projection (wq; scale and
    offset (L,), (L, 1, N) or (L, G, 1, N); no colsum, which only an integer
    activation needs) with its bias in fp32, (L, N). The skeleton keeps
    everything else (embeddings, norms, biases, router, lm_head) in act_dtype;
    projection weights become (L, 1, 1) placeholders. head_bits 8 / 4 adds the
    per-channel symmetric head pack (engine.pack_head) and, for an untied
    head, replaces the fp head by a (1, 1) placeholder."""
    _check_groups(config, wcfg)

    def cast(t):
        return t.to(act_dtype) if torch.is_floating_point(t) else t

    def cast_tree(tree):
        return {k: cast_tree(v) if isinstance(v, dict) else cast(v) for k, v in tree.items()}

    packs, skeleton_layers = {}, {}
    for key, entry in params["layers"].items():
        if key in _PROJ_KEYS and "w" in entry:
            w = entry["w"]
            flat = w.reshape(-1, *w.shape[-2:])          # (L, K, N) or (L·E, K, N)
            per = [qops.pack_weight(flat[i], wcfg) for i in range(flat.shape[0])]
            pk = {k: torch.stack([p[k] for p in per]).reshape(*w.shape[:-2], *per[0][k].shape)
                  for k in ("wq", "scale", "offset")}
            pk["bias"] = entry["b"].to(torch.float32)
            packs[key] = pk
            skeleton_layers[key] = {"w": torch.zeros((w.shape[0], 1, 1), dtype=act_dtype,
                                                     device=w.device),
                                    "b": entry["b"].to(act_dtype)}
        else:
            skeleton_layers[key] = cast_tree(entry)
    skeleton = {k: (skeleton_layers if k == "layers" else cast_tree(v))
                for k, v in params.items()}
    packed = {"skeleton": skeleton, "packs": packs}
    if head_bits in (4, 8):
        head_w = (params["embed"]["w"].T if config.tie_word_embeddings
                  else params["lm_head"]["w"])
        packed["head_q"] = pack_head(head_w.to(torch.float32), QuantConfig(
            bitwidth=head_bits, is_symmetric=True, is_per_channel=True))
        if not config.tie_word_embeddings:
            skeleton["lm_head"] = {"w": torch.zeros((1, 1), dtype=act_dtype,
                                                    device=head_w.device)}
    return packed


class WeightOnlyOps(M.Ops):
    """Ops that run every projection against its weight-only pack. The layer
    index comes through begin_layer (layer_extras {"li": ...}); a plain-route
    call slices only the pack it reads."""

    def __init__(self, packs: dict, use_kernel: bool = False):
        self.packs = packs
        self.use_kernel = use_kernel
        self._li: Optional[int] = None

    def begin_layer(self, extras):
        self._li = extras.get("li") if extras is not None else None

    def _sliced(self, key: str) -> dict:
        return {k: v[self._li] for k, v in self.packs[key].items()}

    def linear(self, site, x, w, b):
        key = site.split(".")[-1]
        if key not in self.packs:
            return x @ w + b
        rows = x.numel() // x.shape[-1]
        if self.use_kernel and rows <= MAX_ROWS and self._li is not None:
            p = self.packs[key]
            out = wonly_matmul_stacked(x.reshape(rows, -1), p["wq"], p["scale"], p["offset"],
                                       p["bias"], self._li)
            return out.reshape(*x.shape[:-1], -1).to(x.dtype)
        return qops.weight_only_linear(x, self._sliced(key), b)

    def expert_linear(self, site, x, w, b):
        key = site.split(".")[-1]
        if key not in self.packs:
            return super().expert_linear(site, x, w, b)
        return qops.weight_only_expert_linear(x, self._sliced(key), b)


def init_kv_cache(ecfg, batch_size: int, device="cuda") -> M.KVCache:
    """The fp KV cache in the FP model's (L, B, S, Hkv, hd) layout."""
    c = ecfg.model
    shape = (c.num_layers, batch_size, ecfg.max_seq_len, c.num_kv_heads, c.head_dim_)
    return M.KVCache(k=torch.zeros(shape, dtype=ecfg.act_dtype, device=device),
                     v=torch.zeros(shape, dtype=ecfg.act_dtype, device=device))


def forward(packed: dict, tokens, config: ModelConfig, policy=None, positions=None,
            kv_cache: Optional[M.KVCache] = None, cache_position=None,
            kv_valid_len=None, kc: KernelConfig = KernelConfig(), logits_at=None):
    """Weight-only forward -> (fp32 logits, the cache, written in place).
    Signature-compatible with engine.forward; `policy` is ignored (no
    activation quantization in this mode). Any flag set in `kc` sends
    decode-sized projections through wonly_matmul_stacked and a W4 head at
    decode rows through the W4A8 kernel. logits_at: optional (B,) row index,
    to run the head on that single position ((B, 1, V))."""
    use_kernel = kc.any_kernel
    c = config
    sk = packed["skeleton"]
    ops = WeightOnlyOps(packed["packs"], use_kernel=use_kernel)
    extras = {"li": range(c.num_layers)}
    x, new_cache, _ = M.forward_hidden(sk, tokens, c, ops, positions=positions,
                                       kv_cache=kv_cache, cache_position=cache_position,
                                       kv_valid_len=kv_valid_len, layer_extras=extras)
    if logits_at is not None:
        B = x.shape[0]
        idx = torch.as_tensor(logits_at, device=x.device).to(torch.long)
        x = x[torch.arange(B, device=x.device)[:, None], idx[:, None]]     # (B, 1, D)
    if "head_q" in packed:
        logits = quantized_head_logits(x.to(torch.float32), packed["head_q"], c.vocab_size,
                                       use_kernel=use_kernel)
    else:
        head_w = sk["embed"]["w"].T if c.tie_word_embeddings else sk["lm_head"]["w"]
        logits = x.to(torch.float32) @ head_w.to(torch.float32)
    return logits, new_cache


def decode_loop(packed: dict, first_token: torch.Tensor, kv_cache: M.KVCache,
                start_pos: torch.Tensor, n_steps: int, config: ModelConfig, policy=None,
                kc=None, temperature=0.0,
                generator: Optional[torch.Generator] = None,
                max_start: Optional[int] = None):
    """n_steps of decode, one T = 1 forward a step (the cache written in
    place). first_token (B, 1), start_pos (B,) -> (tokens (B, n_steps), cache,
    last logits (B, V)); greedy, or a draw from `generator` at `temperature`,
    a float or a per-row (B,) tensor (0 = greedy; sampling.loop_next_token).
    max_start is taken for engine.decode_loop's signature (nothing here
    reads start_pos back).
    Signature-compatible with engine.decode_loop: kc takes a KernelConfig
    or a legacy use_pallas value (None is True, the kernels on), read as in
    forward."""
    kc = KernelConfig.coerce(True if kc is None else kc)
    token, pos, cache = first_token, start_pos, kv_cache
    toks, last = [], None
    for _ in range(n_steps):
        logits, cache = forward(packed, token, config, policy, positions=pos[:, None],
                                kv_cache=cache, cache_position=pos, kv_valid_len=pos + 1,
                                kc=kc)
        last = logits[:, -1]
        token = loop_next_token(last, temperature, generator)[:, None]
        toks.append(token)
        pos = pos + 1
    return torch.cat(toks, 1), cache, last
