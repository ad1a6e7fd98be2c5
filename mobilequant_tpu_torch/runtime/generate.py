"""Autoregressive generation on the port's integer engine.

Prefill runs the prompt in one pass (KernelConfig.prefill()): the qkv, attention
and w13+gate kernels with the W4A8 kernel for o-proj, w2 and the one-row
head, or the whole-MLP-block kernel in every layer when B·T <= 64; on a W8A8
pack the W8 editions of the w13+gate and MLP-block kernels, with qkv, o-proj,
w2 and the W8 head on the plain integer matmul (as in the JAX engine).
generate_fast decodes with engine.decode_loop(kc=ecfg.use_pallas), as the
JAX Generator's decode_loop(use_pallas=ecfg.use_pallas). With the default
True, the entry config (KernelConfig.serving): at B <= 8 non-staged T=1 steps,
each one launch of the whole-model kernel; at B > 8 the chunked-staging loop,
whose steps run the W4A8 kernel for qkv and o, the whole-MLP-block kernel (up
to 128 rows) and staged_append, or, for W8A8 packs at 8 < B <= 48, one
chunk-kernel launch. A legacy mode string takes the JAX route it names, in
every layer of a staged step: on a W8A8 pack "mlp" (ops/fused_mlp),
"mlpblock" and "mlpblockvpu" (ops/fused_mlp_block); "otail" the o-tail (it
keeps the whole-model kernel on, so W8A8 packs at 8 < B <= 48 take the chunk
kernel, as in the JAX engine). An explicit KernelConfig keeps its own gate
(KernelConfig.chunk(): one chunk-kernel launch per staged step;
KernelConfig.otail(): the o-tail at every B > 8). On the int4 cache
(EngineConfig.kv_bits = 4 with a 4-bit KV policy) the prefill is the same
kernel set without the qkv epilogue kernel (the engine gates it: it clips K /
V rows at the 8-bit bound) and decode is staged at every B, its attention one
kv4 kernel launch per layer and step.
Weight-only mode (EngineConfig.act_bits = 16, a pack of
runtime/wonly.pack_weight_only): the same Generator drives runtime/wonly.py
instead, as the JAX one does. Its prefill takes no kernel (the dequantized
weight once a layer, then a plain matmul); its decode takes the weight-only
kernel (wonly_matmul_stacked) for every projection and, with a W4 head, the
W4A8 kernel for the head, when ecfg.use_pallas sets any kernel; the KV cache is fp in act_dtype and the policy is
not read. On a CPU device the kernel wrappers run their plain versions
(tests); the default device is the GPU, and a GPU device without CUDA raises.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.quant.policy import QPolicy, policy_kv_bits
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime import wonly as W
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
from mobilequant_tpu_torch.runtime.sampling import loop_next_token


class Generator:
    """Prefill + decode over a packed W4A8 or W8A8 model, or a weight-only
    (W4A16 / W8A16) one, on one device."""

    def __init__(self, packed: dict, config: ModelConfig, policy: Optional[QPolicy],
                 ecfg: Optional[E.EngineConfig] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Generator(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run the plain versions")
        self.config = config
        self.policy = policy
        self.ecfg = ecfg or E.EngineConfig(model=config)
        self.packed = E.packed_to(packed, self.device)
        if self.ecfg.act_bits == 16:
            # weight-only: runtime/wonly.py, signature-compatible with the
            # engine; its prefill takes no kernel (as the JAX Generator's)
            self._mod = W
            self.prefill_kc = KernelConfig.none()
        else:
            if policy_kv_bits(policy) != self.ecfg.kv_bits:
                raise ValueError("policy KV bitwidth must match EngineConfig.kv_bits")
            self._mod = E
            self.prefill_kc = KernelConfig.prefill()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def init_cache(self, batch: int):
        return self._mod.init_kv_cache(self.ecfg, batch, device=self.device)

    def prefill(self, tokens: torch.Tensor, cache):
        """Prompt (B, T) -> (last-position logits (B, V), cache)."""
        B, T = tokens.shape
        kw = dict(positions=torch.arange(T, device=self.device)[None].expand(B, T),
                  kv_cache=cache,
                  cache_position=torch.zeros((B,), dtype=torch.int32, device=self.device),
                  kv_valid_len=torch.full((B,), T, dtype=torch.int32, device=self.device),
                  logits_at=torch.full((B,), T - 1, dtype=torch.int32, device=self.device))
        logits, cache = self._mod.forward(self.packed, tokens, self.config, self.policy,
                                          kc=self.prefill_kc, **kw)
        return logits[:, -1], cache

    def decode(self, token: torch.Tensor, cache, pos: torch.Tensor, n_steps: int,
               temperature: float = 0.0, generator: Optional[torch.Generator] = None):
        """n_steps of decode from token (B, 1) at positions pos (B,) -> (tokens
        (B, n_steps), cache, last logits (B, V))."""
        return self._mod.decode_loop(self.packed, token, cache, pos, n_steps, self.config,
                                     self.policy, self.ecfg.use_pallas, temperature,
                                     generator)

    def generate_fast(self, prompt_tokens, max_new_tokens: int,
                      temperature: float = 0.0, seed: int = 0,
                      eos_token_id: Optional[int] = None, chunk: int = 32,
                      return_stats: bool = False):
        """Prefill, then decode in `chunk`-step loops (tokens stay on the device
        within a chunk; EOS is checked between chunks). Greedy or temperature
        sampling from a torch.Generator seeded with `seed`."""
        tokens = torch.as_tensor(np.asarray(prompt_tokens), device=self.device).to(torch.long)
        B, T0 = tokens.shape
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cache = self.init_cache(B)
        self._sync()
        t0 = time.perf_counter()
        last, cache = self.prefill(tokens, cache)
        first = loop_next_token(last, 0.0)[:, None]
        self._sync()
        t_prefill = time.perf_counter() - t0

        pieces = [first]
        n_done, token = 1, first
        t_dec = time.perf_counter()
        while n_done < max_new_tokens:
            n = min(chunk, max_new_tokens - n_done)
            pos = torch.full((B,), T0 + n_done - 1, dtype=torch.int32, device=self.device)
            toks, cache, _ = self.decode(token, cache, pos, n, temperature, gen)
            pieces.append(toks)
            n_done += n
            token = toks[:, -1:]
            if eos_token_id is not None and bool(
                    (torch.cat(pieces, 1) == eos_token_id).any(1).all()):
                break
        self._sync()
        t_decode = time.perf_counter() - t_dec
        out = torch.cat(pieces, 1)[:, :max_new_tokens].cpu().numpy()
        if return_stats:
            n = out.shape[1]
            return out, {"prefill_s": t_prefill, "decode_s": t_decode,
                         "decode_tok_s": ((n - 1) * B) / t_decode if t_decode > 0 else 0.0}
        return out

    def generate(self, prompt_tokens, max_new_tokens: int,
                 eos_token_id: Optional[int] = None, return_stats: bool = False):
        """Greedy step-by-step generation (EOS checked after every token)."""
        tokens = torch.as_tensor(np.asarray(prompt_tokens), device=self.device).to(torch.long)
        B, T0 = tokens.shape
        cache = self.init_cache(B)
        self._sync()
        t0 = time.perf_counter()
        last, cache = self.prefill(tokens, cache)
        self._sync()
        t_prefill = time.perf_counter() - t0
        out = []
        t_dec = time.perf_counter()
        for step in range(max_new_tokens):
            token = loop_next_token(last, 0.0)
            out.append(token)
            if eos_token_id is not None and bool((token == eos_token_id).all()):
                break
            if step == max_new_tokens - 1:
                break
            pos = torch.full((B,), T0 + step, dtype=torch.int32, device=self.device)
            kw = dict(positions=pos[:, None], kv_cache=cache, cache_position=pos,
                      kv_valid_len=pos + 1)
            logits, cache = self._mod.forward(self.packed, token[:, None], self.config,
                                              self.policy,
                                              kc=KernelConfig.coerce(self.ecfg.use_pallas),
                                              **kw)
            last = logits[:, 0]
        self._sync()
        t_decode = time.perf_counter() - t_dec
        toks = torch.stack(out, 1).cpu().numpy()
        if return_stats:
            n = toks.shape[1]
            return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                          "decode_tok_s": (n * B) / t_decode if t_decode > 0 else 0.0}
        return toks
