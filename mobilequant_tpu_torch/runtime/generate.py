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

generate() samples step by step with any SamplerConfig (greedy by default)
from a torch.Generator seeded with `seed`. Greedy speculative decoding at
B = 1: generate_speculative (a host accept loop; the draft is prompt lookup,
a caller's function or SelfDraft, the first N layers of the same pack) and
generate_speculative_fast (rounds of draft -> verify on device tensors, one
read-back per chunk of rounds). The verify forward is T = k rows at
cache_position = pos under the JAX choice "w4nomodelk" on W4 packs (the
W4A8 kernel at M = k, the MLP-block kernel, the W4 head) and the plain
engine on W8 packs; in weight-only mode ecfg.use_pallas. Either way the
emitted tokens are the verify program's own greedy chain for any draft.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.ops.w4a8_matmul import weight_bits
from mobilequant_tpu_torch.quant.policy import QPolicy, policy_kv_bits
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime import wonly as W
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
from mobilequant_tpu_torch.runtime.sampling import SamplerConfig, loop_next_token, sample


def host_to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on `device` without a stream synchronisation:
    on a CUDA device the copy goes from pinned memory, asynchronously (a
    copy from pageable memory waits for the stream first)."""
    t = torch.as_tensor(np.asarray(a))
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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
        self.spec_kc = verify_kc(self._mod, self.ecfg, self.packed, config)

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
                 sampler: SamplerConfig = SamplerConfig(greedy=True), seed: int = 0,
                 eos_token_id: Optional[int] = None, return_stats: bool = False):
        """Step-by-step generation, each token drawn with `sampler` (greedy by
        default) from a torch.Generator seeded with `seed`; EOS checked after
        every token."""
        tokens = torch.as_tensor(np.asarray(prompt_tokens), device=self.device).to(torch.long)
        B, T0 = tokens.shape
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cache = self.init_cache(B)
        self._sync()
        t0 = time.perf_counter()
        last, cache = self.prefill(tokens, cache)
        self._sync()
        t_prefill = time.perf_counter() - t0
        out = []
        t_dec = time.perf_counter()
        for step in range(max_new_tokens):
            token = sample(last, gen, sampler)
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

    # ------------------------------------------------------------------
    # speculative decoding (B = 1, greedy)

    def generate_speculative(self, prompt_tokens, max_new_tokens: int, *, k: int = 4,
                             draft_fn=None, self_draft_layers: int = 0,
                             eos_token_id: Optional[int] = None,
                             return_stats: bool = False):
        """Greedy speculative decoding (B = 1): a draft proposes k - 1 tokens
        and one T = k forward verifies them. The emitted tokens are the
        verify program's own greedy chain for any draft (a wrong draft costs
        speed only).

        No KV rollback: the verify forward writes rows for rejected drafts
        too, but a later query at position p attends only rows <= p, and each
        of those is either accepted or rewritten by the same forward before
        its attention runs.

        draft_fn(history: list[int], n: int) -> list[int]; the default is
        prompt_lookup_draft. self_draft_layers > 0 drafts with SelfDraft
        instead (the first N layers of this pack, the final norm and head).
        Stops early where a further round would not fit the cache."""
        prompt = np.asarray(prompt_tokens)
        B, T0 = prompt.shape
        assert B == 1, "speculative decoding is a B = 1 latency path"
        assert k >= 2
        self_draft = None
        if self_draft_layers > 0:
            assert draft_fn is None, "pass draft_fn or self_draft_layers"
            self_draft = SelfDraft(self, self_draft_layers)
        elif draft_fn is None:
            draft_fn = prompt_lookup_draft
        kc = self.spec_kc
        S = self.ecfg.max_seq_len
        cache = self.init_cache(1)
        self._sync()
        t0 = time.perf_counter()
        last, cache = self.prefill(torch.as_tensor(prompt, device=self.device).to(torch.long),
                                   cache)
        cur = int(torch.argmax(last[0]))
        if self_draft is not None:
            self_draft.prefill(prompt)
        t_prefill = time.perf_counter() - t0

        history = [int(t) for t in prompt[0]]
        out = [cur]
        pos, n_verify = T0, 0
        t_dec = time.perf_counter()
        while (len(out) < max_new_tokens and pos + k <= S
               and (eos_token_id is None or out[-1] != eos_token_id)):
            if self_draft is not None:
                drafts = self_draft.propose(out, T0, pos, k - 1)
            else:
                drafts = list(draft_fn(history + out, k - 1))[:k - 1]
            drafts += [out[-1]] * (k - 1 - len(drafts))
            toks = torch.tensor([[out[-1]] + drafts], dtype=torch.long, device=self.device)
            am, cache = verify_forward(self._mod, self.packed, self.config, self.policy, toks,
                                       cache, pos, kc)
            am = am.cpu().tolist()
            n_verify += 1
            n_acc = 0
            while n_acc < k - 1 and drafts[n_acc] == am[n_acc]:
                n_acc += 1
            emitted = drafts[:n_acc] + [am[n_acc]]
            if eos_token_id is not None and eos_token_id in emitted:
                emitted = emitted[:emitted.index(eos_token_id) + 1]
            out.extend(emitted[:max_new_tokens - len(out)])
            pos += n_acc + 1
        t_decode = time.perf_counter() - t_dec
        tokens_out = np.asarray([out], np.int32)
        if return_stats:
            n = len(out)
            return tokens_out, {"prefill_s": t_prefill, "decode_s": t_decode,
                                "decode_tok_s": n / t_decode if t_decode > 0 else 0.0,
                                "verify_calls": n_verify,
                                "tokens_per_verify": (n - 1) / max(n_verify, 1)}
        return tokens_out

    def _self_draft(self, num_layers: int) -> "SelfDraft":
        """One SelfDraft per depth, kept on the Generator."""
        cache = self.__dict__.setdefault("_self_drafts", {})
        if num_layers not in cache:
            cache[num_layers] = SelfDraft(self, num_layers)
        return cache[num_layers]

    def spec_state(self, prompt_tokens, k: int, self_draft_layers: int = 0):
        """Prefill and the first round's state of generate_speculative_fast:
        (cur, cache, pos, buf, blen, dstate), device tensors."""
        prompt = np.asarray(prompt_tokens)
        B, T0 = prompt.shape
        assert B == 1 and T0 >= k, "speculative decode: B = 1, a prompt of >= k tokens"
        dev = self.device
        tokens = torch.as_tensor(prompt, device=dev).to(torch.long)
        cache = self.init_cache(1)
        last, cache = self.prefill(tokens, cache)
        cur = torch.argmax(last[0]).reshape(1)
        dstate = None
        if self_draft_layers > 0:
            sd = self._self_draft(self_draft_layers)
            sd.prefill(prompt)
            dstate = (sd.cache, tokens[0, -k:].clone(),
                      torch.full((1,), T0 - k, dtype=torch.int32, device=dev))
        buf = torch.zeros((self.ecfg.max_seq_len,), dtype=torch.long, device=dev)
        buf[:T0] = tokens[0]
        buf[T0:T0 + 1] = cur
        return (cur, cache, torch.full((1,), T0, dtype=torch.int32, device=dev), buf,
                torch.full((1,), T0 + 1, dtype=torch.long, device=dev), dstate)

    def generate_speculative_fast(self, prompt_tokens, max_new_tokens: int, *, k: int = 4,
                                  self_draft_layers: int = 0, rounds_per_chunk: int = 8,
                                  eos_token_id: Optional[int] = None,
                                  return_stats: bool = False):
        """Greedy speculative decoding (B = 1) with the accept / reject
        bookkeeping on the device: chunks of `rounds_per_chunk` rounds
        (spec_round; the prompt-lookup draft, or the self-draft with
        self_draft_layers > 0) are queued back to back, and each chunk's
        tokens come back in one read (the chunk's only host
        synchronisation; the host keeps its own copy of the position). Emits
        the verify program's own greedy chain; a chunk may overshoot
        max_new_tokens, and the tail is cut before returning."""
        prompt = np.asarray(prompt_tokens)
        B, T0 = prompt.shape
        assert B == 1 and k >= 2
        S = self.ecfg.max_seq_len
        kc = self.spec_kc
        self._sync()
        t0 = time.perf_counter()
        cur, cache, pos, buf, blen, dstate = self.spec_state(prompt, k, self_draft_layers)
        sd = self._self_draft(self_draft_layers) if self_draft_layers > 0 else None
        out = [int(cur[0])]
        t_prefill = time.perf_counter() - t0
        n_rounds, syncs, pos_h = 0, 0, T0
        t_dec = time.perf_counter()
        while len(out) < max_new_tokens and (eos_token_id is None or eos_token_id not in out):
            # each round advances <= k rows: the chunk's rounds must fit the cache
            rpc = min(rounds_per_chunk, (S - 1 - pos_h) // k)
            if rpc < 1:
                break
            em, advs = [], []
            for _ in range(rpc):
                cur, cache, pos, buf, blen, dstate, e, a = spec_round(
                    self._mod, self.packed, self.config, self.policy, k, kc, cur, cache, pos,
                    buf, blen, sd, dstate)
                em.append(e)
                advs.append(a)
            got = torch.cat([torch.stack(em).reshape(-1), torch.cat(advs)]).cpu().numpy()
            syncs += 1
            toks_r, counts = got[:rpc * k].reshape(rpc, k), got[rpc * k:]
            for r in range(rpc):
                out.extend(int(t) for t in toks_r[r, :counts[r]])
            pos_h += int(counts.sum())
            n_rounds += rpc
        t_decode = time.perf_counter() - t_dec
        if eos_token_id is not None and eos_token_id in out:
            out = out[:out.index(eos_token_id) + 1]
        out = out[:max_new_tokens]
        tokens_out = np.asarray([out], np.int32)
        if return_stats:
            n = len(out)
            return tokens_out, {"prefill_s": t_prefill, "decode_s": t_decode,
                                "decode_tok_s": n / t_decode if t_decode > 0 else 0.0,
                                "verify_calls": n_rounds,
                                "tokens_per_verify": (n - 1) / max(n_rounds, 1),
                                "host_syncs": syncs}
        return tokens_out


def verify_kc(mod, ecfg, packed: dict, config) -> KernelConfig:
    """The verify forward's kernels (T = k rows at cache_position = pos), the
    JAX Generator's and batcher's choice: "w4nomodelk" on W4 packs (the W4A8
    kernel at M = k, the MLP-block kernel, the W4 head), the plain engine on
    W8 packs; in weight-only mode (mod is runtime/wonly) ecfg.use_pallas."""
    if mod is W:
        return KernelConfig.coerce(ecfg.use_pallas)
    w4 = weight_bits(packed["layers"]["qkv_proj"]["wq"], config.hidden_size) == 4
    return KernelConfig.coerce("w4nomodelk" if w4 else False)


def verify_forward(mod, packed: dict, config, policy, toks: torch.Tensor, cache, start,
                   kc: KernelConfig):
    """toks (1, k) = [current token, k - 1 drafts] at positions start ..
    start + k - 1 through `mod`.forward (the engine or runtime/wonly): writes
    their K/V rows and returns the greedy next token of every row, (k,).
    start: an int or a (1,) device tensor."""
    k = toks.shape[1]
    dev = toks.device
    start = (torch.full((1,), start, dtype=torch.int32, device=dev)
             if isinstance(start, int) else start.to(torch.int32))
    logits, cache = mod.forward(
        packed, toks, config, policy,
        positions=(start + torch.arange(k, device=dev, dtype=torch.int32))[None],
        kv_cache=cache, cache_position=start, kv_valid_len=start + k, kc=kc)
    return torch.argmax(logits[0], dim=-1), cache


def spec_round(mod, packed: dict, config, policy, k: int, kc: KernelConfig, cur, cache, pos,
               buf, blen, sd=None, dstate=None):
    """One draft -> verify round on device tensors, with no read-back.
    cur (1,) is the current token at position pos (1,); buf (S,) the token
    history (prompt and emitted, buf[blen - 1] == cur), blen (1,). With sd
    None the draft is prompt lookup (_ig_lookup_draft); else sd is a
    SelfDraft and dstate its (cache, the previous round's verify tokens
    (k,), their start (1,)): the self-draft first replays the previous
    round's verify tokens (the catch-up forward: rows of accepted positions
    equal what per-step drafting writes, rows of rejected ones are
    rewritten by this round's draft steps before any query reads them), then
    drafts k - 1 tokens one T = 1 step at a time.
    -> (bonus (1,), cache, pos, buf, blen, dstate, emitted (k,), advance
    (1,)): emitted holds the accepted drafts, then the bonus token (the
    verify's greedy token after them) in every later place; the first
    `advance` of them are the round's tokens."""
    dev = buf.device
    ar = torch.arange(k, device=dev)
    if sd is None:
        drafts = _ig_lookup_draft(buf, blen, k - 1)
    else:
        dcache, prev, start_prev = dstate
        _, dcache = E.forward(sd.packed, prev[None], sd.cfg, policy,
                              positions=(start_prev + ar.to(torch.int32))[None],
                              kv_cache=dcache, cache_position=start_prev,
                              kv_valid_len=start_prev + k, kc=sd.kc,
                              logits_at=torch.zeros((1,), dtype=torch.long, device=dev))
        tok, ds = cur, []
        for j in range(k - 1):
            p = pos + j
            lg, dcache = E.forward(sd.packed, tok[None], sd.cfg, policy, positions=p[None],
                                   kv_cache=dcache, cache_position=p, kv_valid_len=p + 1,
                                   kc=sd.kc)
            tok = torch.argmax(lg[0, -1]).reshape(1)
            ds.append(tok)
        drafts = torch.cat(ds)
    toks = torch.cat([cur, drafts])[None]
    am, cache = verify_forward(mod, packed, config, policy, toks, cache, pos, kc)
    acc = torch.cumprod((drafts == am[:k - 1]).to(torch.int32), 0)
    n_acc = acc.sum().reshape(1)
    bonus = torch.gather(am, 0, n_acc)
    emitted = torch.where(ar < n_acc, torch.cat([drafts, drafts[-1:]]), bonus)
    buf.scatter_(0, blen + ar, emitted)
    adv = n_acc + 1
    if sd is not None:
        dstate = (dcache, toks[0], pos)
    return bonus, cache, (pos + adv).to(torch.int32), buf, blen + adv, dstate, emitted, adv


def _cut(tree, nd: int):
    """Every tensor / array leaf of a layer-stacked tree cut to its first nd
    layers."""
    if isinstance(tree, dict):
        return {k: _cut(v, nd) for k, v in tree.items()}
    return tree[:nd]


class SelfDraft:
    """Truncated-layer self-draft: the first `num_layers` decoder layers of
    the same packed engine, with the final norm and the (quantized) head, as
    an early-exit proposer over a KV cache of its own, written only by draft
    forwards. Each round drafts from a segment anchored at the first
    position whose draft row is not yet valid, so every row below the
    anchor was written by the draft for a token that verified identically,
    and stale rows of rejected drafts sit at or above the next anchor, where
    the next segment rewrites them before any query reads them."""

    def __init__(self, gen: Generator, num_layers: int = 4):
        assert gen._mod is E, "the self-draft runs the integer engine"
        L = gen.config.num_layers
        nd = max(1, min(num_layers, L))
        self.nd, self.gen = nd, gen
        p = {k: v for k, v in gen.packed.items() if k != "kernel_prep"}
        p["layers"] = _cut(gen.packed["layers"], nd)
        p["ranges"] = _cut(gen.packed["ranges"], nd)
        self.packed = p
        self.cfg = dataclasses.replace(gen.config, num_layers=nd)
        self.ecfg = dataclasses.replace(gen.ecfg, model=self.cfg)
        self.kc = gen.spec_kc
        self.cache = None
        self._next_pos = 0

    def prefill(self, prompt_tokens):
        prompt = np.asarray(prompt_tokens)
        B, T = prompt.shape
        dev = self.gen.device
        self.cache = E.init_kv_cache(self.ecfg, B, device=dev)
        _, self.cache = E.forward(
            self.packed, torch.as_tensor(prompt, device=dev).to(torch.long), self.cfg,
            self.gen.policy, kv_cache=self.cache,
            cache_position=torch.zeros((B,), dtype=torch.int32, device=dev),
            kv_valid_len=torch.full((B,), T, dtype=torch.int32, device=dev),
            kc=self.gen.prefill_kc,
            logits_at=torch.full((B,), T - 1, dtype=torch.long, device=dev))
        self._next_pos = T          # the first draft row not yet written

    def propose(self, out: list, prompt_len: int, pos: int, n: int) -> list:
        """n proposals continuing out[-1] (at position pos); out[i] is the
        token at position prompt_len + i. One forward over the segment from
        the anchor, then one per proposal, each read back."""
        dev = self.gen.device
        p0 = int(min(self._next_pos, pos))
        seg = [int(t) for t in out[p0 - prompt_len:]]        # positions p0 .. pos
        npfx = len(seg)
        start = torch.full((1,), p0, dtype=torch.int32, device=dev)
        for _ in range(n):
            j = len(seg)
            toks = torch.tensor([seg], dtype=torch.long, device=dev)
            logits, self.cache = E.forward(
                self.packed, toks, self.cfg, self.gen.policy,
                positions=(start + torch.arange(j, device=dev, dtype=torch.int32))[None],
                kv_cache=self.cache, cache_position=start, kv_valid_len=start + j,
                kc=self.kc, logits_at=torch.full((1,), j - 1, dtype=torch.long, device=dev))
            seg.append(int(torch.argmax(logits[0, -1])))
        self._next_pos = p0 + len(seg) - 1    # the last forward wrote p0 .. that - 1
        return seg[npfx:]


def _ig_lookup_draft(buf: torch.Tensor, blen: torch.Tensor, n: int) -> torch.Tensor:
    """The device twin of prompt_lookup_draft (ngram 2) over a fixed-size
    history: buf (S,) holds the prompt and the emitted tokens, blen (1,) its
    valid length (buf[blen - 1] is the current token). The most recent
    earlier position i with (buf[i], buf[i + 1]) equal to the trailing
    bigram and i + 1 <= blen - 2 gives the n tokens after it, cut at blen and
    padded with the last valid one; no match, or no continuation, repeats
    the last token. No value is read back."""
    S = buf.shape[0]
    dev = buf.device
    blen = blen.reshape(1).to(torch.long)
    t1 = torch.gather(buf, 0, blen - 2)
    t2 = torch.gather(buf, 0, blen - 1)
    idx = torch.arange(S, device=dev)
    match = (buf == t1) & (torch.roll(buf, -1) == t2) & (idx + 1 <= blen - 2)
    last = torch.where(match, idx, torch.full_like(idx, -1)).max().reshape(1)
    start = torch.clamp(last + 2, 0, S - n)
    j = start + torch.arange(n, device=dev)
    d = torch.gather(buf, 0, j)
    pad = torch.gather(d, 0, torch.clamp(blen - 1 - start, 0, n - 1))
    d = torch.where(j < blen, d, pad)
    return torch.where((last < 0) | (last + 2 >= blen), t2, d)


def prompt_lookup_draft(history, n: int, ngram: int = 2) -> list:
    """Draft by n-gram continuation: what followed the most recent earlier
    occurrence of the trailing `ngram` tokens (padded with its last token);
    no occurrence, or none with a continuation, repeats the last token."""
    h = list(history)
    if len(h) >= ngram:
        key = h[-ngram:]
        for i in range(len(h) - ngram - 1, -1, -1):
            if h[i:i + ngram] == key:
                cont = h[i + ngram:i + ngram + n]
                if cont:
                    return (cont + [cont[-1]] * n)[:n]
                break
    return [h[-1]] * n if h else [0] * n
