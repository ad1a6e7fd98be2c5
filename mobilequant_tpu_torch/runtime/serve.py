"""Continuous batching over the port's integer engine (the port of
mobilequant_tpu/runtime/serve.py).

A fixed number of batch slots share one KV cache on the device (the slot
axis is axis 1 in every layout: int8 (L, B, Hkv, S, hd), int4 (L, B, Hkv,
hd, S/2), and the weight-only mode's fp (L, B, S, Hkv, hd)):

  * a new request prefills into a free slot: a bucketed-length forward whose
    K/V segment is copied into the slot's rows, or (chunk_prefill) fixed
    chunks of C tokens at cache_position = start through a scratch cache
    that is then copied into the slot (adopt); requests that refill in the
    same wave prefill as one batch (padded to a power of two, the padding
    rows repeating a real row);
  * one tick advances every slot by one token (one forward at per-slot
    positions; a free slot decodes at position 0 and its token is thrown
    away), or by chunk_decode tokens through the decode loop, pipelined;
  * finished slots (EOS, budget or the cache's end) are retired and refilled
    from the queue at once, with no batch barrier.

The kernel routes are the JAX batcher's choices on its accelerator: decode
with ecfg.use_pallas (engine.decode_loop's entry config for a legacy value),
prefill with KernelConfig.prefill() (the JAX "w4_attn_gatek" / "attn_gatek"),
the speculative verify with "w4nomodelk" on W4 packs (none on W8 packs), and
in weight-only mode (ecfg.act_bits = 16, runtime/wonly.py) a prefill with no
kernel and the decode kernels of ecfg.use_pallas. On a CPU device the kernel
wrappers run their plain versions.

Host synchronisation: a tick reads its tokens back once; a refill wave reads
its first tokens back once (_install_many); a speculative tail wave reads its
rounds back once. Everything sent to the card goes from pinned memory
without a wait (generate.host_to_device), and the decode loop is given the
host's copy of the largest position, so no other read-back stalls a tick.

Not ported: the JAX batcher's `mesh=` sharding (NotImplementedError).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.quant.policy import QPolicy, policy_kv_bits
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime import wonly as W
from mobilequant_tpu_torch.runtime.generate import host_to_device, spec_round, verify_kc
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
from mobilequant_tpu_torch.runtime.sampling import (SamplerConfig, sample,
                                                    sample_batched, sampler_arrays)

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (T,) int32
    max_new_tokens: int
    sampler: Optional[SamplerConfig] = None   # None: the batcher's default
    out: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pos: int = 0                  # the next position to write
    t_submit: float = 0.0         # host clock (time.perf_counter)
    t_first: Optional[float] = None   # when the first token was read back


class ContinuousBatcher:
    def __init__(self, packed: dict, config: ModelConfig, policy: Optional[QPolicy],
                 ecfg: Optional[E.EngineConfig] = None, batch_slots: int = 8,
                 prefill_buckets: tuple = (32, 128, 512, 1024),
                 sampler: SamplerConfig = SamplerConfig(greedy=True),
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 mesh=None, chunk_prefill: Optional[int] = None,
                 chunk_decode: int = 1, pipeline_ticks: int = 0,
                 spec_k: int = 0, device="cuda"):
        """chunk_prefill: prompts prefill in chunks of this many tokens through
        a scratch cache (one shape for any prompt length up to max_seq_len,
        no buckets); required on the int4 cache.

        chunk_decode > 1: a tick advances every slot by that many tokens in
        one decode loop; greedy and plain-temperature requests (a per-slot
        temperature tensor) ride it, top-k / top-p requests take
        single-token ticks.

        pipeline_ticks: 0 (default) pipelines as many chunked ticks as the
        smallest remaining budget / headroom of the live slots allows (chunk
        i + 1 starts from chunk i's last token on the device), with one
        read-back for all of them; slots certain to retire in the wave get
        their next request's prefill queued before that read-back
        (overlapped refill). P > 0 caps the depth.

        spec_k >= 2: when exactly one greedy request is live, the tick runs
        prompt-lookup draft -> verify rounds on a B = 1 copy of its slot's
        cache rows (written back after), emitting the verify program's own
        greedy chain."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ContinuousBatcher(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run the plain versions")
        if mesh is not None:
            raise NotImplementedError("the port's batcher runs on one device: mesh "
                                      "sharding of the slot axis is not ported")
        self.ecfg = ecfg or E.EngineConfig(model=config)
        if self.ecfg.act_bits == 16:
            self._mod = W
            self._kvc = W.M.KVCache
        else:
            if policy_kv_bits(policy) != self.ecfg.kv_bits:
                raise ValueError("policy KV bitwidth must match EngineConfig.kv_bits")
            if self.ecfg.kv_bits == 4 and chunk_prefill is None:
                # a bucketed segment is int8 rows; only the chunked path's
                # forward (unpack -> program -> repack) writes the packed layout
                raise ValueError("int4 KV serving requires chunk_prefill")
            self._mod = E
            self._kvc = E.EngineKVCache
        self.packed = E.packed_to(packed, self.device)
        self.config = config
        self.policy = policy
        self.B = batch_slots
        self.buckets = tuple(b for b in sorted(prefill_buckets) if b <= self.ecfg.max_seq_len)
        self.sampler = sampler
        self.eos = eos_token_id
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = self._mod.init_kv_cache(self.ecfg, self.B, device=self.device)
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}       # slot -> request
        self.done: dict[int, Request] = {}
        self._rid = itertools.count()
        self._last_tokens = np.zeros((self.B,), np.int64)
        self.stats: dict = {}
        self.host_syncs = 0                        # read-backs since construction
        self.pipelined_ticks = 0                   # chunked ticks of more than one loop

        self.kc_decode = self.ecfg.use_pallas          # decode_loop takes legacy values
        self.kc_step = KernelConfig.coerce(self.ecfg.use_pallas)
        self.kc_prefill = KernelConfig.prefill() if self._mod is E else KernelConfig.none()
        self.kc_spec = verify_kc(self._mod, self.ecfg, self.packed, config)

        self.chunk_decode = max(int(chunk_decode), 1)
        self.pipeline_ticks = max(int(pipeline_ticks), 0)   # 0 = adaptive
        self._chunk_ok = self._plain(sampler)
        self._chunk_temp = 0.0 if sampler.greedy else float(sampler.temperature)
        self.chunk = chunk_prefill
        if chunk_prefill is not None and self.ecfg.max_seq_len % chunk_prefill:
            raise ValueError("chunk_prefill must divide max_seq_len")
        self.spec_k = max(int(spec_k), 0)

    # ------------------------------------------------------------------
    # device calls

    def _t(self, a, dtype) -> torch.Tensor:
        return host_to_device(a, self.device, dtype)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """The one read-back of a tick or a wave."""
        self.host_syncs += 1
        return t.cpu().numpy()

    def _decode(self, pos: np.ndarray, valid: np.ndarray) -> torch.Tensor:
        """One token for every slot at per-slot positions -> logits (B, V)."""
        pos_t = self._t(pos, torch.int32)
        logits, _ = self._mod.forward(
            self.packed, self._t(self._last_tokens[:, None], torch.long), self.config,
            self.policy, positions=pos_t[:, None], kv_cache=self.cache, cache_position=pos_t,
            kv_valid_len=self._t(valid, torch.int32), kc=self.kc_step)
        return logits[:, 0]

    def _write_segment(self, seg, slots: list, n: int) -> None:
        """Copy rows 0 .. n - 1 of each segment row i into slot slots[i]."""
        for i, s in enumerate(slots):
            for dst, src in ((self.cache.k, seg.k), (self.cache.v, seg.v)):
                if self._mod is W:
                    dst[:, s, :n] = src[:, i, :n]
                else:
                    dst[:, s, :, :n] = src[:, i, :, :n]

    def _prefill_bucketed(self, prompts: list, slots: list, bucket: int) -> torch.Tensor:
        """One (Bp, bucket) prefill of padded prompts (no cache: the segment
        is its own), its K/V rows copied into the slots -> the last prompt
        position's logits (Bp, V)."""
        Bp = len(prompts)
        tok = np.zeros((Bp, bucket), np.int64)
        for i, p in enumerate(prompts):
            tok[i, :len(p)] = p
        lens = np.asarray([len(p) for p in prompts], np.int32)
        lens_t = self._t(lens, torch.int32)
        positions = torch.arange(bucket, device=self.device)[None].expand(Bp, bucket)
        logits, seg = self._mod.forward(self.packed, self._t(tok, torch.long), self.config,
                                        self.policy, positions=positions,
                                        kv_valid_len=lens_t, kc=self.kc_prefill,
                                        logits_at=lens_t - 1)
        self._write_segment(seg, slots, bucket)
        return logits[:, -1]

    def _prefill_chunks(self, prompts: list, slots: list, n_chunks: int) -> torch.Tensor:
        """(Bp, C) chunks at cache_position = start through a scratch cache of
        Bp rows, then the scratch adopted into the slots -> the last prompt
        position's logits (Bp, V) (every prompt ends in the last chunk)."""
        C, Bp = self.chunk, len(prompts)
        scratch = self._mod.init_kv_cache(self.ecfg, Bp, device=self.device)
        lens = np.asarray([len(p) for p in prompts], np.int32)
        last = None
        for ci in range(n_chunks):
            tok = np.zeros((Bp, C), np.int64)
            for i, p in enumerate(prompts):
                piece = p[ci * C:(ci + 1) * C]
                tok[i, :len(piece)] = piece
            valid = np.minimum(lens, (ci + 1) * C).astype(np.int32)
            at = np.clip(valid - 1 - ci * C, 0, C - 1)
            start = torch.full((Bp,), ci * C, dtype=torch.int32, device=self.device)
            positions = start[:, None] + torch.arange(C, device=self.device,
                                                      dtype=torch.int32)[None]
            last, scratch = self._mod.forward(
                self.packed, self._t(tok, torch.long), self.config, self.policy,
                positions=positions, kv_cache=scratch, cache_position=start,
                kv_valid_len=self._t(valid, torch.int32), kc=self.kc_prefill,
                logits_at=self._t(at, torch.long))
        # adopt: duplicate padding rows would rewrite identical bytes, so only
        # the real slots are copied
        for i, s in enumerate(slots):
            self.cache.k[:, s] = scratch.k[:, i]
            self.cache.v[:, s] = scratch.v[:, i]
        return last[:, -1]

    # ------------------------------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens: int,
               sampler: Optional[SamplerConfig] = None) -> int:
        """Queue a request; sampler overrides the batcher's default for it.
        A prompt longer than max_prompt_len (or empty) raises ValueError.
        Mixed settings share ticks: single-token ticks sample every slot in
        one sample_batched call, chunked ticks carry a per-slot temperature,
        and top-k / top-p requests take single-token ticks."""
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_prompt_len:
            raise ValueError(f"prompt length {len(prompt)} exceeds the serving limit "
                             f"{self.max_prompt_len}")
        rid = next(self._rid)
        self.queue.append(Request(rid, prompt, max_new_tokens, sampler=sampler,
                                  t_submit=time.perf_counter()))
        return rid

    @property
    def max_prompt_len(self) -> int:
        """The longest prompt the batcher takes: its largest bucket (every
        length under chunked prefill), and at most max_seq_len - 1, so that
        the first decode step has a cache row to write."""
        S1 = self.ecfg.max_seq_len - 1
        if self.chunk is not None:
            return S1
        return min(max(self.buckets), S1) if self.buckets else 0

    def _eff_sampler(self, req: Request) -> SamplerConfig:
        return req.sampler if req.sampler is not None else self.sampler

    @staticmethod
    def _plain(e: SamplerConfig) -> bool:
        """Greedy or plain temperature (no top-k / top-p): servable by the
        chunked decode loop."""
        return e.greedy or (e.top_k == 0 and e.top_p >= 1.0)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds buckets {self.buckets}")

    def _sample_rows(self, logits: torch.Tensor, cfgs: list) -> torch.Tensor:
        t, p, k, g = sampler_arrays(cfgs)
        return sample_batched(logits, self.gen, self._t(t, torch.float32),
                              self._t(p, torch.float32), self._t(k, torch.long),
                              self._t(g, torch.bool))

    @staticmethod
    def _pad_pow2(n: int) -> int:
        return 1 << (n - 1).bit_length()

    def _prefill_many(self, pairs):
        """Prefill the (slot, request) pairs of a refill wave: one batched
        prefill per group of equal chunk count (chunk_prefill) or bucket. ->
        (slot, request, first token on the device) for _install_many."""
        groups: dict = {}
        for slot, req in pairs:
            key = (-(-len(req.prompt) // self.chunk) if self.chunk is not None
                   else self._bucket_for(len(req.prompt)))
            groups.setdefault(key, []).append((slot, req))
        pending = []
        for key, grp in groups.items():
            pending.extend(self._prefill_group(grp, key))
        return pending

    def _prefill_group(self, grp, key):
        """One batched prefill of a group, padded to a power of two with rows
        that repeat the group's last request, and one first-token sample:
        `sample` when every request takes the batcher's default, else
        per-row parameters (the padding rows greedy); the padding rows'
        tokens are dropped."""
        Bp = self._pad_pow2(len(grp))
        prompts = [req.prompt for _, req in grp]
        prompts += [prompts[-1]] * (Bp - len(grp))
        slots = [slot for slot, _ in grp]
        if self.chunk is not None:
            last = self._prefill_chunks(prompts, slots, key)
        else:
            last = self._prefill_bucketed(prompts, slots, key)
        effs = [self._eff_sampler(req) for _, req in grp]
        if all(e == self.sampler for e in effs):
            firsts = sample(last, self.gen, self.sampler)
        else:
            firsts = self._sample_rows(last, effs + [SamplerConfig(greedy=True)] * (Bp - len(grp)))
        pending = []
        for i, (slot, req) in enumerate(grp):
            req.slot = slot
            req.pos = len(req.prompt)
            pending.append((slot, req, firsts[i]))
        return pending

    def _install_many(self, pending) -> None:
        """Install prefilled requests with one read-back of all their first
        tokens."""
        if not pending:
            return
        firsts = self._fetch(torch.stack([f.reshape(()) for _, _, f in pending]))
        now = time.perf_counter()
        for (slot, req, _), first in zip(pending, firsts):
            req.out.append(int(first))
            req.t_first = now
            self._last_tokens[slot] = int(first)
            self.active[slot] = req

    def _fill_free_slots(self) -> None:
        free = [s for s in range(self.B) if s not in self.active]
        pairs = []
        while free and self.queue:
            pairs.append((free.pop(0), self.queue.popleft()))
        if pairs:
            self._install_many(self._prefill_many(pairs))

    def _retire(self, slot: int) -> None:
        req = self.active.pop(slot)
        self.done[req.rid] = req

    def _finish(self, slot: int, req: Request, piece: list) -> None:
        """Append a slot's new tokens (cut at EOS) and retire it if done."""
        if self.eos is not None and self.eos in piece:
            piece = piece[:piece.index(self.eos) + 1]
        req.out.extend(piece)
        req.pos += len(piece)
        hit_eos = self.eos is not None and bool(piece) and piece[-1] == self.eos
        if hit_eos or len(req.out) >= req.max_new_tokens or \
                req.pos >= self.ecfg.max_seq_len - 1:
            self._retire(slot)      # rows past EOS are rewritten by the next prefill
        else:
            self._last_tokens[slot] = piece[-1]

    def step(self) -> int:
        """One scheduler tick: refill free slots, advance every slot (one
        token, chunk_decode tokens, or speculative rounds), sample, retire.
        -> the number of live slots after the tick."""
        self._fill_free_slots()
        if not self.active:
            return 0
        S1 = self.ecfg.max_seq_len - 1

        if self.spec_k >= 2 and len(self.active) == 1:
            # the latency-bound tail, or a single stream: speculative rounds
            slot, req = next(iter(self.active.items()))
            if self._eff_sampler(req).greedy and req.pos >= 2:
                r = self._step_speculative(slot, req)
                if r is not None:
                    return r

        n = self.chunk_decode
        if n > 1 and all(req.pos + n <= S1 and len(req.out) < req.max_new_tokens
                         for req in self.active.values()):
            # pipeline depth: the wave's smallest remaining budget / headroom
            # (in chunks), capped by pipeline_ticks
            p = None
            for req in self.active.values():
                bud = -(-max(req.max_new_tokens - len(req.out), 1) // n)
                head = max((S1 - req.pos) // n, 1)
                pi = max(1, min(bud, head))
                p = pi if p is None else min(p, pi)
            p = max(p or 1, 1)
            if self.pipeline_ticks > 0:
                p = min(p, self.pipeline_ticks)
            while p > 1 and not all(req.pos + p * n <= S1 for req in self.active.values()):
                p -= 1
            effs = [self._eff_sampler(r) for r in self.active.values()]
            if self._chunk_ok and all(e == self.sampler for e in effs):
                return self._step_chunked(n, pipeline=p)
            if all(self._plain(e) for e in effs):
                return self._step_chunked(n, per_slot_temps=True, pipeline=p)

        pos = np.zeros((self.B,), np.int32)
        valid = np.ones((self.B,), np.int32)
        for slot, req in self.active.items():
            pos[slot] = req.pos
            valid[slot] = req.pos + 1
        logits = self._decode(pos, valid)
        effs = {s: self._eff_sampler(r) for s, r in self.active.items()}
        if all(e == self.sampler for e in effs.values()):
            nxt = self._fetch(sample(logits, self.gen, self.sampler))
        else:
            # per-slot parameters; free slots sample greedily (dropped)
            nxt = self._fetch(self._sample_rows(
                logits, [effs.get(s, SamplerConfig(greedy=True)) for s in range(self.B)]))
        for slot in list(self.active):
            self._finish(slot, self.active[slot], [int(nxt[slot])])
        return len(self.active)

    def _step_speculative(self, slot: int, req: Request) -> Optional[int]:
        """Speculative tail tick: prompt-lookup rounds for the lone live greedy
        request on a B = 1 copy of its slot's cache rows, written back after;
        one read-back for up to 64 rounds. None when a full round does not
        fit the cache (the caller runs a regular tick)."""
        k = self.spec_k
        S = self.ecfg.max_seq_len
        budget = req.max_new_tokens - len(req.out)
        rounds = min(-(-budget // k), (S - 1 - req.pos) // k, 64)
        if rounds < 1:
            return None
        hist = [int(t) for t in req.prompt] + req.out
        buf = np.zeros((S,), np.int64)
        buf[:len(hist)] = hist                       # buf[blen - 1] == the current token
        buf_t = self._t(buf, torch.long)
        blen = self._t(np.asarray([len(hist)]), torch.long)
        cur = self._t(np.asarray([self._last_tokens[slot]]), torch.long)
        pos = self._t(np.asarray([req.pos]), torch.int32)
        sub = self._kvc(self.cache.k[:, slot:slot + 1].clone(),
                        self.cache.v[:, slot:slot + 1].clone())
        em, advs = [], []
        for _ in range(rounds):
            cur, sub, pos, buf_t, blen, _, e, a = spec_round(
                self._mod, self.packed, self.config, self.policy, k, self.kc_spec, cur, sub,
                pos, buf_t, blen)
            em.append(e)
            advs.append(a)
        self.cache.k[:, slot:slot + 1] = sub.k
        self.cache.v[:, slot:slot + 1] = sub.v
        got = self._fetch(torch.cat([torch.stack(em).reshape(-1), torch.cat(advs)]))
        toks_r, counts = got[:rounds * k].reshape(rounds, k), got[rounds * k:]
        piece = []
        for r in range(rounds):
            piece.extend(int(t) for t in toks_r[r, :counts[r]])
        # a cut below (budget / EOS) retires the request, so the device-side
        # overshoot lands in rows the next prefill into this slot rewrites
        self._finish(slot, req, piece[:budget])
        return len(self.active)

    def _step_chunked(self, n: int, per_slot_temps: bool = False, pipeline: int = 1) -> int:
        """Advance every slot by n · pipeline tokens: `pipeline` decode loops
        queued back to back (each starting from the previous one's last
        token on the device), then one read-back for all of them."""
        pos = np.zeros((self.B,), np.int32)
        for slot, req in self.active.items():
            pos[slot] = req.pos
        temps = self._chunk_temp
        if per_slot_temps:
            t = np.zeros((self.B,), np.float32)
            for slot, req in self.active.items():
                e = self._eff_sampler(req)
                t[slot] = 0.0 if e.greedy else e.temperature
            temps = self._t(t, torch.float32)
        tok = self._t(self._last_tokens[:, None], torch.long)
        pos_t = self._t(pos, torch.int32)
        pieces = []
        self.pipelined_ticks += pipeline > 1
        for i in range(max(pipeline, 1)):
            toks, _, _ = self._mod.decode_loop(
                self.packed, tok, self.cache, pos_t, n, self.config, self.policy,
                self.kc_decode, temperature=temps, generator=self.gen,
                max_start=int(pos.max()) + i * n)
            pieces.append(toks)
            tok = toks[:, -1:]
            pos_t = pos_t + n
        n = n * max(pipeline, 1)

        # overlapped refill: slots certain to retire after this wave (budget or
        # headroom; EOS only retires earlier) get their next request's prefill
        # queued now, behind the decode loops, before the read-back below
        pending = []
        if self.queue:
            S1 = self.ecfg.max_seq_len - 1
            pairs = []
            for slot, req in list(self.active.items()):
                if not self.queue:
                    break
                if len(req.out) + n >= req.max_new_tokens or req.pos + n >= S1:
                    pairs.append((slot, self.queue.popleft()))
            if pairs:
                pending = self._prefill_many(pairs)

        toks = self._fetch(torch.cat(pieces, 1))           # (B, n)
        for slot in list(self.active):
            req = self.active[slot]
            self._finish(slot, req,
                         [int(t) for t in toks[slot][:req.max_new_tokens - len(req.out)]])
        installable = []
        for slot, nreq, first in pending:
            if slot in self.active:
                # cannot happen while the refill condition above only picks
                # slots certain to retire; if it ever does, the live request's
                # rows were already overwritten by the queued prefill: requeue
                # the new request and say so
                _log.error("overlapped refill anomaly: slot %d did not retire; requeuing "
                           "request %d (live request %d's KV rows were overwritten: its "
                           "output is corrupt)", slot, nreq.rid, self.active[slot].rid)
                nreq.slot, nreq.pos = -1, 0
                nreq.out.clear()
                self.queue.appendleft(nreq)
                continue
            installable.append((slot, nreq, first))
        self._install_many(installable)
        return len(self.active)

    def run(self) -> dict:
        """Drain the queue -> rid -> generated token ids; self.stats holds the
        run's wall time, ticks (pipelined ones among them), tokens, tok/s,
        mean occupancy, read-backs and the time to first token (p50 / p99, from submit to the first token's
        read-back)."""
        t0 = time.perf_counter()
        ticks = occupancy = 0
        syncs0, piped0 = self.host_syncs, self.pipelined_ticks
        while self.queue or self.active:
            n_active = self.step()
            ticks += 1
            occupancy += n_active
        dt = time.perf_counter() - t0
        total_out = sum(len(r.out) for r in self.done.values())
        ttft = sorted(r.t_first - r.t_submit for r in self.done.values()
                      if r.t_first is not None)
        self.stats = {
            "wall_s": dt,
            "ticks": ticks,
            "tokens_out": total_out,
            "tok_s": total_out / dt if dt > 0 else 0.0,
            "requests_s": len(self.done) / dt if dt > 0 else 0.0,
            "avg_slot_occupancy": occupancy / max(ticks, 1),
            "host_syncs": self.host_syncs - syncs0,
            "pipelined_ticks": self.pipelined_ticks - piped0,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_p99_s": float(np.percentile(ttft, 99)) if ttft else None,
        }
        return {rid: req.out for rid, req in self.done.items()}
