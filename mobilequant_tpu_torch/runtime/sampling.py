"""Token sampling (the port of mobilequant_tpu/runtime/sampling.py): argmax,
temperature, top-k and top-p (nucleus), per call or per row.

The filters are plain tensor operations, as the JAX package computes them
in XLA: top-k keeps every logit >= the k-th largest (ties kept); top-p keeps
the smallest prefix of the descending order whose mass exceeds p, the
crossing token included. The draw is the Gumbel-max trick, argmax(logits +
G) with G = -log(-log(U)) and U from the caller's torch.Generator: a draw
from softmax(logits) that runs on the device and never reads a value back
to the host. torch's generator is not JAX's PRNG, so sampled tokens differ
between the packages; greedy rows, the kept sets and the distribution do
not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0          # 0 = disabled
    greedy: bool = False


def gumbel_argmax(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """A draw from softmax(logits) along the last axis (-inf entries are
    never drawn) -> int64 ids."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    return torch.argmax(logits.to(torch.float32) - torch.log(-torch.log(u)), dim=-1)


def _top_p_cutoff(sorted_desc: torch.Tensor, top_p) -> torch.Tensor:
    """The value at the end of the smallest descending prefix whose
    cumulative probability exceeds top_p (inclusive of the crossing token),
    (..., 1)."""
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    idx = torch.sum((cum - probs) < top_p, dim=-1, keepdim=True) - 1
    return torch.gather(sorted_desc, -1, idx)


def filter_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """`sample`'s scaled logits with every filtered entry at -inf: temperature,
    then top-k, then top-p over what top-k kept (the JAX `sample`'s order)."""
    neg = torch.tensor(-torch.inf, device=logits.device)
    x = logits.to(torch.float32) / max(cfg.temperature, 1e-6)
    if cfg.top_k and cfg.top_k > 0:
        kth = torch.topk(x, min(cfg.top_k, x.shape[-1]), dim=-1).values[..., -1:]
        x = torch.where(x < kth, neg, x)
    if cfg.top_p < 1.0:
        cut = _top_p_cutoff(torch.sort(x, dim=-1, descending=True).values, cfg.top_p)
        x = torch.where(x < cut, neg, x)
    return x


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           cfg: SamplerConfig) -> torch.Tensor:
    """logits (B, V) -> token ids (B,), int64."""
    if cfg.greedy or cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return gumbel_argmax(filter_logits(logits, cfg), generator)


def _rows(v, device, dtype) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(dtype)


def filter_logits_batched(logits: torch.Tensor, temperature, top_p, top_k) -> torch.Tensor:
    """`sample_batched`'s scaled and filtered logits: per-row temperature,
    top-k (0 = off) and top-p (1 = off), both cutoffs read off one
    descending sort of the scaled row and the larger one applied (the JAX
    `sample_batched`'s order: its top-p mass is over the unfiltered row)."""
    dev = logits.device
    t = _rows(temperature, dev, torch.float32)
    p = _rows(top_p, dev, torch.float32)
    k = _rows(top_k, dev, torch.long)
    neg = torch.tensor(-torch.inf, device=dev)
    x = logits.to(torch.float32) / torch.clamp(t, min=1e-6)[:, None]
    srt = torch.sort(x, dim=-1, descending=True).values
    V = x.shape[-1]
    k = torch.clamp(k, 0, V)
    kth = torch.gather(srt, -1, torch.clamp(k - 1, 0, V - 1)[:, None])
    kth = torch.where((k > 0)[:, None], kth, neg)
    p_cut = _top_p_cutoff(srt, p[:, None])
    p_cut = torch.where((p < 1.0)[:, None], p_cut, neg)
    return torch.where(x < torch.maximum(kth, p_cut), neg, x)


def sample_batched(logits: torch.Tensor, generator: Optional[torch.Generator],
                   temperature, top_p, top_k, greedy) -> torch.Tensor:
    """Per-row sampler parameters: logits (B, V); temperature / top_p (B,)
    float, top_k (B,) int (0 = off), greedy (B,) bool (arrays or tensors)
    -> token ids (B,), int64. Rows that are greedy or at temperature 0 take
    the argmax. With the same parameters on every row and the same
    generator state it draws what `sample` draws whenever top-k and top-p
    are not both on (with both on, the two functions' top-p masses differ,
    as in the JAX package)."""
    dev = logits.device
    sampled = gumbel_argmax(filter_logits_batched(logits, temperature, top_p, top_k),
                            generator)
    arg = torch.argmax(logits, dim=-1)
    hot = ~(_rows(greedy, dev, torch.bool) | (_rows(temperature, dev, torch.float32) == 0.0))
    return torch.where(hot, sampled, arg)


def loop_next_token(last: torch.Tensor, temperature=0.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Next-token select inside a decode loop: last (B, V) logits -> (B,) ids.
    temperature: a float (0 = argmax, no draw) or a per-slot (B,) tensor,
    where rows at 0 take the argmax and the others draw at their own
    temperature, so a batcher serves mixed plain-temperature requests in one
    loop."""
    if isinstance(temperature, (int, float)):
        if temperature > 0.0:
            return gumbel_argmax(last.to(torch.float32) / temperature, generator)
        return torch.argmax(last, dim=-1)
    t = torch.as_tensor(temperature, device=last.device).to(torch.float32)
    sampled = gumbel_argmax(last.to(torch.float32) / torch.clamp(t, min=1e-6)[:, None],
                            generator)
    return torch.where(t > 0.0, sampled, torch.argmax(last, dim=-1))


def sampler_arrays(cfgs):
    """A list of SamplerConfig -> the (B,) numpy operands of `sample_batched`
    (temperature, top_p, top_k, greedy)."""
    return (np.asarray([c.temperature for c in cfgs], np.float32),
            np.asarray([c.top_p for c in cfgs], np.float32),
            np.asarray([c.top_k for c in cfgs], np.int32),
            np.asarray([c.greedy for c in cfgs], bool))
