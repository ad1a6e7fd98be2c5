"""Next-token selection inside the decode loop."""

from __future__ import annotations

from typing import Optional

import torch


def loop_next_token(last: torch.Tensor, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """last (B, V) logits -> (B,) token ids: the argmax at temperature 0,
    else a draw from softmax(last / temperature) with `generator` (a
    torch.Generator on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1)
    probs = torch.softmax(last.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
