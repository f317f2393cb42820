"""Sampling on the device (port of ``repro.serving.sampling``).

Greedy (temperature <= 0) is an argmax in f32 that takes the first
index on ties, as ``jnp.argmax`` and ``np.argmax`` do. Temperature
sampling draws from softmax(logits / T) with a ``torch.Generator`` on
the logits' device: one seed gives one token stream. It cannot match the
JAX package's stream (the two PRNGs differ).
"""
from __future__ import annotations

from typing import Optional

import torch


def make_sampler(temperature: float):
    """``sampler(logits (B, V), gen) -> (B,) int64 tokens``."""
    greedy = temperature <= 0

    def sampler(logits: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        lf = logits.float()
        if greedy:
            return torch.argmax(lf, dim=-1)
        probs = torch.softmax(lf / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    return sampler
