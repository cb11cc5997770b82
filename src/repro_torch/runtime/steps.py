"""Step functions: prefill_step / serve_step factories.

Both run eagerly and without autograd (serving).  ``make_train_step`` waits
for the training slice and ``make_step`` for ``core/workload.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def make_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def prefill_step(model, batch):
        logits, _ = transformer.forward(model, cfg, batch)
        return logits

    return prefill_step


def make_serve_step(cfg: ArchConfig, sample: bool = True,
                    temperature: float = 1.0):
    """One decode iteration: token in, next token + new cache.

    ``generator`` (a ``torch.Generator`` on the tokens' device) drives the
    sampling and may be ``None`` for ``sample=False``."""

    @torch.no_grad()
    def serve_step(model, state, tokens,
                   generator: Optional[torch.Generator] = None):
        logits, new_state = transformer.decode_step(model, cfg, state, tokens)
        last = logits[:, -1]
        if sample:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = torch.argmax(last, dim=-1)
        return next_tok.to(torch.int32), new_state

    return serve_step
