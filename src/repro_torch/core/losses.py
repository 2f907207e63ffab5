"""Delphi-2M dual loss: next-event cross-entropy + exponential time-to-event
NLL (the JAX package's ``core/losses.py`` in torch).

The model emits one logit per vocabulary entry; rates are lambda_i =
exp(logit_i).  Under competing exponential clocks the joint NLL of observing
event j after waiting time dt factorizes exactly:

    NLL(j, dt) = Lambda*dt - logit_j
               = [logsumexp(logits) - logit_j]  +  [Lambda*dt - log(Lambda)]
               =        CE(event)               +     Exp-NLL(time)

with Lambda = sum_i exp(logit_i).  Both the factored form (what training
optimizes: ``ce + time_nll``) and the joint form are exposed; the
``logsumexp`` runs in fp32 whatever the logits' dtype.
"""
from __future__ import annotations

from typing import Dict

import torch


def _lse(logits: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(logits.float(), dim=-1)


def _target_logit(logits: torch.Tensor, targets: torch.Tensor):
    return logits.float().gather(-1, targets.long()[..., None])[..., 0]


def event_ce(logits, targets):
    """Per-position cross-entropy. logits (..., V), targets (...) int."""
    return _lse(logits) - _target_logit(logits, targets)


def time_nll(logits, dt):
    """Exponential waiting-time NLL with total rate Lambda = sum_i
    e^{logit_i}: Lambda*dt - log(Lambda), dt in years."""
    log_rate = _lse(logits)                                # log Lambda
    return torch.exp(log_rate) * dt - log_rate


def joint_nll(logits, targets, dt):
    """Competing-risk joint NLL: Lambda*dt - logit_j (== event_ce +
    time_nll)."""
    rate = torch.exp(_lse(logits))
    return rate * dt - _target_logit(logits, targets)


def dual_loss(logits, targets, dt, mask, *, time_weight: float = 1.0
              ) -> Dict[str, torch.Tensor]:
    """Masked mean of the Delphi dual objective.

    logits: (B, S, V); targets: (B, S) next-event ids; dt: (B, S) years
    until the next event; mask: (B, S) {0,1}, positions whose *target* is a
    real event (padding and no-event targets are excluded)."""
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (event_ce(logits, targets) * mask).sum() / denom
    tn = (time_nll(logits, dt) * mask).sum() / denom
    return {"loss": ce + time_weight * tn, "event_ce": ce, "time_nll": tn}
