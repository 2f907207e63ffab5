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

On DTensors whose vocabulary is split over the mesh's ``model`` axis, the
log-sum-exp and the target's logit are reduced over the axis from each
rank's slice (a max, a sum and the target's logit: one value a position
each), as the reference's partitioner does, rather than gathering the
logits.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import sharded


def _lse(logits: torch.Tensor) -> torch.Tensor:
    if sharded.is_dtensor(logits):
        x = logits.float()
        m = sharded.reduce_rows(x.detach().amax(dim=-1, keepdim=True))
        total = sharded.reduce_rows(torch.exp(x - m).sum(dim=-1))
        return torch.log(total) + m[..., 0]
    return torch.logsumexp(logits.float(), dim=-1)


def _target_logit(logits: torch.Tensor, targets: torch.Tensor):
    if sharded.is_dtensor(logits):
        return _sharded_target_logit(logits.float(), targets)
    return logits.float().gather(-1, targets.long()[..., None])[..., 0]


def _sharded_target_logit(x, targets):
    """The logit at each target of DTensor logits ``x`` (..., V): each
    rank reads the targets inside its slice of the vocabulary (0
    elsewhere), and the slices' values are summed over ``model``."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = x.device_mesh
    vdim = x.ndim - 1
    rows = sharded.batch_placements(x.placements, dm)
    split = [i for i, p in enumerate(x.placements) if p == Shard(vdim)]
    xp, outp = list(rows), list(rows)
    for i in split:
        xp[i], outp[i] = Shard(vdim), Partial()
    x = sharded.redistribute(x, xp)
    t = sharded.as_batch_sharded(targets, x)

    def local(xl, tl):
        idx = tl.long()
        if not split:
            return xl.gather(-1, idx[..., None])[..., 0]
        V = xl.shape[-1]
        idx = idx - sharded.model_rank(dm) * V
        held = (idx >= 0) & (idx < V)
        g = xl.gather(-1, idx.clamp(0, V - 1)[..., None])[..., 0]
        return torch.where(held, g, torch.zeros_like(g))
    out = local_map(local, out_placements=outp, in_placements=(xp, rows),
                    device_mesh=dm)(x, t)
    return sharded.reduce_rows(out)


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
