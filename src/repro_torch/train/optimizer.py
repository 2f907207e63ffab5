"""AdamW + cosine schedule + global-norm clipping on flat parameter dicts
(the JAX package's ``train/optimizer.py`` in torch).

The nanoGPT/llama recipe, implemented directly.  Optimizer state is {mu,
nu, step}: master parameters and both moments are fp32, the step an int32
tensor.  The learning rate, the bias corrections and the clip scale are
computed in fp32 tensors on the parameters' device, in JAX's order of
operations, so an update makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(ocfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to ``lr * min_lr_ratio`` at
    ``total_steps``; fp32 from an integer step tensor."""
    step = step.float()
    warm = ocfg.lr * step / max(ocfg.warmup_steps, 1)
    t = torch.clamp((step - ocfg.warmup_steps)
                    / max(ocfg.total_steps - ocfg.warmup_steps, 1), 0.0, 1.0)
    cos = ocfg.lr * (ocfg.min_lr_ratio + (1 - ocfg.min_lr_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < ocfg.warmup_steps, warm, cos)


def init_opt_state(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Zero fp32 moments beside each parameter and step 0 (int32)."""
    device = next(iter(params.values())).device
    return {"mu": {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for k, p in params.items()},
            "nu": {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over every tensor, leaves taken in
    sorted key order (the JAX package's leaf order of the same nested
    dict)."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


_NO_DECAY = ("scale", "bias", "b_fc", "b_proj", "bq", "bk", "bv", "A_log",
             "dt_bias", "D")


def _decay_mask(key: str) -> bool:
    """Weight-decay matrices only (no norms, biases or scalars), the
    nanoGPT rule; decided on the last path segment, as JAX's on the last
    path key."""
    name = key.rsplit("/", 1)[-1]
    return not any(s in name for s in _NO_DECAY)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: Dict[str, Any],
                 params: Mapping[str, torch.Tensor], ocfg: OptimizerConfig
                 ) -> Tuple[Tensors, Dict[str, Any], Tensors]:
    """One AdamW step.  Returns (new params, new state, {"lr",
    "grad_norm"}), the params in their own dtypes, computed in fp32; no
    tensor of the result requires grad."""
    step = opt_state["step"] + 1
    lr = cosine_lr(ocfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    bc1 = 1 - ocfg.b1 ** stepf
    bc2 = 1 - ocfg.b2 ** stepf
    mu, nu, new = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m = ocfg.b1 * opt_state["mu"][k] + (1 - ocfg.b1) * g
        v = ocfg.b2 * opt_state["nu"][k] + (1 - ocfg.b2) * torch.square(g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + ocfg.eps)
        if _decay_mask(k):
            u = u + ocfg.weight_decay * p.float()
        new[k] = (p.float() - lr * u).to(p.dtype)
        mu[k], nu[k] = m, v
    return new, {"mu": mu, "nu": nu, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
