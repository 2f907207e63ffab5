"""Delphi-2M task API of the port (the JAX package's ``core/delphi.py``):
the differentiable logits and the training objective.

The training route differentiates through plain torch ops only: attention is
``models.attention.chunked_attention`` (``forward(..., differentiable=
True)``), never a kernel (no kernel has a backward).  Weights come from
``models.init_params`` or a JAX checkpoint; the port re-initializes nothing.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import losses
from repro_torch.models import forward, init_params


def init_delphi(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """The port's ``init_params`` for a Delphi config."""
    if not (cfg.age_encoding and cfg.dual_head):
        raise ValueError(f"{cfg.name} is not a Delphi config")
    return init_params(cfg, seed, device)


def get_logits(params, cfg: ModelConfig, tokens: torch.Tensor,
               ages: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens + ages -> (B, S, V) fp32 logits, differentiable in
    the parameters."""
    return forward(params, cfg, {"tokens": tokens, "ages": ages},
                   mode="train", differentiable=True)["logits"]


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            time_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """Delphi training objective on a packed batch: tokens, ages, targets,
    target_dt, loss_mask, each (B, S)."""
    logits = get_logits(params, cfg, batch["tokens"], batch["ages"])
    return losses.dual_loss(logits, batch["targets"], batch["target_dt"],
                            batch["loss_mask"], time_weight=time_weight)
