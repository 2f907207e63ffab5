"""Training steps and loop of the port (the JAX package's
``train/trainer.py``), eager PyTorch.

Two objectives share one step factory:
* ``objective="delphi"``: the paper's dual loss over (tokens, ages, targets,
  target_dt, loss_mask) batches (``core.delphi.loss_fn``).
* ``objective="lm"``: next-token CE over the token stream, plus the MoE
  routers' aux loss weighted by ``cfg.router_aux_coef``.

Both differentiate through ``forward(..., differentiable=True)``: plain
torch ops, attention by ``models.attention.chunked_attention`` and Mamba2
layers (Mamba2, the hybrid Zamba2) by the plain SSD route of
``models.ssm.ssd_chunked``, MoE layers by ``models.moe.apply_moe`` (its
fp32 router, top-k and combine included); no kernel has a backward.  Gradients are
taken with respect to detached copies of the fp32 masters, and the
update returns tensors that do not require grad, so the parameters a
step or ``train_loop`` hands back can go straight to an engine or a
server (whose kernels refuse inputs that require grad).  The hybrid's
shared block is one set of leaves used by every application, so autograd
sums its gradients over the applications, as ``jax.grad`` does.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, sharded
from repro_torch.configs.base import ModelConfig
from repro_torch.core import losses as losses_lib
from repro_torch.core.delphi import loss_fn as delphi_loss_fn
from repro_torch.models import forward
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)

Tensors = Dict[str, torch.Tensor]


def lm_loss(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor], *,
            moe_impl: str = "dense_scan") -> Tensors:
    """Next-token CE over the text stream, as the JAX package's
    ``lm_loss``: ``loss = CE + cfg.router_aux_coef * aux_loss``, where
    ``aux_loss`` is the MoE routers' load-balance loss summed over the
    layers (0 for the families without a router, whose ``loss`` is the
    CE); ``event_ce`` is the CE.  A VLM's patches and an
    encoder-decoder's frames go through with the tokens, and the logits
    at the patch positions (the first ``text_offset``) are left out.
    ``moe_impl`` picks the MoE layers' dispatch (``models.moe``)."""
    inputs = {k: batch[k] for k in ("tokens", "ages", "patches", "frames")
              if k in batch}
    out = forward(params, cfg, inputs, mode="train", differentiable=True,
                  moe_impl=moe_impl)
    logits = out["logits"][:, out["text_offset"]:]
    tokens = batch["tokens"]
    ce = losses_lib.event_ce(logits[:, :-1], tokens[:, 1:]).mean()
    return {"loss": ce + cfg.router_aux_coef * out["aux_loss"],
            "event_ce": ce, "aux_loss": out["aux_loss"]}


def make_loss_fn(cfg: ModelConfig, objective: str = "lm", *,
                 moe_impl: str = "dense_scan") -> Callable:
    if objective == "delphi":
        return lambda p, b: delphi_loss_fn(p, cfg, b)
    if objective == "lm":
        return lambda p, b: lm_loss(p, cfg, b, moe_impl=moe_impl)
    raise ValueError(f"objective must be 'delphi' or 'lm': {objective!r}")


def loss_and_grads(loss_fn: Callable, params: Mapping[str, torch.Tensor],
                   batch) -> Tuple[Tensors, Tensors]:
    """(gradient of ``loss_fn(params, batch)["loss"]`` per parameter, the
    detached metrics), differentiating with respect to detached leaves so
    that no graph outlives the call.  A parameter the loss does not reach
    raises (autograd's own check), rather than getting a zero gradient.

    On DTensor parameters (a sharded step) the metrics are reduced to
    whole values on every rank before the backward, and each gradient is
    brought to its parameter's layout after it (the gradients'
    all-reduce over the data axes, once a leaf)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    first = next(iter(leaves.values()))
    with torch.enable_grad(), sharded.plain_as_replicated(first):
        m = loss_fn(leaves, batch)
        if sharded.is_dtensor(first):
            m = {k: sharded.replicated(v) for k, v in m.items()}
        grads = torch.autograd.grad(m["loss"], list(leaves.values()))
    if sharded.is_dtensor(first):
        grads = [sharded.redistribute(g, p.placements)
                 for g, p in zip(grads, leaves.values())]
    return dict(zip(leaves, grads)), {k: v.detach() for k, v in m.items()}


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    objective: str = "lm", *, moe_impl: str = "dense_scan"
                    ) -> Callable:
    """fn(params, opt_state, batch) -> (params, opt_state, metrics): one
    gradient of the objective and one AdamW update, no host sync."""
    loss_fn = make_loss_fn(cfg, objective, moe_impl=moe_impl)

    def train_step(params, opt_state, batch):
        grads, metrics = loss_and_grads(loss_fn, params, batch)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, ocfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_eval_step(cfg: ModelConfig, objective: str = "lm") -> Callable:
    loss_fn = make_loss_fn(cfg, objective)

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, batch)

    return eval_step


def to_device(batch: Mapping[str, np.ndarray], device) -> Tensors:
    """A numpy batch as tensors on ``device``.  To the card through pinned
    host memory and asynchronous copies: a copy from pageable memory would
    wait for the stream, a host sync every step."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(dev, non_blocking=True)
                  if dev.type == "cuda" else t.to(dev))
    return out


def train_loop(params, cfg: ModelConfig, ocfg: OptimizerConfig,
               train_iter: Iterator[Dict[str, Any]], *,
               objective: str = "delphi", steps: int = 200,
               eval_iter: Optional[Iterator[Dict[str, Any]]] = None,
               eval_every: int = 50, log_every: int = 10,
               log_fn: Callable[[str], None] = print,
               device="cuda") -> Tuple[Tensors, Dict[str, list]]:
    """Single-device training loop on ``device`` (the card unless the
    caller passes ``device="cpu"``): fp32 master parameters, activations in
    ``cfg.dtype``.  One host sync per logged step (and per evaluation).
    Returns (trained params, which do not require grad; history with the
    JAX package's keys)."""
    dev = resolve_device(device)
    params = {k: v.detach().to(dev, torch.float32) for k, v in params.items()}
    step_fn = make_train_step(cfg, ocfg, objective)
    eval_fn = make_eval_step(cfg, objective)
    opt_state = init_opt_state(params)
    hist = {"step": [], "loss": [], "event_ce": [], "time_nll": [],
            "val_loss": [], "val_step": []}
    nan = torch.tensor(float("nan"), device=dev)
    t0 = time.time()
    for i in range(steps):
        batch = to_device(next(train_iter), dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            loss, ce, tn, lr, gn = torch.stack([
                m["loss"], m["event_ce"], m.get("time_nll", nan),
                m["lr"], m["grad_norm"]]).tolist()
            hist["step"].append(i)
            hist["loss"].append(loss)
            hist["event_ce"].append(ce)
            hist["time_nll"].append(tn)
            log_fn(f"step {i:4d} loss {loss:.4f} ce {ce:.4f}"
                   f" time_nll {tn:.4f} lr {lr:.2e} gnorm {gn:.2f}"
                   f" ({time.time() - t0:.1f}s)")
        if eval_iter is not None and (i + 1) % eval_every == 0:
            vm = eval_fn(params, to_device(next(eval_iter), dev))
            hist["val_loss"].append(float(vm["loss"]))
            hist["val_step"].append(i)
            log_fn(f"  eval step {i:4d} val_loss {hist['val_loss'][-1]:.4f}")
    return params, hist
