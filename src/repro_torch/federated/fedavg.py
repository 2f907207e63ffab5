"""Client-side fine-tuning via federated averaging (the JAX package's
``federated/fedavg.py`` in torch): the paper's privacy-preserving update
path.

  server params --broadcast--> K clients
  each client: E local AdamW steps on ITS OWN trajectories (data never moves)
  each client: uploads only a parameter DELTA (optionally clipped + noised,
               the DP-SGD-at-the-update knob)
  server: sample-weighted average of deltas (FedAvg)

The client step reuses the centralized objective (``train.make_loss_fn``) and
optimizer, so a federated fine-tune is compatible with a checkpoint the
centralized path wrote.  JAX's ``lax.scan`` over the local steps is a loop;
DP noise is drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         global_norm, init_opt_state)
from repro_torch.train.trainer import (loss_and_grads, make_loss_fn,
                                       to_device)

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_rounds: int = 5
    local_steps: int = 5
    local_lr: float = 5e-4
    clip_delta_norm: Optional[float] = None    # per-client update clipping
    dp_noise_mult: float = 0.0                 # sigma * clip / n_clients noise
    server_lr: float = 1.0                     # 1.0 = plain FedAvg


def make_local_update(cfg: ModelConfig, fed: FedConfig,
                      objective: str = "delphi") -> Callable:
    """fn(params, client_batches) -> (delta, final_loss): ``local_steps``
    AdamW steps from ``params`` (a constant learning rate ``local_lr``, no
    warmup), one batch of ``client_batches`` (a sequence of tensor dicts)
    each, then the parameter delta, clipped to ``clip_delta_norm`` in
    global norm when set.  ``final_loss`` is the last step's loss, a 0-d
    tensor (no host sync)."""
    loss_fn = make_loss_fn(cfg, objective)
    ocfg = OptimizerConfig(lr=fed.local_lr, warmup_steps=0,
                           total_steps=max(fed.local_steps, 1),
                           min_lr_ratio=1.0)

    def local_update(params: Tensors, client_batches: Sequence[Tensors]):
        p, opt = params, init_opt_state(params)
        loss = None
        for batch in client_batches:
            grads, m = loss_and_grads(loss_fn, p, batch)
            p, opt, _ = adamw_update(grads, opt, p, ocfg)
            loss = m["loss"]
        with torch.no_grad():
            delta = {k: p[k] - params[k] for k in params}
            if fed.clip_delta_norm is not None:
                norm = global_norm(delta)
                scale = torch.clamp(fed.clip_delta_norm
                                    / torch.clamp(norm, min=1e-9), max=1.0)
                delta = {k: d * scale for k, d in delta.items()}
        return delta, loss

    return local_update


@torch.no_grad()
def aggregate(params: Tensors, deltas: Sequence[Tensors],
              weights: Sequence[float], fed: FedConfig,
              generator: Optional[torch.Generator] = None) -> Tensors:
    """Sample-weighted FedAvg of client deltas (+ Gaussian noise of std
    ``dp_noise_mult * clip_delta_norm / n_clients`` when both are set,
    drawn from ``generator``)."""
    w = torch.tensor(weights, dtype=torch.float32)
    w = (w / w.sum()).tolist()
    avg = {}
    for k in params:
        acc = None
        for wi, d in zip(w, deltas):
            term = wi * d[k].float()
            acc = term if acc is None else acc + term
        avg[k] = acc
    if fed.dp_noise_mult > 0.0 and fed.clip_delta_norm is not None:
        if generator is None:
            raise ValueError("DP noise needs a torch.Generator")
        sigma = fed.dp_noise_mult * fed.clip_delta_norm / max(len(deltas), 1)
        avg = {k: a + sigma * torch.randn(a.shape, generator=generator,
                                          device=a.device)
               for k, a in avg.items()}
    return {k: (p.float() + fed.server_lr * avg[k]).to(p.dtype)
            for k, p in params.items()}


def federated_finetune(params, cfg: ModelConfig,
                       client_iters: List[Iterator[Dict]], fed: FedConfig, *,
                       objective: str = "delphi",
                       generator: Optional[torch.Generator] = None,
                       eval_fn: Optional[Callable] = None,
                       log_fn: Callable[[str], None] = print,
                       device="cuda") -> Tuple[Tensors, Dict[str, list]]:
    """``fed.n_rounds`` of FedAvg over per-client numpy batch iterators, on
    ``device`` (the card unless the caller passes ``device="cpu"``).  Each
    element of ``client_iters`` yields batches *from that client's own
    patients only*, the privacy unit of the simulation.  DP noise comes
    from ``generator`` (a fresh one seeded 0 on ``device`` when none is
    given).  One host sync per round.  Returns (params, which do not
    require grad; history {"round", "client_loss", "val"})."""
    dev = resolve_device(device)
    params = {k: v.detach().to(dev, torch.float32) for k, v in params.items()}
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    local_update = make_local_update(cfg, fed, objective)
    hist = {"round": [], "client_loss": [], "val": []}
    for r in range(fed.n_rounds):
        deltas, weights, losses = [], [], []
        for it in client_iters:
            bs = [next(it) for _ in range(fed.local_steps)]
            delta, loss = local_update(params, [to_device(b, dev)
                                                for b in bs])
            deltas.append(delta)
            weights.append(float(bs[0]["tokens"].shape[0] * fed.local_steps))
            losses.append(loss)
        params = aggregate(params, deltas, weights, fed, generator=generator)
        hist["round"].append(r)
        client = torch.stack(losses).tolist()
        hist["client_loss"].append(sum(client) / len(client))
        msg = f"round {r}: mean client loss {hist['client_loss'][-1]:.4f}"
        if eval_fn is not None:
            v = float(eval_fn(params))
            hist["val"].append(v)
            msg += f" | server val {v:.4f}"
        log_fn(msg)
    return params, hist
