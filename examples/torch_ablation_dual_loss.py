"""Ablation on the port: the paper's dual loss against an event-only
objective.

The twin of ``examples/ablation_dual_loss.py`` on ``repro_torch``, on the
card unless ``--device cpu``.  Delphi's defining training choice is the
*dual* objective — next-event CE plus the exponential time-to-event NLL
over the same logit head (rates lambda_i = e^{logit_i}).  This ablation
trains the same model with time_weight in {0, 1} (AdamW) and evaluates
both terms on held-out patients:

  * time_weight=1 must reach a much lower val time-NLL (it models waiting
    times) at little or no cost in event CE;
  * with time_weight=0 the logit scale is unconstrained, so the implied
    total rate (and so the sampled waiting times) is arbitrary — the
    reason the paper's eq.-1 sampler needs the dual loss.

Training takes the plain differentiable route, so no kernel launches.  The
last line of the output is the kernels' launch counts, as JSON.

Run:  PYTHONPATH=src python examples/torch_ablation_dual_loss.py
      [--steps 80] [--device cpu]
"""
import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.core.delphi import get_logits, loss_fn
from repro_torch.data import (SimulatorConfig, batches, generate_dataset,
                              pack_trajectories)
from repro_torch.kernels import ops
from repro_torch.train import OptimizerConfig, init_opt_state
from repro_torch.train.optimizer import adamw_update
from repro_torch.train.trainer import loss_and_grads


def make_config():
    """Delphi-2M at its published width, fp32, 96 positions."""
    return get_config("delphi-2m").replace(dtype="float32", max_seq_len=96)


def make_data(patients: int):
    """-> (packed train, packed validation) sets."""
    train, val = generate_dataset(SimulatorConfig(n_train=patients,
                                                  n_val=128))
    return pack_trajectories(train, 96), pack_trajectories(val, 96)


def _on(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_one(cfg, data_iter, steps: int, time_weight: float, *,
              seed: int = 0, device="cuda"):
    """``steps`` AdamW steps of the dual loss at ``time_weight`` from
    ``init_delphi(cfg, seed)``."""
    params = init_delphi(cfg, seed, device)
    dev = params["embed/embed"].device
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=max(steps // 10, 3),
                           total_steps=steps)

    def scalar(p, batch):
        return loss_fn(p, cfg, batch, time_weight=time_weight)

    opt = init_opt_state(params)
    for _ in range(steps):
        g, _ = loss_and_grads(scalar, params, _on(next(data_iter), dev))
        params, opt, _ = adamw_update(g, opt, params, ocfg)
    return params


@torch.no_grad()
def evaluate(cfg, params, val_iter, n_batches: int = 4):
    """-> (val event CE, val time NLL, implied total rate a year), each the
    mean over ``n_batches`` batches."""
    dev = params["embed/embed"].device
    ce = tn = lam = 0.0
    for _ in range(n_batches):
        b = _on(next(val_iter), dev)
        m = loss_fn(params, cfg, b, time_weight=1.0)
        ce += float(m["event_ce"]) / n_batches
        tn += float(m["time_nll"]) / n_batches
        # implied total event rate at supervised positions
        lg = get_logits(params, cfg, b["tokens"], b["ages"])
        rate = torch.exp(torch.logsumexp(lg, dim=-1))
        mask = b["loss_mask"]
        lam += float(torch.sum(rate * mask)
                     / torch.clamp(torch.sum(mask), min=1)) / n_batches
    return ce, tn, lam


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--patients", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_config()
    pt, pv = make_data(args.patients)

    # empirical event rate of the data (events per patient-year)
    dt = pt["target_dt"][pt["loss_mask"] > 0]
    print(f"data: mean waiting time {dt.mean():.3f}y "
          f"-> empirical rate ~{1 / dt.mean():.2f}/y")

    print(f"{'time_weight':>12s} {'val event CE':>14s} "
          f"{'val time NLL':>14s} {'implied rate/y':>15s}")
    for tw in (0.0, 1.0):
        params = train_one(cfg, batches(pt, 32, seed=0), args.steps, tw,
                           device=args.device)
        ce, tn, lam = evaluate(cfg, params, batches(pv, 32, seed=1))
        print(f"{tw:12.1f} {ce:14.4f} {tn:14.4f} {lam:15.3f}")
    print("(dual loss calibrates the total rate toward the empirical rate; "
          "event-only leaves it arbitrary)")
    print(json.dumps({"launch_counts": ops.launch_counts()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
