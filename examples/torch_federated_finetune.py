"""Client-side federated fine-tuning on the port — the paper's
§Discussion future work.

The twin of ``examples/federated_finetune.py`` on ``repro_torch``, on the
card unless ``--device cpu``.  A model pretrained on the released
synthetic cohort is fine-tuned on K hospitals' *private* patients (here: a
cohort simulated with shifted hazards, a domain shift).  Patient data
never leaves its client; only clipped parameter deltas are averaged (DP
noise, when configured, comes from a seeded ``torch.Generator`` on the
device).  Training takes the plain differentiable route, so no kernel
launches.  The last line of the output is the kernels' launch counts, as
JSON.

Run:  PYTHONPATH=src python examples/torch_federated_finetune.py
      [--clients 6] [--device cpu]
"""
import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.core.delphi import loss_fn
from repro_torch.data import (SimulatorConfig, batches, generate_dataset,
                              pack_trajectories)
from repro_torch.federated import FedConfig, federated_finetune
from repro_torch.kernels import ops
from repro_torch.train import OptimizerConfig, train_loop


def make_config():
    """Delphi-2M at its published width, fp32, 96 positions."""
    return get_config("delphi-2m").replace(dtype="float32", max_seq_len=96)


def private_cohort(clients: int):
    """-> (per-client shards, packed private validation set): a cohort
    simulated with shifted hazards."""
    shifted = SimulatorConfig(n_train=64 * clients, n_val=128, seed=123,
                              mean_age_slope=0.5, death_age_slope=1.1,
                              mean_log_hazard=-10.0)
    private, private_val = generate_dataset(shifted)
    shards = [private[i::clients] for i in range(clients)]
    return shards, pack_trajectories(private_val, 96)


def val_loss_fn(cfg, packed_val, device):
    """The loss on the first 64 private validation rows, as a function of
    the parameters."""
    vb = {k: torch.as_tensor(v[:64], device=device)
          for k, v in packed_val.items()}

    def val_loss(p):
        with torch.no_grad():
            return loss_fn(p, cfg, vb)["loss"]
    return val_loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--pretrain-steps", type=int, default=60)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_config()
    params = init_delphi(cfg, 0, args.device)

    print("== pretrain on the public synthetic cohort ==")
    public, _ = generate_dataset(SimulatorConfig(n_train=512, n_val=8))
    it = batches(pack_trajectories(public, 96), 32, seed=0)
    params, _ = train_loop(
        params, cfg,
        OptimizerConfig(lr=6e-4, total_steps=args.pretrain_steps), it,
        objective="delphi", steps=args.pretrain_steps, log_every=20,
        device=args.device)

    print("== private cohort (shifted hazards = domain shift) ==")
    shards, pv = private_cohort(args.clients)
    val_loss = val_loss_fn(cfg, pv, params["embed/embed"].device)
    print(f"   pretrain model on private-domain val: "
          f"{float(val_loss(params)):.4f}")

    iters = [batches(pack_trajectories(s, 96), 16, seed=i)
             for i, s in enumerate(shards)]
    fed = FedConfig(n_rounds=args.rounds, local_steps=5, local_lr=5e-4,
                    clip_delta_norm=10.0)
    gen = torch.Generator(device=params["embed/embed"].device)
    gen.manual_seed(0)
    print(f"== federated fine-tune: {args.clients} clients x "
          f"{len(shards[0])} patients, deltas clipped, data stays local ==")
    params, hist = federated_finetune(params, cfg, iters, fed,
                                      generator=gen, eval_fn=val_loss,
                                      device=args.device)
    print(f"   private-domain val: {hist['val'][0]:.4f} -> "
          f"{min(hist['val']):.4f} (no patient record ever centralized)")
    print(json.dumps({"launch_counts": ops.launch_counts()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
