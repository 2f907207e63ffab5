"""Training launcher of the port: synthetic data -> dual loss -> checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --arch delphi-2m \
        --steps 200 [--patients 2048] [--batch 32] [--seq-len 128] \
        [--lr 6e-4] [--seed 0] [--reduced] [--out DIR] [--device cuda]

The command line of ``repro.launch.train``, plus ``--device`` (the card
unless ``--device cpu``).  Parameters are fp32 masters from
``init_params(seed)``; activations run in ``cfg.dtype`` on the card (bf16
for Delphi-2M) and in fp32 on the CPU.  ``--out`` writes the JAX package's
checkpoint layout (``params.npz``, ``meta.json`` with the config) and
``history.json``: the port's server serves it (``python -m
repro_torch.serve.server --config ARCH --ckpt DIR``, the shapes from
``meta.json``) and the JAX package's ``restore`` and ``load_config`` read
it.  ``--reduced`` Delphi keeps the simulator's full event vocabulary.
A generic LM (``--arch tinyllama-1.1b`` and the other dense LMs,
``--arch mamba2-780m``, ``--arch zamba2-1.2b``) trains the ``lm``
objective on seeded random token ids; Mamba2 layers take the plain SSD
route (``models.ssm``).  Past 512 x 512 attention scores (``--arch
delphi-100m --seq-len 1024``) attention takes the blocked online-softmax
route with recompute (``models.attention``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.data import (SimulatorConfig, batches, dataset_stats,
                              generate_dataset, pack_trajectories)
from repro_torch.data import vocab as V
from repro_torch.models import init_params, param_count
from repro_torch.train import OptimizerConfig, save, train_loop


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="delphi-2m", choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--patients", type=int, default=7144)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the arch")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (cpu runs fp32 activations)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> Dict[str, Any]:
    """Train as the command line says; returns {"params", "cfg",
    "history", "seconds", "target_tokens"} (seconds: the training loop's
    wall time, evaluations included, ending in a device synchronise;
    target_tokens: the supervised positions of the training batches)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.age_encoding:
        # the simulated histories use the whole event vocabulary: a reduced
        # Delphi keeps it (the reduced width's 512 would index past the
        # embedding)
        cfg = cfg.replace(vocab_size=max(cfg.vocab_size, V.VOCAB_SIZE))
    if dev.type == "cpu":
        cfg = cfg.replace(dtype="float32")
    params = init_params(cfg, args.seed, dev)
    print(f"{cfg.name}: {param_count(params):,} params ({dev}, activations "
          f"{cfg.dtype}, fp32 masters)", flush=True)
    if cfg.age_encoding:
        sim = SimulatorConfig(n_train=args.patients, n_val=args.patients,
                              seed=args.seed)
        train_set, val_set = generate_dataset(sim)
        print("train data:", dataset_stats(train_set), flush=True)
        ti = batches(pack_trajectories(train_set, args.seq_len), args.batch,
                     seed=args.seed)
        vi = batches(pack_trajectories(val_set, args.seq_len), args.batch,
                     seed=args.seed + 1)
        objective = "delphi"
    else:
        rng = np.random.default_rng(args.seed)

        def lm_iter():
            while True:
                yield {"tokens": rng.integers(
                    0, cfg.vocab_size,
                    (args.batch, args.seq_len)).astype(np.int32)}
        ti, vi = lm_iter(), lm_iter()
        objective = "lm"
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                           total_steps=args.steps)
    targets = [0]

    def counted(it):
        """The training batches, counting their supervised targets."""
        for b in it:
            mask = b.get("loss_mask")
            targets[0] += (int(mask.sum()) if mask is not None
                           else b["tokens"].shape[0]
                           * (b["tokens"].shape[1] - 1))
            yield b
    t0 = time.perf_counter()
    params, hist = train_loop(
        params, cfg, ocfg, counted(ti), objective=objective,
        steps=args.steps, eval_iter=vi, eval_every=max(args.steps // 4, 25),
        log_fn=lambda s: print(s, flush=True), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"{args.steps} steps in {seconds:.2f}s: "
          f"{args.steps / seconds:.2f} steps/s, "
          f"{targets[0] / seconds:.1f} target tokens/s (evaluations "
          f"included)", flush=True)
    if args.out:
        save(args.out, params, cfg, extra={"history": hist})
        with open(os.path.join(args.out, "history.json"), "w") as f:
            json.dump(hist, f)
        print("saved to", args.out, flush=True)
    return {"params": params, "cfg": cfg, "history": hist,
            "seconds": seconds, "target_tokens": targets[0]}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
