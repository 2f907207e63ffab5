"""Architecture zoo on the port: every assigned architecture as a
selectable config.

The twin of ``examples/arch_zoo.py`` on ``repro_torch``, on the card unless
``--device cpu``.  Runs a reduced variant of each family through forward +
prefill + decode and prints a table (the full configs are exercised by the
dry run: ``python -m repro_torch.launch.dryrun --all``).  On the card the
prefill runs the ``flash_attention`` kernel, the decode step the
``paged_decode_attention`` kernel, and Mamba2's and Zamba2's SSD layers the
``ssd_intra`` kernel.  The last line of the output is the kernels' launch
counts, as JSON.

Run:  PYTHONPATH=src python examples/torch_arch_zoo.py
      [--arch tinyllama-1.1b] [--device cpu]
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.models import decode_step, forward, init_params, param_count


def make_batch(cfg, device, B: int = 2, S: int = 32):
    """Random inputs of the family's kind: tokens, and ages, patches or
    frames where the config takes them."""
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=device)
    batch = {"tokens": t(rng.integers(3, cfg.vocab_size, (B, S)))}
    if cfg.age_encoding:
        batch["ages"] = t(np.cumsum(rng.uniform(0.0, 3.0, (B, S)), axis=1)
                          .astype(np.float32))
    if cfg.frontend == "vision_patches":
        batch["patches"] = t(rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "audio_frames":
        batch["frames"] = t(rng.standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32))
    return batch


@torch.no_grad()
def run_one(arch: str, device) -> dict:
    """Forward, prefill and one decode step of the reduced ``arch`` ->
    {"arch", "params", "seconds", "finite"}."""
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    params = init_params(cfg, 0, device)
    batch = make_batch(cfg, device)
    S = batch["tokens"].shape[1]
    t0 = time.time()
    out = forward(params, cfg, batch, mode="train")
    pre = forward(params, cfg, batch, mode="prefill", cache_width=64)
    db = {"tokens": batch["tokens"][:, :1]}
    if cfg.age_encoding:
        db["ages"] = batch["ages"][:, :1]
    step_pos = S + (cfg.n_frontend_tokens
                    if cfg.frontend == "vision_patches" else 0)
    d = decode_step(params, cfg, pre["cache"], db, step_pos)
    ok = bool(torch.isfinite(out["logits"]).all()
              & torch.isfinite(d["logits"]).all())
    dt = time.time() - t0
    full = get_config(arch)
    print(f"{arch:24s} {full.arch_type:7s} L{full.n_layers:<3d} "
          f"d{full.d_model:<5d} V{full.vocab_size:<7d} "
          f"| reduced {param_count(params)/1e6:5.2f}M params "
          f"fwd+prefill+decode {dt:5.2f}s finite={ok}")
    return {"arch": arch, "params": param_count(params), "seconds": dt,
            "finite": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None,
                    help="run one architecture (default: all 10)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    print(f"{'architecture':24s} {'type':7s} production-spec | "
          f"reduced smoke")
    rows = [run_one(a, args.device) for a in archs]
    print(json.dumps({"launch_counts": ops.launch_counts()}))
    return 0 if all(r["finite"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
