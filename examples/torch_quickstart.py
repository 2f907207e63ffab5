"""Quickstart on the port: the paper's pipeline end to end, in one file.

The twin of ``examples/quickstart.py`` on ``repro_torch``, on the card
unless ``--device cpu``:

1. simulate synthetic disease histories (the released-data stand-in),
2. train Delphi-2M (dual loss: next event + time-to-event),
3. generate future-trajectory predictions with the eq.-1 sampler
   (the ``flash_attention``, ``paged_decode_attention`` and
   ``tte_sample`` kernels on the card).

The last line of the output is the kernels' launch counts, as JSON.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--steps 120]
      [--device cpu]
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import generate_trajectories, init_delphi
from repro_torch.data import (SimulatorConfig, batches, dataset_stats,
                              generate_dataset, pack_trajectories)
from repro_torch.data import vocab as V
from repro_torch.kernels import ops
from repro_torch.train import OptimizerConfig, train_loop


def make_config(seq_len: int = 96):
    """Delphi-2M at its published width, fp32, ``seq_len`` positions."""
    return get_config("delphi-2m").replace(dtype="float32",
                                           max_seq_len=seq_len)


def make_data(patients: int, seq_len: int):
    """-> (train, val, packed train, packed val) from the simulator."""
    train, val = generate_dataset(SimulatorConfig(
        n_train=patients, n_val=max(patients // 8, 32)))
    return (train, val, pack_trajectories(train, seq_len),
            pack_trajectories(val, seq_len))


def train(params, cfg, packed_train, packed_val, steps: int, device):
    ti = batches(packed_train, 32, seed=0)
    vi = batches(packed_val, 32, seed=1)
    ocfg = OptimizerConfig(lr=6e-4, warmup_steps=max(steps // 20, 5),
                           total_steps=steps)
    return train_loop(params, cfg, ocfg, ti, objective="delphi",
                      steps=steps, eval_iter=vi,
                      eval_every=max(steps // 3, 20), device=device)


def predict(params, cfg, tok, age, *, max_new: int = 24, uniforms=None):
    """One patient's history -> (tokens, ages) of its predicted events.
    ``uniforms`` (max_new, V) are injected when given, else drawn from a
    generator seeded 7 on the parameters' device."""
    dev = params["embed/embed"].device
    u = None
    gen = None
    if uniforms is not None:
        u = torch.as_tensor(np.asarray(uniforms, np.float32)[None],
                            device=dev)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
    with torch.no_grad():
        out = generate_trajectories(
            params, cfg, torch.as_tensor(np.asarray(tok)[None], device=dev),
            torch.as_tensor(np.asarray(age, np.float32)[None], device=dev),
            max_new=max_new, uniforms=u, generator=gen)
    S = len(tok)
    n = int(out["n_generated"][0])
    return (out["tokens"][0, S:S + n].cpu().numpy().tolist(),
            out["ages"][0, S:S + n].cpu().numpy().tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--patients", type=int, default=1024)
    ap.add_argument("--seq-len", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_config(args.seq_len)
    params = init_delphi(cfg, 0, args.device)

    print("== 1. synthetic data (competing-risk simulator) ==")
    train_set, _, pt, pv = make_data(args.patients, args.seq_len)
    print("   stats:", dataset_stats(train_set))

    print("== 2. train (event CE + exponential time NLL) ==")
    params, hist = train(params, cfg, pt, pv, args.steps, args.device)
    print(f"   loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
          f"val {hist['val_loss']}")

    print("== 3. predict future trajectories (paper eq. 1) ==")
    tok, age = train_set[0]
    half = max(len(tok) // 2, 2)
    toks, ages = predict(params, cfg, tok[:half], age[:half], max_new=24)
    print(f"   patient history ({half} events, age "
          f"{age[half-1]:.1f}y) -> {len(toks)} predicted events:")
    for t, a in zip(toks, ages):
        print(f"     age {a:5.1f}  {V.code_name(int(t))}")
    print(json.dumps({"launch_counts": ops.launch_counts()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
