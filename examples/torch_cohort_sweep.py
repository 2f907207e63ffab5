"""Cohort-scale scenario analysis on the port: population risk and
counterfactuals.

The twin of ``examples/cohort_sweep.py`` on ``repro_torch``, on the card
unless ``--device cpu``.  Trains a small Delphi, then drives a synthetic
cohort through the paged, prefix-cached batching engine with the
``ScenarioEngine`` — bounded concurrency, per-patient injected uniforms
(bit-reproducible whatever the worker count), per-chapter population risk
— and ends with a paired counterfactual: "how do this patient's 10-year
chapter risks change if one diagnosis had (not) happened?", re-forked from
the shared history prefix under common random numbers.  The last line of
the output is the kernels' launch counts, as JSON.

Run:  PYTHONPATH=src python examples/torch_cohort_sweep.py [--patients 24]
      [--device cpu]
"""
import argparse
import json
import string

import numpy as np

from repro_torch.api.client import EngineBackend
from repro_torch.cohort import CounterfactualEdit, ScenarioEngine
from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.data import (SimulatorConfig, batches, generate_dataset,
                              pack_trajectories)
from repro_torch.data import vocab as V
from repro_torch.data.synthetic import patient
from repro_torch.kernels import ops
from repro_torch.train import OptimizerConfig, train_loop

HISTORY = 12        # events of each patient's history the sweep starts from


def make_config():
    """Delphi-2M at its published width, fp32, 160 positions."""
    return get_config("delphi-2m").replace(dtype="float32", max_seq_len=160)


def make_data():
    """The packed training set (512 patients, 96 positions)."""
    train, _ = generate_dataset(SimulatorConfig(n_train=512, n_val=8))
    return pack_trajectories(train, 96)


def make_patients(n: int):
    """The first (at most) :data:`HISTORY` events of ``n`` patients, drawn
    one at a time (no need to simulate the whole split)."""
    pats = []
    for i in range(n):
        tok, age = patient(i, SimulatorConfig(seed=7))
        k = min(HISTORY, max(len(tok) - 1, 2))
        pats.append((tok[:k], age[:k]))
    return pats


def train(params, cfg, packed, steps: int, device):
    ti = batches(packed, 32, seed=0)
    return train_loop(params, cfg, OptimizerConfig(lr=6e-4,
                                                   total_steps=steps),
                      ti, objective="delphi", steps=steps, log_every=20,
                      device=device)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--patients", type=int, default=24)
    ap.add_argument("--futures", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--horizon", type=float, default=10.0)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_config()
    params = init_delphi(cfg, 0, args.device)

    print(f"== train {args.steps} steps ==")
    params = train(params, cfg, make_data(), args.steps, args.device)

    pats = make_patients(args.patients)
    print(f"== sweep {len(pats)} patients x {args.futures} futures "
          f"({args.workers} workers) ==")
    backend = EngineBackend.create(params, cfg, slots=8, max_context=160,
                                   cache="paged", block_size=16, blocks=512,
                                   prefix_cache=True, device=args.device)
    engine = ScenarioEngine(backend, max_in_flight=args.workers, seed=1)
    res = engine.sweep(pats, n_futures=args.futures,
                       max_new=args.max_new, horizon=args.horizon)
    print(f"   {res.n_ok}/{res.n_patients} patients, "
          f"{res.events_total} events in {res.wall_s:.1f}s "
          f"({res.patients_per_s:.1f} patients/s, "
          f"{res.events_per_s:.1f} events/s, prefix hit rate "
          f"{res.prefix_hit_rate:.2f})")

    print(f"   population {args.horizon:.0f}y chapter risk (top 6):")
    for c in np.argsort(-res.chapter_mean)[:6]:
        label = ("non-disease" if c == 0
                 else f"chapter {string.ascii_uppercase[c - 1]}")
        bar = "#" * int(40 * res.chapter_mean[c])
        print(f"     {label:12s} {res.chapter_mean[c]:6.3f} {bar}")

    # paired counterfactual on the longest history in the cohort
    idx = max(range(len(pats)), key=lambda i: len(pats[i][0]))
    toks, ages = pats[idx]
    code = int(toks[len(toks) // 2])
    print(f"== counterfactual: patient {idx}, remove "
          f"{V.code_name(code)} at age "
          f"{float(ages[list(toks).index(code)]):.0f} ==")
    rep = engine.counterfactual(
        toks, ages, [CounterfactualEdit("remove", code)], n_futures=8,
        max_new=args.max_new, horizon=args.horizon)[0]
    print(f"   shared prefix {rep.shared_prefix_len}/{len(toks)} "
          f"events; top code-risk deltas:")
    for tok, base, edited, delta in rep.top_deltas[:6]:
        print(f"     {V.code_name(int(tok)):12s} "
              f"{base:.3f} -> {edited:.3f} ({delta:+.3f})")
    print(json.dumps({"launch_counts": ops.launch_counts()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
