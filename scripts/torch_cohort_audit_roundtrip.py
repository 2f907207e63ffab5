"""Cohort sweep bit-parity and the privacy audit over HTTP, on the port.

The twin of ``scripts/cohort_audit_roundtrip.py`` that imports only
``repro_torch``, on ``--device`` (the card unless ``--device cpu``):

1. **Cohort parity**: a concurrent ``ScenarioEngine`` sweep through the
   port's paged, prefix-cached ``EngineBackend`` (its background loop) is
   bit-identical, patient for patient and event for event, to the
   straight-line per-patient oracle (``ring_reference_futures`` with
   ``monte_carlo_risk`` over its futures) under the same injected uniforms;
   a paired counterfactual re-forks from the shared history prefix and
   hits the engine's prefix index.
2. **Privacy audit round trip**: train a reduced Delphi with member
   canaries planted (``inject_canaries``, ``train_loop``), serve it over
   HTTP (``InferenceServer``), and run the audit CLI against the URL: the
   report must come back with a membership-inference AUC and CI in [0, 1],
   rates in [0, 1] and the remote backend's name.

Run:  PYTHONPATH=src python scripts/torch_cohort_audit_roundtrip.py
      [--device cpu] [--steps 80]
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

from repro_torch.api.client import EngineBackend
from repro_torch.cohort import (CounterfactualEdit, ScenarioEngine,
                                assert_sweep_parity)
from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.data import (SimulatorConfig, batches, generate_dataset,
                              pack_trajectories)
from repro_torch.privacy import inject_canaries, make_canaries
from repro_torch.privacy.audit import main as audit_main
from repro_torch.serve.server import InferenceServer
from repro_torch.train import OptimizerConfig, train_loop

W, BS, K = 64, 16, 4      # the paged-parity engine geometry


def check_cohort_parity(device) -> None:
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    params = init_delphi(cfg, 7, device)
    pats = []
    for i in range(6):
        rng = np.random.default_rng(500 + i)
        S = 6
        toks = np.concatenate([[3], rng.integers(13, 90, S - 1)])
        ages = np.concatenate([[0.0], np.sort(rng.uniform(1.0, 40.0,
                                                          S - 1))])
        pats.append((toks.astype(np.int32), ages.astype(np.float32)))

    be = EngineBackend.create(params, cfg, slots=K, max_context=W,
                              cache="paged", block_size=BS, blocks=64,
                              prefix_cache=True, device=device)
    se = ScenarioEngine(be, max_in_flight=3, seed=21)
    res = se.sweep(pats, n_futures=3, max_new=8, horizon=20.0)
    if res.n_failed:
        raise AssertionError(f"sweep failures: {res.n_failed}")
    stats = assert_sweep_parity(res, params, cfg, pats, seed=21,
                                n_futures=3, max_new=8, horizon=20.0,
                                slots=K, max_context=W, device=device)
    print(f"[1/2] cohort parity: {stats['patients_checked']} patients, "
          f"{stats['events_checked']} events bit-identical to the "
          f"straight-line oracle (prefix hit rate "
          f"{res.prefix_hit_rate:.2f})")

    # counterfactual arms must re-fork from the baseline's cached prefix
    rng = np.random.default_rng(999)
    S = 20
    toks = np.concatenate([[3], rng.choice(np.arange(13, 90), S - 1,
                                           replace=False)]).astype(np.int32)
    ages = np.concatenate([[0.0], np.sort(
        rng.uniform(1.0, 40.0, S - 1))]).astype(np.float32)
    be2 = EngineBackend.create(params, cfg, slots=K, max_context=W,
                               cache="paged", block_size=4, blocks=128,
                               prefix_cache=True, device=device)
    se2 = ScenarioEngine(be2, seed=3)
    edits = [CounterfactualEdit("remove", int(toks[-1])),
             CounterfactualEdit("insert", 44, age=float(ages[-2]))]
    reps = se2.counterfactual(toks, ages, edits, n_futures=3, max_new=6,
                              horizon=30.0)
    pc = be2.engine.pool_stats()["prefix_cache"]
    hits = pc["hits"] + pc["partial_hits"]
    if hits < len(edits):
        raise AssertionError(f"counterfactual arms missed the prefix cache "
                             f"({pc})")
    if not all(r.shared_prefix_len >= S - 2 for r in reps):
        raise AssertionError("an edit shares less than the history prefix")
    print(f"      counterfactual: {len(reps)} paired arms, shared prefix "
          f">= {S - 2}/{S}, prefix-cache hits {hits}")


def check_privacy_audit(steps: int, device) -> None:
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=1289)
    params = init_delphi(cfg, 2, device)
    sim = SimulatorConfig(n_train=96, n_val=4, seed=0)
    train, _ = generate_dataset(sim)
    canaries = make_canaries(4, sim, seed=0, secret_len=3, prefix_events=6)
    train = inject_canaries(train, canaries, repeats=8)
    ti = batches(pack_trajectories(train, 32), 16, seed=0)
    params, _ = train_loop(params, cfg,
                           OptimizerConfig(lr=6e-4, total_steps=steps),
                           ti, objective="delphi", steps=steps,
                           log_every=max(steps // 2, 1), device=device)

    server = InferenceServer(
        EngineBackend.create(params, cfg, slots=8, max_context=64,
                             cache="paged", prefix_cache=True,
                             device=device), port=0).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "audit.json")
            rc = audit_main(["--url", server.address,
                             "--canaries", "4", "--secret-len", "3",
                             "--prefix-events", "6", "--sim-seed", "0",
                             "--seed", "0", "--n-futures", "2",
                             "--max-new", "4", "--n-boot", "50",
                             "--out", out])
            if rc != 0:
                raise AssertionError(f"audit exited {rc}")
            with open(out) as f:
                report = json.load(f)
    finally:
        server.stop()

    lo, hi = report["mi_auc_ci"]
    checks = [report["backend"] == "remote",
              report["n_members"] == 2 and report["n_nonmembers"] == 2,
              0.0 <= report["mi_auc"] <= 1.0, 0.0 <= lo <= hi <= 1.0,
              0.0 <= report["member_extraction_rate"] <= 1.0,
              0.0 <= report["nonmember_extraction_rate"] <= 1.0,
              len(report["member_scores"]) == 2,
              all(s <= 0.0 for s in report["member_scores"])]
    if not all(checks):
        raise AssertionError(f"invalid audit report: {report}")
    print(f"[2/2] privacy audit over the wire: MI AUC "
          f"{report['mi_auc']:.2f} [{lo:.2f}, {hi:.2f}], extraction gap "
          f"{report['extraction_gap']:+.2f} "
          f"(trained {steps} steps with planted canaries)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=80,
                    help="training steps for the audited model")
    args = ap.parse_args(argv)
    check_cohort_parity(args.device)
    check_privacy_audit(args.steps, args.device)
    print(f"OK torch_cohort_audit_roundtrip on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
