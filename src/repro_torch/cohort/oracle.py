"""Straight-line oracle for cohort sweeps — the correctness gate (the JAX
package's ``cohort/oracle.py`` over the port's oracles).

The scenario engine's concurrency must be unobservable in results: a
sweep through worker threads, the engine's background loop, paged
blocks, copy-on-write forks and the prefix cache must be *bit-identical*
to running each patient alone through the port's scheduler-free
``ring_reference_futures`` (the engine's own module-level prefill, fork
and tick, in a straight line) under the same injected uniforms, with
``monte_carlo_risk`` over those futures.  This module recomputes that
per-patient answer and asserts exact equality event for event, risk item
for risk item.

Bit-parity contract (inherited from ``ring_reference_futures``): the
sweep engine runs with the same ``slots``/``max_context`` geometry on the
same device, ``slots >= n_futures`` so each patient's forks land in one
wave, and enough blocks that no request is preempted (recompute-resume
re-prefills at new shapes and is only semantically aligned).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cohort.engine import sweep_uniforms
from repro_torch.cohort.schemas import CohortSweepResult
from repro_torch.core.risk import (disease_chapter_map, futures_chapter_risk,
                                   futures_risk_items, monte_carlo_risk,
                                   pack_futures_trajectories)


def oracle_patient_futures(params, cfg, tokens, ages, uniforms, *,
                           max_new: int, slots: Optional[int] = None,
                           max_context: int = 512, device="cuda",
                           **oracle_kw
                           ) -> List[Tuple[List[int], List[float]]]:
    """The per-patient futures through the engine's exact decode path,
    scheduler-free (``ring_reference_futures``) on ``device``, as
    generated (tokens, fp32 ages) suffixes."""
    from repro_torch.serve.prefix import ring_reference_futures
    n = int(np.asarray(uniforms).shape[0])
    futs = ring_reference_futures(
        params, cfg, np.asarray(tokens), np.asarray(ages), n=n,
        max_new=max_new, uniforms=uniforms, slots=slots,
        max_context=max_context, device=device, **oracle_kw)
    return [([int(t) for t in ts], [float(a) for a in ags])
            for ts, ags in futs]


def assert_sweep_parity(sweep: CohortSweepResult, params, cfg,
                        patients: Sequence[Tuple], *, seed: int,
                        n_futures: int, max_new: int, horizon: float,
                        top: int = 10, slots: Optional[int] = None,
                        max_context: int = 512, device="cuda",
                        **oracle_kw) -> Dict[str, int]:
    """Assert the sweep is bit-identical to the per-patient oracle.

    For every successful patient: (1) each forked future's generated
    tokens AND ages match the oracle exactly, (2) the aggregated
    ``RiskReport`` equals ``futures_risk_items`` over the oracle futures,
    (3) the per-patient chapter risks equal BOTH the shared host
    aggregation and ``monte_carlo_risk(trajectories=..., chapter_of=...)``
    over the oracle futures on ``device``.
    ``slots``/``max_context`` must mirror the sweep engine's geometry.
    Raises ``AssertionError`` on the first divergence; returns counters."""
    dev = resolve_device(device)
    chapter_of = disease_chapter_map(cfg.vocab_size, device=dev)
    checked = events = 0
    for pr in sweep.results:
        if not pr.ok:
            continue
        tokens, ages = patients[pr.index]
        uniforms = sweep_uniforms(seed, pr.index, n_futures, max_new,
                                  cfg.vocab_size)
        oracle = oracle_patient_futures(
            params, cfg, tokens, ages, uniforms, max_new=max_new,
            slots=slots, max_context=max_context, device=dev, **oracle_kw)
        got = [(t.tokens, t.ages) for t in pr.result.trajectories]
        if len(got) != len(oracle):
            raise AssertionError(f"patient {pr.index}: {len(got)} futures "
                                 f"!= {len(oracle)}")
        for j, ((gt, ga), (ot, oa)) in enumerate(zip(got, oracle)):
            if [int(t) for t in gt] != ot:
                raise AssertionError(
                    f"patient {pr.index} future {j}: tokens diverge "
                    f"({list(gt)[:8]}... vs {ot[:8]}...)")
            if [float(a) for a in ga] != oa:
                raise AssertionError(
                    f"patient {pr.index} future {j}: ages diverge")
            events += len(ot)
        age0 = float(np.asarray(ages)[-1])
        want_items = futures_risk_items(oracle, age0, horizon,
                                        cfg.vocab_size, top=top)
        got_items = [(it.token, it.risk) for it in pr.result.risk.items]
        if got_items != want_items:
            raise AssertionError(
                f"patient {pr.index}: RiskReport diverges from oracle "
                f"({got_items} vs {want_items})")
        want_chap = futures_chapter_risk(oracle, age0, horizon,
                                         cfg.vocab_size)
        if not np.array_equal(np.asarray(pr.chapter_risk), want_chap):
            raise AssertionError(f"patient {pr.index}: chapter risks "
                                 f"diverge from host oracle")
        mc = monte_carlo_risk(
            params, cfg, torch.as_tensor(np.asarray(tokens), device=dev),
            torch.as_tensor(np.asarray(ages, np.float32), device=dev),
            horizon=horizon, chapter_of=chapter_of,
            trajectories=pack_futures_trajectories(
                tokens, ages, oracle, max_new=max_new, device=dev))
        # The tensor path accumulates the futures mean in float32; the host
        # oracle means in float64.  Identical indicator sets, so the only
        # slack is one fp32 rounding of the division.
        if not np.allclose(mc["chapter_risk"].cpu().numpy().astype(
                np.float64), want_chap, rtol=1e-6, atol=1e-7):
            raise AssertionError(f"patient {pr.index}: monte_carlo_risk "
                                 f"chapter_risk diverges")
        checked += 1
    return {"patients_checked": checked, "events_checked": events}
