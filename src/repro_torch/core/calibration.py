"""Calibration: generated trajectories against held-out data (the JAX
package's ``core/calibration.py``).

The summaries compared: the age-at-death distribution (its mean and the
share of trajectories that end in Death), events per year, and the ICD
chapter frequency profile (their L1 distance, model against data).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sampler import generate_trajectories
from repro_torch.data import vocab as V


def cohort_stats(trajs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> Dict:
    """Summaries of (tokens, ages) trajectories: mean age at death, the
    share that end in Death, mean disease events per year, and the (26,)
    chapter frequency profile."""
    death_age, rates, chapters = [], [], np.zeros(V.N_CHAPTERS)
    for tok, age in trajs:
        if V.DEATH in tok:
            death_age.append(age[-1])
        dis = tok >= V.DISEASE0
        if age[-1] > 1:
            rates.append(dis.sum() / age[-1])
        for c in tok[dis]:
            chapters[V.chapter_of(int(c))] += 1
    chapters = chapters / max(chapters.sum(), 1)
    return {"mean_death_age": float(np.mean(death_age)) if death_age else None,
            "death_frac": len(death_age) / max(len(trajs), 1),
            "events_per_year": float(np.mean(rates)) if rates else 0.0,
            "chapter_freq": chapters}


def generate_cohort(params, cfg: ModelConfig, seeds, *,
                    from_age: float = 40.0, max_new: int = 96,
                    batch: int = 32) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Sample synthetic continuations of a minimal prompt (the sex token at
    age 0, a NO_EVENT marker at ``from_age``), ``batch`` per seed, each
    seed's uniforms from a ``torch.Generator`` on the parameters' device.
    Returns the generated (tokens, ages) of every non-empty trajectory."""
    dev = params["embed/embed"].device
    prompts_t = torch.tensor([[V.SEX_FEMALE, V.NO_EVENT]], dtype=torch.int32,
                             device=dev).expand(batch, 2)
    prompts_a = torch.tensor([[0.0, from_age]], dtype=torch.float32,
                             device=dev).expand(batch, 2)
    out_trajs = []
    for seed in seeds:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        out = generate_trajectories(params, cfg, prompts_t, prompts_a,
                                    max_new=max_new, generator=gen)
        toks = out["tokens"][:, 2:].cpu().numpy()
        ages = out["ages"][:, 2:].cpu().numpy()
        ngen = out["n_generated"].cpu().numpy()
        for b in range(batch):
            n = int(ngen[b])
            if n:
                out_trajs.append((toks[b, :n], ages[b, :n]))
    return out_trajs


def calibration_report(params, cfg: ModelConfig,
                       held_out: Sequence[Tuple[np.ndarray, np.ndarray]], *,
                       n_batches: int = 2, max_new: int = 96,
                       batch: int = 32) -> Dict:
    """Held-out data against ``n_batches`` generated batches: both
    ``cohort_stats`` and the L1 distance of their chapter profiles."""
    data = cohort_stats(held_out)
    model = cohort_stats(generate_cohort(params, cfg, range(n_batches),
                                         max_new=max_new, batch=batch))
    l1 = float(np.abs(data["chapter_freq"] - model["chapter_freq"]).sum())
    return {"data": data, "model": model, "chapter_l1": l1}
