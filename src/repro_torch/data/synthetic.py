"""Synthetic disease-history simulator (the released-data stand-in).

An age-dependent competing-risk model with comorbidity coupling:

  * per-code Gompertz hazard  lambda_i(age) = exp(a_i + b_i * age/10)
  * comorbidity boosts: each code has a few partner codes whose prior
    occurrence adds to its log-hazard
  * mortality hazard grows with age and with accumulated morbidity burden
  * "no event" marker tokens every 5 event-free years
  * diseases are first-occurrence (chronic): a code fires at most once

Trajectories are (tokens, ages) sequences starting with a sex token at age 0,
terminated by DEATH or censored at ``max_age``.  Fully deterministic given
the seed; the same seed gives the same patients as the JAX package's
simulator (the port's prompts match the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.data import vocab as V


@dataclasses.dataclass
class SimulatorConfig:
    n_train: int = 7144
    n_val: int = 7144
    seed: int = 0
    max_age: float = 85.0
    no_event_interval: float = 5.0
    mean_log_hazard: float = -10.4
    sd_log_hazard: float = 1.0
    mean_age_slope: float = 0.35     # per decade
    sd_age_slope: float = 0.15
    n_partners: int = 5
    partner_boost: float = 0.4
    death_base: float = -10.3
    death_age_slope: float = 0.9     # per decade (Gompertz mortality)
    death_morbidity_boost: float = 0.04
    max_events: int = 120


def _hazard_params(rng: np.random.Generator, cfg: SimulatorConfig):
    n = V.N_DISEASE
    a = rng.normal(cfg.mean_log_hazard, cfg.sd_log_hazard, n)
    b = np.clip(rng.normal(cfg.mean_age_slope, cfg.sd_age_slope, n), 0.0, None)
    partners = rng.integers(0, n, (n, cfg.n_partners))
    boosts = rng.uniform(0.2, 0.2 + cfg.partner_boost, (n, cfg.n_partners))
    return a, b, partners, boosts


def simulate_patient(rng: np.random.Generator, a, b, partners, boosts,
                     cfg: SimulatorConfig) -> Tuple[np.ndarray, np.ndarray]:
    tokens = [V.SEX_FEMALE if rng.random() < 0.5 else V.SEX_MALE]
    ages = [0.0]
    # one lifestyle token at age ~20 keeps the static-covariate pattern
    lifestyle_age = rng.uniform(18.0, 25.0)
    lifestyle_tok = V.LIFESTYLE0 + int(rng.integers(0, V.N_LIFESTYLE))

    age = 0.0
    occurred = np.zeros(V.N_DISEASE, bool)
    extra = np.zeros(V.N_DISEASE)          # comorbidity log-hazard boosts
    emitted_lifestyle = False

    def maybe_emit_lifestyle(new_age):
        # the static lifestyle token is emitted the moment age crosses its
        # recording age, BEFORE any event at new_age (keeps ages monotone)
        nonlocal emitted_lifestyle
        if not emitted_lifestyle and new_age >= lifestyle_age:
            tokens.append(lifestyle_tok)
            ages.append(lifestyle_age)
            emitted_lifestyle = True

    while len(tokens) < cfg.max_events:
        log_rates = a + b * (age / 10.0) + extra
        rates = np.where(occurred, 0.0, np.exp(log_rates))
        death_rate = np.exp(cfg.death_base + cfg.death_age_slope * (age / 10.0)
                            + cfg.death_morbidity_boost * occurred.sum())
        total = rates.sum() + death_rate
        dt = rng.exponential(1.0 / total)
        if dt > cfg.no_event_interval:
            # no event within the refresh window: emit marker, refresh hazards
            age += cfg.no_event_interval
            if age >= cfg.max_age:
                break
            maybe_emit_lifestyle(age)
            tokens.append(V.NO_EVENT)
            ages.append(age)
            continue
        age += dt
        if age >= cfg.max_age:
            break
        maybe_emit_lifestyle(age)
        if rng.random() < death_rate / total:
            tokens.append(V.DEATH)
            ages.append(age)
            break
        code = rng.choice(V.N_DISEASE, p=rates / rates.sum())
        occurred[code] = True
        extra[partners[code]] += boosts[code]
        tokens.append(V.DISEASE0 + code)
        ages.append(age)
    return np.asarray(tokens, np.int32), np.asarray(ages, np.float32)


def generate_dataset(cfg: SimulatorConfig = SimulatorConfig()
                     ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                                List[Tuple[np.ndarray, np.ndarray]]]:
    """Returns (train, val) lists of (tokens, ages) trajectories."""
    rng = np.random.default_rng(cfg.seed)
    a, b, partners, boosts = _hazard_params(rng, cfg)
    train = [simulate_patient(rng, a, b, partners, boosts, cfg)
             for _ in range(cfg.n_train)]
    val = [simulate_patient(rng, a, b, partners, boosts, cfg)
           for _ in range(cfg.n_val)]
    return train, val
