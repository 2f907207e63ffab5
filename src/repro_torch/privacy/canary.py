"""Rarity-scored synthetic canary records for privacy red-teaming (numpy
only; a copy of the JAX package's ``privacy/canary.py``, the same records
bit for bit).

A canary is a plausible synthetic patient history (drawn from the same
competing-risk simulator as the training data) with an appended *secret*
— a short run of deliberately rare diagnoses chosen from the lowest
base-log-hazard codes of the simulated disease universe.  Rare codes
almost never co-occur by chance, so any probability mass the served
model puts on a canary's secret is evidence of memorization, not of the
population distribution.

Canaries come in deterministic member / non-member pairs (even index ->
trained-in, odd -> held-out): ``inject_canaries`` plants the members
into a training set, and the audit attacks
(:mod:`repro_torch.privacy.attacks`) score both groups identically so the
member-vs-nonmember separation IS the privacy leak.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.data import vocab as V
from repro_torch.data.synthetic import (SimulatorConfig, hazard_params,
                                        simulate_patient)

#: Disambiguates canary streams from ``data.synthetic.patient`` streams
#: and the cohort sweep's uniform streams under the same user seed.
_CANARY_TAG = 15485863

#: Fraction of the disease universe (rarest by base log-hazard) the
#: secret codes are drawn from.
RARE_FRACTION = 0.05


@dataclasses.dataclass
class Canary:
    """One canary record.  ``tokens[:secret_start]`` is the natural
    prefix; ``tokens[secret_start:]`` is the planted secret."""
    index: int
    tokens: np.ndarray
    ages: np.ndarray
    secret_start: int
    rarity: float
    member: bool

    @property
    def prefix_tokens(self) -> np.ndarray:
        return self.tokens[:self.secret_start]

    @property
    def prefix_ages(self) -> np.ndarray:
        return self.ages[:self.secret_start]

    @property
    def secret_tokens(self) -> List[int]:
        return [int(t) for t in self.tokens[self.secret_start:]]

    def to_json(self) -> dict:
        return {"index": int(self.index),
                "tokens": [int(t) for t in self.tokens],
                "ages": [float(a) for a in self.ages],
                "secret_start": int(self.secret_start),
                "rarity": float(self.rarity),
                "member": bool(self.member)}


def rare_code_pool(cfg: SimulatorConfig,
                   fraction: float = RARE_FRACTION) -> np.ndarray:
    """Disease-code indices (0-based, NOT vocab tokens) of the rarest
    ``fraction`` of the simulated universe by base log-hazard ``a`` —
    the canary secret alphabet."""
    a, _, _, _ = hazard_params(cfg)
    k = max(8, int(len(a) * fraction))
    return np.argsort(a, kind="stable")[:k]


def make_canaries(n: int, cfg: SimulatorConfig = SimulatorConfig(), *,
                  seed: int = 0, secret_len: int = 4,
                  prefix_events: int = 8) -> List[Canary]:
    """``n`` deterministic canaries over ``cfg``'s disease universe.

    Canary ``i`` derives everything from
    ``default_rng([cfg.seed, tag, seed, i])`` — O(1) regeneration, same
    discipline as ``data.synthetic.patient`` — so the audit CLI and the
    training-time ``inject_canaries`` agree on the exact records without
    shipping them.  Even indices are members (train them in), odd are
    held out.  ``rarity`` is the negative summed base log-hazard of the
    secret codes: higher = rarer = stronger memorization signal.
    """
    a, b, partners, boosts = hazard_params(cfg)
    pool = rare_code_pool(cfg)
    out: List[Canary] = []
    for i in range(n):
        rng = np.random.default_rng([cfg.seed, _CANARY_TAG, seed, i])
        toks, ags = simulate_patient(rng, a, b, partners, boosts, cfg)
        while len(toks) < 3:        # deterministic redraw from the same
            toks, ags = simulate_patient(rng, a, b, partners, boosts,
                                         cfg)   # per-canary stream
        k = min(prefix_events, len(toks))
        prefix_t, prefix_a = list(toks[:k]), list(ags[:k])
        if prefix_t[-1] == V.DEATH:             # a secret needs a future
            prefix_t, prefix_a = prefix_t[:-1], prefix_a[:-1]
        codes = rng.choice(pool, size=secret_len, replace=False)
        age = float(prefix_a[-1])
        secret_t, secret_a = [], []
        for c in codes:
            age += float(rng.uniform(0.5, 1.5))
            secret_t.append(int(V.DISEASE0 + int(c)))
            secret_a.append(age)
        out.append(Canary(
            index=i,
            tokens=np.asarray(prefix_t + secret_t, np.int32),
            ages=np.asarray(prefix_a + secret_a, np.float32),
            secret_start=len(prefix_t),
            rarity=float(-np.sum(a[codes])),
            member=(i % 2 == 0)))
    return out


def split_canaries(canaries: Sequence[Canary]
                   ) -> Tuple[List[Canary], List[Canary]]:
    """(members, nonmembers)."""
    return ([c for c in canaries if c.member],
            [c for c in canaries if not c.member])


def inject_canaries(train: List[Tuple[np.ndarray, np.ndarray]],
                    canaries: Sequence[Canary], *, repeats: int = 1
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Training set with every *member* canary planted ``repeats`` times
    (repetition strengthens memorization, as in real duplicated records).
    Non-members are never added — they are the control group."""
    out = list(train)
    for c in canaries:
        if c.member:
            out.extend([(c.tokens.copy(), c.ages.copy())] * repeats)
    return out
