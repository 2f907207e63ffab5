"""Membership-inference and prompt-extraction probes — over the wire (the
JAX package's ``privacy/attacks.py`` over the port's backends).

Both attacks speak only the public inference surface
(:class:`repro_torch.api.InferenceBackend`: ``risk`` + ``sample_futures``), so
they audit exactly what a remote adversary with API access can measure —
no logits endpoint, no parameters.  ``RemoteBackend.logits`` raising is
the privacy boundary these probes respect by construction.

* **Membership inference** (loss-threshold attack): per-event
  log-likelihoods of a record under the served model, scored as the mean
  log P(next event = observed | history).  Members (trained-in canaries)
  score higher than held-out twins when the model memorizes; the
  separation is reported as ROC-AUC with a bootstrap CI.  AUC ~ 0.5
  means the model gives no membership signal; 1.0 means perfect
  re-identification.

* **Prompt extraction**: condition on a canary's natural prefix and
  sample N futures; the canary *leaks* when any single future emits at
  least ``match`` of its planted rare secret codes.  Rare codes
  essentially never co-occur by chance, so the member-vs-nonmember
  leakage gap is a direct verbatim-regurgitation measure.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.api.schemas import FuturesRequest
from repro_torch.privacy.canary import Canary

#: Horizon that saturates 1 - exp(-Lambda*h) -> 1, making the analytic
#: within-horizon risk equal softmax(logits) — an exact next-event
#: probability through the public ``risk`` endpoint.
INF_HORIZON = 1e9

_LOG_FLOOR = 1e-12


def event_log_likelihoods(backend, tokens: Sequence[int],
                          ages: Sequence[float], *, start: int = 1
                          ) -> np.ndarray:
    """log P(next = tokens[k] | tokens[:k]) for k in [start, len) via the
    public ``risk`` endpoint at a saturating horizon (top=V returns the
    full distribution).  One wire call per event."""
    out = []
    V = backend.vocab_size
    for k in range(start, len(tokens)):
        report = backend.risk(list(tokens[:k]), list(ages[:k]),
                              horizon=INF_HORIZON, top=V)
        probs = {it.token: it.risk for it in report.items}
        p = probs.get(int(tokens[k]), 0.0)
        out.append(np.log(max(p, _LOG_FLOOR)))
    return np.asarray(out, np.float64)


def membership_score(backend, canary: Canary, *,
                     secret_only: bool = True) -> float:
    """Mean per-event log-likelihood of a canary — the loss-threshold
    membership statistic.  ``secret_only`` scores just the planted
    secret (the rare events carry the memorization signal; the natural
    prefix is population-typical for members and non-members alike)."""
    start = canary.secret_start if secret_only else 1
    lls = event_log_likelihoods(backend, canary.tokens, canary.ages,
                                start=max(start, 1))
    return float(lls.mean()) if len(lls) else float(np.log(_LOG_FLOOR))


def membership_scores(backend, canaries: Sequence[Canary], *,
                      secret_only: bool = True) -> np.ndarray:
    return np.asarray([membership_score(backend, c,
                                        secret_only=secret_only)
                       for c in canaries], np.float64)


def roc_auc(pos: Sequence[float], neg: Sequence[float]) -> float:
    """Mann-Whitney ROC-AUC: P(member score > nonmember score), ties at
    0.5.  Exact over all pairs — no sorting approximations."""
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    if not len(pos) or not len(neg):
        return 0.5
    diff = pos[:, None] - neg[None, :]
    return float(np.mean((diff > 0) + 0.5 * (diff == 0)))


def bootstrap_auc_ci(pos: Sequence[float], neg: Sequence[float], *,
                     n_boot: int = 200, alpha: float = 0.05,
                     seed: int = 0) -> Tuple[float, float]:
    """Percentile bootstrap CI for :func:`roc_auc` (resampling each
    group independently with replacement)."""
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    if not len(pos) or not len(neg):
        return (0.5, 0.5)
    rng = np.random.default_rng(seed)
    aucs = np.empty(n_boot)
    for b in range(n_boot):
        aucs[b] = roc_auc(rng.choice(pos, size=len(pos)),
                          rng.choice(neg, size=len(neg)))
    lo, hi = np.quantile(aucs, [alpha / 2, 1.0 - alpha / 2])
    return (float(lo), float(hi))


def extraction_probe(backend, canary: Canary, *, n_futures: int = 8,
                     max_new: int = 16, match: int = 2,
                     seed: int = 0) -> bool:
    """True when the served model regurgitates the canary's secret:
    condition on the natural prefix, sample ``n_futures`` futures, and
    look for any single future containing >= ``match`` distinct secret
    codes.  Deterministic per (seed, canary) — the backend draws its
    uniforms from the request seed."""
    secret = set(canary.secret_tokens)
    req = FuturesRequest(
        tokens=[int(t) for t in canary.prefix_tokens],
        ages=[float(a) for a in canary.prefix_ages],
        n_futures=n_futures, max_new=max_new, top=1,
        seed=seed * 1000003 + canary.index + 1)
    out = backend.sample_futures(req)
    for t in out.trajectories:
        if len(secret & {int(x) for x in t.tokens}) >= match:
            return True
    return False


def extraction_rate(backend, canaries: Sequence[Canary], *,
                    n_futures: int = 8, max_new: int = 16,
                    match: int = 2, seed: int = 0
                    ) -> Tuple[float, List[bool]]:
    """Fraction of canaries whose secret leaks under
    :func:`extraction_probe`, plus the per-canary flags."""
    flags = [extraction_probe(backend, c, n_futures=n_futures,
                              max_new=max_new, match=match, seed=seed)
             for c in canaries]
    return (float(np.mean(flags)) if flags else 0.0, flags)
