"""Morbidity risk, the system's headline output (the JAX package's
``core/risk.py``, cut to what the port serves).

Two estimators over the same model:

* :func:`analytic_next_event_risk`: closed form from one forward pass.
  Under the competing-exponential model the probability that code i is the
  next event and happens within horizon h is

      P(i, t <= h) = (lambda_i / Lambda) * (1 - exp(-Lambda * h))

* :func:`monte_carlo_risk`: the eq.-1 sampler unrolled N times, counting
  the futures in which a code (or its ICD chapter) occurs within the
  horizon.  The futures come from the port's straight-line
  ``generate_trajectories``, or are passed in (``trajectories=``): those of
  :func:`engine_oracle_trajectories` are the serving engine's own, the
  futures that ``BatchedEngine.sample_futures`` must reproduce bit for bit.

The host-side aggregation of sampled futures (:func:`futures_risk_items`,
:func:`futures_chapter_risk`) is numpy only and gives the same numbers as
the JAX package's on the same trajectories.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sampler import generate_trajectories
from repro_torch.data import vocab as V
from repro_torch.models import forward


def analytic_next_event_risk(logits: torch.Tensor,
                             horizon: float) -> torch.Tensor:
    """logits (..., V) -> P(next event = i and it happens within the
    horizon), (..., V) fp32, summing to 1 - e^{-Lambda h} <= 1."""
    log_l = logits.float()
    log_rate = torch.logsumexp(log_l, dim=-1, keepdim=True)   # log Lambda
    frac = torch.softmax(log_l, dim=-1)                       # lambda_i/Lambda
    p_any = 1.0 - torch.exp(-torch.exp(log_rate) * horizon)
    return frac * p_any


def analytic_next_event_risk_np(logits, horizon: float) -> np.ndarray:
    """Host-side fp64 twin of :func:`analytic_next_event_risk` for one (V,)
    logit vector."""
    lg = np.asarray(logits).astype(np.float64)
    log_rate = np.logaddexp.reduce(lg)
    frac = np.exp(lg - log_rate)
    p_any = 1.0 - np.exp(-np.exp(log_rate) * horizon)
    return frac * p_any


def next_event_risk(params, cfg: ModelConfig, tokens: torch.Tensor,
                    ages: torch.Tensor, *,
                    horizon: float = 5.0) -> torch.Tensor:
    """One forward pass over (B, S) histories -> (B, V) within-horizon
    next-event risks from the logits at the last position."""
    out = forward(params, cfg, {"tokens": tokens, "ages": ages},
                  mode="train")
    return analytic_next_event_risk(out["logits"][:, -1], horizon)


def monte_carlo_risk(params, cfg: ModelConfig, tokens: torch.Tensor,
                     ages: torch.Tensor,
                     generator: Optional[torch.Generator] = None, *,
                     horizon: float = 5.0, n_samples: int = 64,
                     max_new: int = 48,
                     chapter_of: Optional[torch.Tensor] = None,
                     uniforms: Optional[torch.Tensor] = None,
                     trajectories: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Sampled multi-event risk of ONE patient.

    tokens/ages: (S,) history on the parameters' device.  The N futures
    are drawn in one batched ``generate_trajectories`` call, with
    ``uniforms`` (n_samples, max_new, V) injected or drawn from
    ``generator``; or ``trajectories`` (in that function's output format,
    e.g. :func:`engine_oracle_trajectories`) are aggregated as given.

    Returns ``code_risk`` (V,) P(code occurs within the horizon),
    ``death_risk`` () and, with ``chapter_of`` (V,) int, ``chapter_risk``
    (C,) P(any code of the chapter occurs within the horizon)."""
    S = tokens.shape[0]
    if trajectories is None:
        t = tokens[None].expand(n_samples, S)
        a = ages[None].expand(n_samples, S)
        out = generate_trajectories(params, cfg, t, a, max_new=max_new,
                                    uniforms=uniforms, generator=generator)
    else:
        out = trajectories
    gen_tok = out["tokens"][:, S:].long()              # (N, max_new)
    gen_age = out["ages"][:, S:]
    within = out["alive_mask"] & (gen_age <= ages[-1].float() + horizon)
    onehot = F.one_hot(gen_tok, cfg.vocab_size).float()
    occurred = (onehot * within[..., None].float()).amax(dim=1)   # (N, V)
    code_risk = occurred.mean(dim=0)
    res = {"code_risk": code_risk, "death_risk": code_risk[cfg.death_token]}
    if chapter_of is not None:
        C = int(chapter_of.max()) + 1
        chap_onehot = F.one_hot(chapter_of.long(), C).float()
        chap_occ = (occurred @ chap_onehot.to(occurred.device)).clamp(0.0,
                                                                      1.0)
        res["chapter_risk"] = chap_occ.mean(dim=0)
    return res


def engine_oracle_trajectories(params, cfg: ModelConfig, tokens, ages, *,
                               n_samples: int, max_new: int, uniforms,
                               slots: Optional[int] = None,
                               max_context: int = 512, device="cuda",
                               **oracle_kw) -> Dict[str, torch.Tensor]:
    """N futures drawn through the serving engine's own decode path (the
    port's ``serve.prefix.ring_reference_futures``), packed in the
    ``generate_trajectories`` format for :func:`monte_carlo_risk`'s
    ``trajectories=``.  Under the same injected ``uniforms``
    (n_samples, max_new, V) and engine geometry, the engine's
    ``sample_futures`` reproduces them bit for bit."""
    from repro_torch.serve.prefix import ring_reference_futures
    toks = np.asarray(tokens)
    ags = np.asarray(ages)
    futs = ring_reference_futures(
        params, cfg, toks, ags, n=n_samples, max_new=max_new,
        uniforms=uniforms, slots=slots, max_context=max_context,
        device=device, **oracle_kw)
    return pack_futures_trajectories(toks, ags, futs, max_new=max_new,
                                     device=device)


def pack_futures_trajectories(tokens, ages,
                              futures: Sequence[Tuple[Sequence[int],
                                                      Sequence[float]]],
                              *, max_new: int,
                              device="cuda") -> Dict[str, torch.Tensor]:
    """Pack N futures (new tokens and ages only, of any length) over one
    (S,) history into the ``generate_trajectories`` output format, on
    ``device`` (the card unless the caller asks for the CPU), for
    :func:`monte_carlo_risk`'s ``trajectories=``."""
    dev = resolve_device(device)
    toks = np.asarray(tokens)
    ags = np.asarray(ages)
    S = len(toks)
    n_samples = len(futures)
    tok_buf = np.zeros((n_samples, S + max_new), np.int64)
    age_buf = np.zeros((n_samples, S + max_new), np.float32)
    alive = np.zeros((n_samples, max_new), bool)
    tok_buf[:, :S] = toks
    age_buf[:, :S] = ags
    for j, (ts, as_) in enumerate(futures):
        k = len(ts)
        tok_buf[j, S:S + k] = ts
        age_buf[j, S:S + k] = np.asarray(as_, np.float32)
        age_buf[j, S + k:] = (as_[-1] if k else ags[-1])
        alive[j, :k] = True

    def dv(x):
        return torch.from_numpy(x).to(dev)
    return {"tokens": dv(tok_buf), "ages": dv(age_buf),
            "alive_mask": dv(alive),
            "n_generated": dv(np.asarray([len(t) for t, _ in futures],
                                         np.int32))}


def _seen_codes(toks, ags, cutoff: np.float32) -> set:
    """The codes of one future at an age <= cutoff (fp32 comparison, as the
    mask of :func:`monte_carlo_risk`); every code when it has no ages."""
    if ags is not None and len(ags):     # len(), not truthiness: ages may
        return {int(t) for t, a in zip(toks, ags)        # be np arrays
                if np.float32(a) <= cutoff}
    return {int(t) for t in toks}


def futures_risk_items(trajectories: Sequence[Tuple[Sequence[int],
                                                    Sequence[float]]],
                       age0: float, horizon: float, vocab_size: int,
                       top: int = 10) -> List[Tuple[int, float]]:
    """Within-horizon code risks over N sampled futures: P(code) = the
    share of futures in which the code occurs at an age <= age0 + horizon.
    Returns ``[(token, risk), ...]`` by risk, highest first, top-k."""
    n = max(len(trajectories), 1)
    cutoff = np.float32(np.float32(age0) + np.float32(horizon))
    counts = np.zeros(vocab_size, np.int64)
    for toks, ags in trajectories:
        for t in _seen_codes(toks, ags, cutoff):
            if 0 <= t < vocab_size:
                counts[t] += 1
    risk = counts / float(n)
    order = np.argsort(-risk, kind="stable")[:top]
    return [(int(i), float(risk[i])) for i in order]


def futures_chapter_risk(trajectories: Sequence[Tuple[Sequence[int],
                                                      Sequence[float]]],
                         age0: float, horizon: float,
                         vocab_size: int) -> np.ndarray:
    """Per-chapter within-horizon risk over N sampled futures: P(chapter) =
    the share of futures in which ANY code of the chapter occurs at an age
    <= age0 + horizon; the same cutoff as :func:`futures_risk_items` and
    the same chapters as ``monte_carlo_risk(chapter_of=
    disease_chapter_map(V))``.  Returns (C,) float64, index 0 the
    non-disease bucket, 1.. the ICD chapters."""
    chap = disease_chapter_map_np(vocab_size)
    C = int(chap.max()) + 1
    n = max(len(trajectories), 1)
    cutoff = np.float32(np.float32(age0) + np.float32(horizon))
    counts = np.zeros(C, np.int64)
    for toks, ags in trajectories:
        seen = _seen_codes(toks, ags, cutoff)
        for c in {int(chap[t]) for t in seen if 0 <= t < vocab_size}:
            counts[c] += 1
    return counts / float(n)


def disease_chapter_map_np(vocab_size: int) -> np.ndarray:
    """(V,) chapter index per token: 0 for specials and lifestyle codes,
    1 + the ICD chapter for a disease code."""
    out = np.zeros(vocab_size, np.int32)
    for c in range(V.DISEASE0, min(vocab_size, V.VOCAB_SIZE)):
        out[c] = V.chapter_of(c) + 1
    return out


def disease_chapter_map(vocab_size: int, device="cuda") -> torch.Tensor:
    """Tensor twin of :func:`disease_chapter_map_np` for
    ``monte_carlo_risk(chapter_of=...)``, on ``device`` (the card unless
    the caller asks for the CPU)."""
    return torch.from_numpy(disease_chapter_map_np(vocab_size)).to(
        resolve_device(device))
