"""Margin-aware comparison of event trajectories from two runs.

Two runs that see the same uniforms emit the same events until an argmin
falls inside their numeric disagreement, and then their trajectories part.
They part for good, and their ages drift apart even before: the age
encoding's top frequency is 1000 rad/year, so a 1e-6 year difference in an
age is a phase difference of 1e-3 rad in the next step's input, which the
untrained model turns into a larger difference of the next waiting time.
Comparing two free-running trajectories event by event therefore says
little past the first step.

So each trajectory is held step by step against a reference model on its
OWN prefix (teacher forcing, :func:`check_trajectories`): at every step the
reference model's logits on the prompt plus the events emitted so far,
under the same uniform row, must pick the emitted event (or one whose
waiting time is within ``margin_tol`` of it: a near-tie), the age must
advance by the reference's waiting time, and the trajectory must end where
the reference says it ends (Death, censoring at ``max_age``, the budget or
a full context).  Two free-running runs are then compared up to their first
divergence (:func:`compare_runs`).

A generic LM (Mamba2) samples by Gumbel-argmax instead:
:func:`check_lm_trajectories` holds each emitted token against the argmax
of the reference's scores ``logits / temperature + g(u)`` on its own
prefix, with the same margin rule on the scores.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sampler import sample_waiting_times
from repro_torch.models import forward

Trajectory = Tuple[Sequence[int], Sequence[float]]
# (tokens (B, S) int, ages (B, S) float32) -> (B, S, V) float32 logits at
# every position
LogitsFn = Callable[[np.ndarray, np.ndarray], np.ndarray]


def port_logits_fn(params, cfg) -> LogitsFn:
    """A :data:`LogitsFn` of the port's own model (``forward`` in train
    mode) on the parameters' device."""
    dev = params["embed/embed"].device

    def fn(tokens: np.ndarray, ages: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            out = forward(params, cfg,
                          {"tokens": torch.as_tensor(tokens, device=dev),
                           "ages": torch.as_tensor(ages, device=dev)})
        return out["logits"].float().cpu().numpy()
    return fn


def _teacher_forced_logits(prompts: Sequence[Trajectory],
                           trajs: Sequence[Trajectory],
                           n_rows: Sequence[int], logits_fn: LogitsFn, *,
                           batch: int = 8) -> List[np.ndarray]:
    """For each request, the reference's logits (k, V) at steps 0..k-1 of
    its trajectory (k from ``n_rows``), each from the prompt plus the
    events before it, in right-padded batches."""
    seqs = []
    for (pt, pa), (ot, oa), k in zip(prompts, trajs, n_rows):
        seqs.append((np.concatenate([np.asarray(pt, np.int64),
                                     np.asarray(ot, np.int64)]),
                     np.concatenate([np.asarray(pa, np.float32),
                                     np.asarray(oa, np.float32)]),
                     len(pt), k))
    out: List[np.ndarray] = []
    for i0 in range(0, len(seqs), batch):
        chunk = seqs[i0:i0 + batch]
        S = max(len(t) for t, _, _, _ in chunk)
        toks = np.zeros((len(chunk), S), np.int64)
        ags = np.zeros((len(chunk), S), np.float32)
        for j, (t, a, _, _) in enumerate(chunk):
            toks[j, :len(t)] = t          # right padding: causal models
            ags[j, :len(a)] = a           # keep it out of earlier positions
            ags[j, len(a):] = a[-1]
        lg = logits_fn(toks, ags)
        out.extend(lg[j, s - 1:s - 1 + k] for j, (_, _, s, k) in
                   enumerate(chunk))
    return out


def teacher_forced_times(prompts: Sequence[Trajectory],
                         trajs: Sequence[Trajectory],
                         uniforms: Sequence[np.ndarray], logits_fn: LogitsFn,
                         *, batch: int = 8) -> List[np.ndarray]:
    """For each request, the reference's waiting times (n+1, V) at steps
    0..n of its n-event trajectory (step n only where a uniform row is
    left), each from the logits on the prompt plus the events before it."""
    n_rows = [min(len(ot) + 1, len(u)) for (ot, _), u in zip(trajs, uniforms)]
    rows = _teacher_forced_logits(prompts, trajs, n_rows, logits_fn,
                                  batch=batch)
    return [sample_waiting_times(
        torch.tensor(r, dtype=torch.float32),
        torch.tensor(u[:len(r)], dtype=torch.float32)).numpy()
        for r, u in zip(rows, uniforms)]


def check_trajectories(prompts: Sequence[Trajectory],
                       trajs: Sequence[Trajectory],
                       uniforms: Sequence[np.ndarray], logits_fn: LogitsFn, *,
                       margin_tol: float, age_rtol: float, max_age: float,
                       death_token: int, max_context: int) -> Dict:
    """Hold every trajectory step by step against the reference model on its
    own prefix (see the module note).  ``margin_tol`` bounds the relative
    gap ``(t_emitted - t_min) / t_min`` of an accepted near-tie and of a
    censoring decision; ``age_rtol`` bounds each age increment's relative
    error against the reference's waiting time.  Raises AssertionError;
    returns the counts of steps held, near-ties and the largest relative
    increment error."""
    times = teacher_forced_times(prompts, trajs, uniforms, logits_fn)
    steps, ties, worst = 0, [], 0.0
    for r, ((pt, pa), (ot, oa), t) in enumerate(zip(prompts, trajs, times)):
        age = np.float32(pa[-1])
        for i, (e, a) in enumerate(zip(ot, oa)):
            ti = t[i]
            j = int(np.argmin(ti))
            gap = float((ti[e] - ti[j]) / max(ti[j], 1e-30))
            if j != e:
                if gap > margin_tol:
                    raise AssertionError(
                        f"request {r} step {i}: emitted {e}, the reference "
                        f"picks {j} by a waiting-time gap {gap:.3g} > "
                        f"{margin_tol}")
                ties.append((r, i, gap))
            # the fp32 sum age + t rounds by up to half an ulp of the age
            err = max(abs(float(a) - float(age) - float(ti[e]))
                      - float(np.spacing(np.float32(a))), 0.0)
            rel = err / max(float(ti[e]), 1e-30)
            if rel > age_rtol:
                raise AssertionError(
                    f"request {r} step {i}: age moved by {float(a) - age:.7g},"
                    f" the reference's waiting time is {float(ti[e]):.7g}")
            worst = max(worst, rel)
            age = np.float32(a)
            steps += 1
        n = len(ot)
        if n and ot[-1] == death_token:
            continue
        if len(pt) + n >= max_context or n >= len(t):
            continue                       # context full / budget spent
        tn = t[n]
        j = int(np.argmin(tn))
        reach = float(age) + float(tn[j])
        if reach <= max_age and (max_age - reach) > margin_tol * float(tn[j]):
            raise AssertionError(
                f"request {r} ended after {n} events at age {float(age):.4f}"
                f", but the reference's next event {j} comes at "
                f"{reach:.4f} <= max_age {max_age}")
    return {"steps": steps, "near_ties": ties, "max_age_rel_err": worst}


def compare_runs(ref: Sequence[Trajectory], test: Sequence[Trajectory], *,
                 age_rtol: float) -> Dict:
    """Two free-running runs under the same uniforms: events equal up to
    each request's first divergence and ages within ``age_rtol`` up to it (a
    loose bound: see the module note).  A run that ends first diverges
    where it ends.  Whether each run's events and ends are right is
    :func:`check_trajectories`' question.  Raises AssertionError; returns
    the events compared and the (request, step) of every divergence."""
    if len(ref) != len(test):
        raise AssertionError(f"{len(ref)} reference vs {len(test)} test "
                             f"trajectories")
    compared, divergences = 0, []
    for r, ((tr, ar), (tt, at)) in enumerate(zip(ref, test)):
        n = min(len(tr), len(tt))
        div: Optional[int] = next((i for i in range(n) if tr[i] != tt[i]),
                                  None)
        if div is None and len(tr) != len(tt):
            div = n
        upto = n if div is None else div
        np.testing.assert_allclose(
            np.asarray(at[:upto], np.float64),
            np.asarray(ar[:upto], np.float64), rtol=age_rtol,
            err_msg=f"ages of request {r}")
        compared += upto
        if div is not None:
            divergences.append((r, div))
    return {"compared": compared, "divergences": divergences}


def gumbel_scores(logits: np.ndarray, u: np.ndarray,
                  inv_temp: float = 1.0) -> np.ndarray:
    """The engine's generic-LM sampling scores ``logits * inv_temp + g``,
    ``g = -log(-log(clip(u, 1e-12, 1 - 1e-12)))``, in fp32."""
    u = np.clip(np.asarray(u, np.float32), np.float32(1e-12),
                np.float32(1.0 - 1e-12))
    g = -np.log(-np.log(u))
    return (np.asarray(logits, np.float32) * np.float32(inv_temp)
            + g).astype(np.float32)


def check_lm_trajectories(prompts: Sequence[Sequence[int]],
                          outs: Sequence[Sequence[int]],
                          uniforms: Sequence[np.ndarray], logits_fn: LogitsFn,
                          *, margin_tol: float, inv_temp: float = 1.0,
                          batch: int = 8) -> Dict:
    """Hold every generated token sequence step by step against the
    reference model on its own prefix: token ``i`` must be the argmax of
    :func:`gumbel_scores` of the reference's logits after the prompt and
    tokens ``< i`` under uniform row ``i``, or score within ``margin_tol``
    (absolute) of it: a near-tie.  ``logits_fn`` gets zero ages.  Raises
    AssertionError; returns the steps held and the near-ties."""
    rows = _teacher_forced_logits(
        [(p, np.zeros(len(p), np.float32)) for p in prompts],
        [(o, np.zeros(len(o), np.float32)) for o in outs],
        [len(o) for o in outs], logits_fn, batch=batch)
    steps, ties = 0, []
    for r, (o, u, lg) in enumerate(zip(outs, uniforms, rows)):
        for i, e in enumerate(o):
            sc = gumbel_scores(lg[i], u[i], inv_temp)
            best = int(np.argmax(sc))
            gap = float(sc[best] - sc[e])
            if best != e:
                if gap > margin_tol:
                    raise AssertionError(
                        f"request {r} step {i}: emitted {e}, the reference "
                        f"picks {best} by a score gap {gap:.3g} > "
                        f"{margin_tol}")
                ties.append((r, i, gap))
            steps += 1
    return {"steps": steps, "near_ties": ties}
