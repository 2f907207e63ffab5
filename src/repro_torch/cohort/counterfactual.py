"""Counterfactual edit API — "what if" queries over a patient history (a
copy of the JAX package's ``cohort/counterfactual.py`` over the port's
``core.risk``).

An edit inserts, removes, or substitutes ONE diagnosis in a (tokens,
ages) history.  Because every event before the edit point is unchanged,
the edited history shares its entire prefix with the baseline: under the
serving engine's prefix cache the edited arm's prefill is a partial hit
that recomputes only the suffix, so N counterfactuals per patient cost
~1 prefill + N suffixes (fork trees of fork trees).

Both arms are sampled under the SAME injected uniforms (common random
numbers), so the paired difference isolates the edit's effect from
sampling noise; the diff lands in a :class:`CounterfactualReport` with
per-chapter risk deltas computed by the shared fp32-cutoff host
aggregation (``core.risk.futures_chapter_risk``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.schemas import (WIRE_PROTOCOL_VERSION,
                                      FuturesResult)

EDIT_OPS = ("insert", "remove", "substitute")


@dataclasses.dataclass
class CounterfactualEdit:
    """One diagnosis-level edit of a history.

    ``op="insert"``      add ``code`` at ``age`` (kept age-sorted);
    ``op="remove"``      drop the first occurrence of ``code``;
    ``op="substitute"``  replace the first occurrence of ``code`` with
                         ``new_code`` at the same age.
    """
    op: str
    code: int
    age: Optional[float] = None
    new_code: Optional[int] = None

    def validate(self) -> None:
        if self.op not in EDIT_OPS:
            raise ValueError(f"edit op must be one of {EDIT_OPS}; "
                             f"got {self.op!r}")
        if self.op == "insert" and self.age is None:
            raise ValueError("insert edits need an age")
        if self.op == "substitute" and self.new_code is None:
            raise ValueError("substitute edits need a new_code")

    def describe(self) -> str:
        if self.op == "insert":
            return f"insert code {self.code} at age {self.age:g}"
        if self.op == "remove":
            return f"remove code {self.code}"
        return f"substitute code {self.code} -> {self.new_code}"

    def to_json(self) -> dict:
        d: dict = {"op": self.op, "code": int(self.code)}
        if self.age is not None:
            d["age"] = float(self.age)
        if self.new_code is not None:
            d["new_code"] = int(self.new_code)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "CounterfactualEdit":
        return cls(op=str(d["op"]), code=int(d["code"]),
                   age=(float(d["age"]) if d.get("age") is not None
                        else None),
                   new_code=(int(d["new_code"])
                             if d.get("new_code") is not None else None))


def apply_edit(tokens: Sequence[int], ages: Sequence[float],
               edit: CounterfactualEdit
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Edited (tokens, ages) plus the shared-prefix length in events.

    The shared prefix is every event strictly before the edit point —
    exactly the span the engine's ``PrefixIndex`` can partial-hit, so
    ``shared_prefix_len`` is the lower bound on reused prefill work.
    """
    edit.validate()
    toks = [int(t) for t in tokens]
    ags = [float(a) for a in ages]
    if len(toks) != len(ags):
        raise ValueError(f"tokens/ages length mismatch: "
                         f"{len(toks)} vs {len(ags)}")
    if edit.op == "insert":
        pos = len(ags)
        for i, a in enumerate(ags):
            if a > edit.age:
                pos = i
                break
        toks.insert(pos, int(edit.code))
        ags.insert(pos, float(edit.age))
        shared = pos
    else:
        try:
            pos = toks.index(int(edit.code))
        except ValueError:
            raise ValueError(
                f"history has no occurrence of code {edit.code} "
                f"to {edit.op}") from None
        if edit.op == "remove":
            del toks[pos]
            del ags[pos]
        else:
            toks[pos] = int(edit.new_code)
        shared = pos
    if not toks:
        raise ValueError("edit would leave an empty history")
    return (np.asarray(toks, np.int32), np.asarray(ags, np.float32),
            int(shared))


@dataclasses.dataclass
class CounterfactualReport:
    """Paired diff of baseline vs edited futures for ONE patient.

    ``chapter_delta[c] = edited_chapter[c] - baseline_chapter[c]`` —
    the change in P(any code of chapter c occurs within the horizon),
    index 0 the non-disease bucket.  Both arms are cut off at the
    BASELINE patient's last known age + horizon so the comparison window
    is identical even when the edit moves the last event.  ``top_deltas``
    lists the individual codes that moved most (by |delta|).
    """
    edit: CounterfactualEdit
    horizon: float
    shared_prefix_len: int
    baseline: FuturesResult
    edited: FuturesResult
    baseline_chapter: np.ndarray
    edited_chapter: np.ndarray
    top_deltas: List[Tuple[int, float, float, float]]  # token, base, cf, delta

    @property
    def chapter_delta(self) -> np.ndarray:
        return self.edited_chapter - self.baseline_chapter

    def to_json(self) -> dict:
        return {
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "edit": self.edit.to_json(),
            "horizon": float(self.horizon),
            "shared_prefix_len": int(self.shared_prefix_len),
            "baseline_chapter": [float(x) for x in self.baseline_chapter],
            "edited_chapter": [float(x) for x in self.edited_chapter],
            "chapter_delta": [float(x) for x in self.chapter_delta],
            "top_deltas": [
                {"token": int(t), "baseline": float(b), "edited": float(e),
                 "delta": float(d)} for t, b, e, d in self.top_deltas],
            "sharing": self.edited.sharing,
        }


def _code_risk_vector(result: FuturesResult, cutoff: np.float32,
                      vocab_size: int) -> np.ndarray:
    """Full (V,) within-cutoff occurrence frequency over a result's
    futures — the same counting rule as ``core.risk.futures_risk_items``
    but dense, for paired subtraction."""
    n = max(len(result.trajectories), 1)
    counts = np.zeros(vocab_size, np.int64)
    for t in result.trajectories:
        if t.ages:
            seen = {int(tok) for tok, a in zip(t.tokens, t.ages)
                    if np.float32(a) <= cutoff}
        else:
            seen = {int(tok) for tok in t.tokens}
        for tok in seen:
            if 0 <= tok < vocab_size:
                counts[tok] += 1
    return counts / float(n)


def diff_futures(edit: CounterfactualEdit, baseline: FuturesResult,
                 edited: FuturesResult, *, horizon: float, vocab_size: int,
                 shared_prefix_len: int, top: int = 10
                 ) -> CounterfactualReport:
    """Aggregate a paired (baseline, edited) futures draw into a
    :class:`CounterfactualReport` with per-chapter deltas."""
    from repro_torch.core.risk import futures_chapter_risk
    base_traj = baseline.trajectories
    age0 = (float(base_traj[0].prompt_ages[-1])
            if base_traj and base_traj[0].prompt_ages else 0.0)
    cutoff = np.float32(np.float32(age0) + np.float32(horizon))
    futs_b = [(t.tokens, t.ages) for t in baseline.trajectories]
    futs_e = [(t.tokens, t.ages) for t in edited.trajectories]
    chap_b = futures_chapter_risk(futs_b, age0, horizon, vocab_size)
    chap_e = futures_chapter_risk(futs_e, age0, horizon, vocab_size)
    risk_b = _code_risk_vector(baseline, cutoff, vocab_size)
    risk_e = _code_risk_vector(edited, cutoff, vocab_size)
    delta = risk_e - risk_b
    order = np.argsort(-np.abs(delta), kind="stable")[:top]
    top_deltas = [(int(i), float(risk_b[i]), float(risk_e[i]),
                   float(delta[i])) for i in order if delta[i] != 0.0]
    return CounterfactualReport(
        edit=edit, horizon=float(horizon),
        shared_prefix_len=int(shared_prefix_len),
        baseline=baseline, edited=edited,
        baseline_chapter=chap_b, edited_chapter=chap_e,
        top_deltas=top_deltas)
