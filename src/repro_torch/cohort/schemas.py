"""Result schemas for cohort sweeps — pure data, JSON-serializable (a copy
of the JAX package's ``cohort/schemas.py``; the same JSON keys).

``PatientResult`` is one patient's outcome inside a sweep (the
aggregated :class:`~repro_torch.api.schemas.FuturesResult`, or a structured
failure after the scheduler's retries ran out).  ``CohortSweepResult``
is the population rollup: per-chapter mean risk and risk histograms
(the App's population view), throughput, and the engine's sharing
telemetry.  ``to_json`` emits the summary without per-future
trajectories so a 10k-patient sweep serializes in kilobytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.schemas import (WIRE_PROTOCOL_VERSION,
                                      FuturesResult)


@dataclasses.dataclass
class PatientResult:
    """One patient's slot in a cohort sweep."""
    index: int
    result: Optional[FuturesResult] = None
    chapter_risk: Optional[np.ndarray] = None   # (C,) host aggregation
    error: Optional[str] = None
    retries: int = 0
    latency_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.error is None and self.result is not None

    @property
    def n_events(self) -> int:
        if self.result is None:
            return 0
        return sum(len(t.tokens) for t in self.result.trajectories)

    def to_json(self) -> dict:
        d: dict = {"index": int(self.index), "ok": self.ok,
                   "retries": int(self.retries),
                   "latency_s": float(self.latency_s),
                   "n_events": int(self.n_events)}
        if self.error is not None:
            d["error"] = str(self.error)
        if self.chapter_risk is not None:
            d["chapter_risk"] = [float(x) for x in self.chapter_risk]
        return d


@dataclasses.dataclass
class CohortSweepResult:
    """Population rollup of one cohort sweep.

    ``chapter_mean``  (C,)    mean per-patient within-horizon chapter risk
    ``chapter_hist``  (C, B)  histogram of per-patient chapter risks over
                              ``hist_edges`` (B+1,) — the population risk
                              distribution per disease chapter
    ``sharing``               pool/prefix telemetry snapshotted at sweep
                              end (engine-lifetime cumulative counters;
                              empty for host-loop backends)
    """
    horizon: float
    n_patients: int
    n_failed: int
    events_total: int
    wall_s: float
    chapter_mean: np.ndarray
    chapter_hist: np.ndarray
    hist_edges: np.ndarray
    sharing: Dict = dataclasses.field(default_factory=dict)
    results: List[PatientResult] = dataclasses.field(default_factory=list)

    @property
    def n_ok(self) -> int:
        return self.n_patients - self.n_failed

    @property
    def patients_per_s(self) -> float:
        return self.n_ok / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def events_per_s(self) -> float:
        return self.events_total / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Exact+partial prefix-cache hit rate over the engine lifetime
        (0.0 when the backend exposes no prefix telemetry)."""
        pc = self.sharing.get("prefix_cache") or {}
        hits = pc.get("hits", 0) + pc.get("partial_hits", 0)
        total = hits + pc.get("misses", 0)
        return hits / total if total else 0.0

    def to_json(self) -> dict:
        return {
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "horizon": float(self.horizon),
            "n_patients": int(self.n_patients),
            "n_failed": int(self.n_failed),
            "events_total": int(self.events_total),
            "wall_s": float(self.wall_s),
            "patients_per_s": float(self.patients_per_s),
            "events_per_s": float(self.events_per_s),
            "prefix_hit_rate": float(self.prefix_hit_rate),
            "chapter_mean": [float(x) for x in self.chapter_mean],
            "chapter_hist": [[int(c) for c in row]
                             for row in self.chapter_hist],
            "hist_edges": [float(x) for x in self.hist_edges],
            "sharing": self.sharing,
            "patients": [p.to_json() for p in self.results],
        }
