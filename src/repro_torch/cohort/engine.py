"""Cohort-scale scenario engine: population sweeps + counterfactuals (the
JAX package's ``cohort/engine.py`` over the port's backends).

Drives ``sample_futures`` over thousands of synthetic patients through
any :class:`repro_torch.api.InferenceBackend` with a bounded-concurrency
scheduler: ``max_in_flight`` worker threads pull patient indices from a
locked queue and block on the backend, so an engine-backed sweep keeps
the background loop's slots saturated while a remote sweep overlaps
network round trips.  Per-patient uniforms are derived from
``default_rng([seed, tag, index])``, which makes every sweep result
bit-reproducible regardless of worker interleaving — and bit-identical
to the per-patient foreground ``monte_carlo_risk`` oracle
(:mod:`repro_torch.cohort.oracle`).

Scheduler state is lock-guarded (``guarded-by`` comments name the lock);
the worker loop is the subsystem's hot path and must stay free of
device->host syncs (all aggregation is numpy over host lists).  On an
engine backend the workers only submit into the engine's background loop,
which alone launches on the card.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.schemas import FuturesRequest, FuturesResult
from repro_torch.cohort.counterfactual import (CounterfactualEdit,
                                               CounterfactualReport,
                                               apply_edit, diff_futures)
from repro_torch.cohort.schemas import CohortSweepResult, PatientResult
from repro_torch.core.risk import disease_chapter_map_np, futures_chapter_risk

#: Disambiguates the sweep's uniform streams from ``data.synthetic``'s
#: per-patient simulation streams (both are seeded families under the
#: same user seed; the tag keeps them independent).
_UNIFORMS_TAG = 104729


def sweep_uniforms(seed: int, index: int, n_futures: int, max_new: int,
                   vocab_size: int) -> np.ndarray:
    """The (n_futures, max_new, V) injected uniforms for patient
    ``index`` of a sweep — a pure function of (seed, index), so the
    scenario engine and the straight-line oracle consume identical
    randomness and must agree bit for bit."""
    rng = np.random.default_rng([seed, _UNIFORMS_TAG, index])
    return rng.uniform(
        size=(n_futures, max_new, vocab_size)).astype(np.float32)


def _merge_sharing(dicts: Sequence[Dict]) -> Dict:
    """Roll engine-lifetime cumulative sharing counters up across
    results: numeric values take the max (cumulative counters only
    grow), nested dicts merge recursively, other values take the last."""
    out: Dict = {}
    for d in dicts:
        if not d:
            continue
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = _merge_sharing([out.get(k) or {}, v])
            elif isinstance(v, (int, float)) and \
                    isinstance(out.get(k), (int, float)):
                out[k] = max(out[k], v)
            else:
                out[k] = v
    return out


class ScenarioEngine:
    """Bounded-concurrency cohort scheduler over one inference backend.

    ``max_in_flight`` caps concurrent in-flight patients.  Each patient
    gets ``retries`` re-submissions on failure inside a
    ``patient_deadline`` wall-clock budget; a patient that exhausts both
    lands in the sweep result as a structured failure instead of
    aborting the cohort.  When the backend wraps a ``BatchedEngine``
    whose background loop is not running, the sweep starts it for the
    duration (concurrent submission into a foreground engine is not
    thread-safe) and stops it after.
    """

    def __init__(self, backend: "InferenceBackend", *,  # noqa: F821
                 max_in_flight: int = 4, seed: int = 0,
                 patient_deadline: float = 300.0, retries: int = 1):
        self.backend = backend
        self.max_in_flight = int(max_in_flight)
        self.seed = int(seed)
        self.patient_deadline = float(patient_deadline)
        self.retries = int(retries)
        self._lock = threading.Lock()
        self._sweep_queue: List[int] = []      # guarded-by: _lock
        self._sweep_inputs: List[Tuple] = []   # guarded-by: _lock
        self._sweep_params: Dict = {}          # guarded-by: _lock
        self._sweep_results: Dict[int, PatientResult] = {}  # guarded-by: _lock

    # -- engine lifecycle ----------------------------------------------------
    def _maybe_start_engine(self) -> bool:
        """Start the wrapped engine's background loop when concurrent
        workers will submit; returns True when this sweep owns the stop."""
        eng = getattr(self.backend, "engine", None)
        if eng is None or not hasattr(eng, "start"):
            return False
        if getattr(eng, "running", False):
            return False
        if self.max_in_flight <= 1:
            return False          # a single worker may drive foreground
        eng.start()
        return True

    def _stop_engine(self) -> None:
        eng = getattr(self.backend, "engine", None)
        if eng is not None and hasattr(eng, "stop"):
            eng.stop()

    def _sharing_snapshot(self) -> Dict:
        eng = getattr(self.backend, "engine", None)
        if eng is None or not hasattr(eng, "pool_stats"):
            return {}
        st = eng.pool_stats()
        return {k: st[k] for k in
                ("cache", "forks", "preemptions", "shared_blocks",
                 "shared_blocks_peak", "cow_copies", "suffix_tokens_saved",
                 "prefix_cache") if k in st}

    # -- the sweep -----------------------------------------------------------
    def sweep(self, patients: Sequence[Tuple], *, n_futures: int = 4,
              max_new: int = 32, horizon: float = 5.0, top: int = 10,
              hist_bins: int = 10) -> CohortSweepResult:
        """Run ``sample_futures`` over every (tokens, ages) history and
        aggregate into a :class:`CohortSweepResult`."""
        patients = list(patients)
        n = len(patients)
        params = {"n_futures": int(n_futures), "max_new": int(max_new),
                  "horizon": float(horizon), "top": int(top)}
        with self._lock:
            self._sweep_queue = list(range(n))[::-1]    # pop() -> ascending
            self._sweep_inputs = patients
            self._sweep_params = params
            self._sweep_results = {}
        owns_engine = self._maybe_start_engine()
        t0 = time.perf_counter()
        try:
            workers = [threading.Thread(target=self._worker, daemon=True,
                                        name=f"cohort-worker-{w}")
                       for w in range(max(1, min(self.max_in_flight, n)))]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
        finally:
            if owns_engine:
                self._stop_engine()
        wall = time.perf_counter() - t0
        with self._lock:
            results = [self._sweep_results[i] for i in range(n)]
        return self._aggregate(results, wall, horizon=horizon,
                               hist_bins=hist_bins)

    def _worker(self) -> None:
        """The sweep loop: pull the next patient index under the lock,
        run it against the backend outside the lock, publish the result.
        Host-only orchestration — no device values cross this frame."""
        while True:
            with self._lock:
                if not self._sweep_queue:
                    return
                i = self._sweep_queue.pop()
                tokens, ages = self._sweep_inputs[i]
                params = dict(self._sweep_params)
            res = self._run_patient(i, tokens, ages, params)
            with self._lock:
                self._sweep_results[i] = res

    def _run_patient(self, index: int, tokens, ages,
                     params: Dict) -> PatientResult:
        """One patient through the backend with deadline + retry."""
        t0 = time.perf_counter()
        deadline = t0 + self.patient_deadline
        uniforms = sweep_uniforms(self.seed, index, params["n_futures"],
                                  params["max_new"],
                                  self.backend.vocab_size)
        last_err: Optional[str] = None
        attempt = 0
        for attempt in range(self.retries + 1):
            if attempt and time.perf_counter() > deadline:
                last_err = (f"deadline: {self.patient_deadline:g}s budget "
                            f"exhausted after {attempt} attempt(s); "
                            f"last error: {last_err}")
                break
            try:
                req = FuturesRequest(
                    tokens=tokens, ages=ages,
                    n_futures=params["n_futures"],
                    max_new=params["max_new"],
                    horizon=params["horizon"], top=params["top"],
                    uniforms=uniforms,
                    request_id=f"cohort-{index}-a{attempt}")
                out = self.backend.sample_futures(req)
                chap = self._patient_chapter_risk(out, params["horizon"])
                return PatientResult(
                    index=index, result=out, chapter_risk=chap,
                    retries=attempt,
                    latency_s=time.perf_counter() - t0)
            except Exception as e:        # noqa: BLE001 — per-patient
                last_err = f"{type(e).__name__}: {e}"   # isolation is the
        return PatientResult(                           # scheduler contract
            index=index, error=last_err, retries=attempt,
            latency_s=time.perf_counter() - t0)

    def _patient_chapter_risk(self, out: FuturesResult,
                              horizon: float) -> np.ndarray:
        """(C,) within-horizon chapter risk for one patient's futures —
        the shared fp32-cutoff host aggregation."""
        traj = out.trajectories
        age0 = (float(traj[0].prompt_ages[-1])
                if traj and traj[0].prompt_ages else 0.0)
        futs = [(t.tokens, t.ages) for t in traj]
        return futures_chapter_risk(futs, age0, horizon,
                                    self.backend.vocab_size)

    def _aggregate(self, results: List[PatientResult], wall: float, *,
                   horizon: float, hist_bins: int) -> CohortSweepResult:
        ok = [p for p in results if p.ok]
        C = int(disease_chapter_map_np(self.backend.vocab_size).max()) + 1
        edges = np.linspace(0.0, 1.0, hist_bins + 1)
        if ok:
            chap = np.stack([p.chapter_risk for p in ok])      # (n_ok, C)
            chapter_mean = chap.mean(axis=0)
            chapter_hist = np.stack(
                [np.histogram(chap[:, c], bins=edges)[0] for c in range(C)])
        else:
            chapter_mean = np.zeros(C)
            chapter_hist = np.zeros((C, hist_bins), np.int64)
        sharing = _merge_sharing(
            [p.result.sharing for p in ok] + [self._sharing_snapshot()])
        return CohortSweepResult(
            horizon=float(horizon), n_patients=len(results),
            n_failed=len(results) - len(ok),
            events_total=sum(p.n_events for p in ok),
            wall_s=wall, chapter_mean=chapter_mean,
            chapter_hist=chapter_hist, hist_edges=edges,
            sharing=sharing, results=results)

    # -- counterfactuals -----------------------------------------------------
    def counterfactual(self, tokens, ages,
                       edits: Sequence[CounterfactualEdit], *,
                       n_futures: int = 8, max_new: int = 32,
                       horizon: float = 5.0, top: int = 10,
                       ) -> List[CounterfactualReport]:
        """Paired baseline-vs-edited futures for each edit of ONE history.

        The baseline runs first so its prefill seeds the engine's prefix
        cache; every edited arm then shares all blocks before its edit
        point (a `PrefixIndex` partial hit — only the suffix prefills).
        All arms consume the SAME injected uniforms (common random
        numbers), so each report's deltas isolate the edit's effect.
        """
        uniforms = sweep_uniforms(self.seed, 0, n_futures, max_new,
                                  self.backend.vocab_size)
        base_req = FuturesRequest(tokens=tokens, ages=ages,
                                  n_futures=n_futures, max_new=max_new,
                                  horizon=horizon, top=top,
                                  uniforms=uniforms)
        baseline = self.backend.sample_futures(base_req)
        reports = []
        for edit in edits:
            t2, a2, shared = apply_edit(tokens, ages, edit)
            edited = self.backend.sample_futures(FuturesRequest(
                tokens=t2, ages=a2, n_futures=n_futures, max_new=max_new,
                horizon=horizon, top=top, uniforms=uniforms))
            reports.append(diff_futures(
                edit, baseline, edited, horizon=horizon,
                vocab_size=self.backend.vocab_size,
                shared_prefix_len=shared, top=top))
        return reports
