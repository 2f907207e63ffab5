"""The port's cohort scenario engine against the JAX package's.

* Pure host code equal to JAX's exactly: ``apply_edit`` (results and error
  messages), the edit JSON, ``sweep_uniforms`` (bit for bit),
  ``_merge_sharing``, ``diff_futures`` and the result schemas' JSON, key
  for key and value for value on the same trajectories.
* On the port's paged, prefix-cached ``EngineBackend`` (CPU), a sweep at
  ``max_in_flight`` 1 and 3 is bit-identical to ``assert_sweep_parity``'s
  straight-line oracle (each patient against the oracle with the same
  knobs), and the two sweeps agree with each other; the sweep starts the
  engine's background loop for its workers and stops it after.
* The scheduler with fake backends, as ``tests/test_cohort.py``: retries,
  isolation of exhausted patients, the deadline.
* Counterfactual arms share the baseline's prefix and hit the prefix
  cache once per arm.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro.api import schemas as jschemas
from repro.cohort import counterfactual as jcf
from repro.cohort import engine as jengine
from repro.cohort import schemas as jcs
from repro_torch.api import schemas
from repro_torch.api.client import EngineBackend, LocalBackend
from repro_torch.cohort import (CohortSweepResult, CounterfactualEdit,
                                PatientResult, ScenarioEngine, apply_edit,
                                assert_sweep_parity, diff_futures,
                                sweep_uniforms)
from repro_torch.cohort import schemas as cohort_schemas
from repro_torch.cohort.engine import _merge_sharing
from repro_torch.configs import get_config
from repro_torch.models import init_params

torch.set_num_threads(2)

W, BS, K = 64, 16, 4          # the paged-parity engine geometry


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    return init_params(cfg, seed=7, device="cpu"), cfg


def _patients(n, S=5):
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        toks = np.concatenate([[3], rng.integers(13, 90, S - 1)])
        ages = np.concatenate([[0.0],
                               np.sort(rng.uniform(1.0, 40.0, S - 1))])
        out.append((toks.astype(np.int32), ages.astype(np.float32)))
    return out


def _engine(params, cfg, **kw):
    knobs = dict(slots=K, max_context=W, cache="paged", block_size=BS,
                 blocks=64, prefix_cache=True, device="cpu")
    knobs.update(kw)
    return EngineBackend.create(params, cfg, **knobs)


# ---------------------------------------------------------------------------
# host code against JAX's
# ---------------------------------------------------------------------------
EDITS = [("insert", 77, 15.0, None), ("insert", 77, 99.0, None),
         ("insert", 77, 10.0, None), ("remove", 30, None, None),
         ("remove", 3, None, None), ("substitute", 20, None, 55),
         ("remove", 99, None, None), ("insert", 5, None, None),
         ("substitute", 20, None, None), ("mutate", 20, None, None)]


@pytest.mark.parametrize("op,code,age,new_code", EDITS)
def test_apply_edit_and_json_vs_jax(op, code, age, new_code):
    toks, ages = [3, 20, 30, 40], [0.0, 10.0, 20.0, 30.0]
    mine = CounterfactualEdit(op, code, age=age, new_code=new_code)
    theirs = jcf.CounterfactualEdit(op, code, age=age, new_code=new_code)
    try:
        want = jcf.apply_edit(toks, ages, theirs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            apply_edit(toks, ages, mine)
        assert str(got.value) == str(e)
        return
    t2, a2, shared = apply_edit(toks, ages, mine)
    np.testing.assert_array_equal(t2, want[0])
    np.testing.assert_array_equal(a2, want[1])
    assert t2.dtype == want[0].dtype and a2.dtype == want[1].dtype
    assert shared == want[2]
    assert mine.to_json() == theirs.to_json()
    assert mine.describe() == theirs.describe()
    assert CounterfactualEdit.from_json(
        json.loads(json.dumps(theirs.to_json()))) == mine


def test_apply_edit_empty_history_vs_jax():
    with pytest.raises(ValueError, match="empty history"):
        apply_edit([20], [5.0], CounterfactualEdit("remove", 20))


@pytest.mark.parametrize("seed,index", [(3, 17), (0, 0), (21, 5)])
def test_sweep_uniforms_vs_jax(seed, index):
    got = sweep_uniforms(seed, index, 4, 6, 96)
    want = jengine.sweep_uniforms(seed, index, 4, 6, 96)
    assert got.shape == (4, 6, 96) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, sweep_uniforms(seed, index + 1, 4, 6, 96))


def test_merge_sharing_vs_jax():
    dicts = [{"forks": 2, "prefix_cache": {"hits": 1, "misses": 3}},
             {"forks": 5, "cow_copies": 1, "cache": "paged",
              "prefix_cache": {"hits": 4, "misses": 2}},
             {}, {"forks": 3, "prefix_cache": {"hits": 2, "misses": 9}}]
    got = _merge_sharing(dicts)
    assert got == jengine._merge_sharing(dicts)
    assert got["forks"] == 5 and got["prefix_cache"] == {"hits": 4,
                                                         "misses": 9}


def _futures(mod, seed, n=6, V=1289, age0=50.0, prompt=(3, 40, 300)):
    """A FuturesResult of ``mod`` (either package's schemas) with n futures
    of 0-7 events, some landing on the horizon cutoff exactly."""
    rng = np.random.default_rng(seed)
    trajs = []
    for j in range(n):
        k = int(rng.integers(0, 8))
        toks = [int(t) for t in rng.integers(1, V, k)]
        ages = [float(a) for a in np.float32(age0) + np.cumsum(
            rng.uniform(0.1, 2.5, k)).astype(np.float32)]
        if k and j % 3 == 0:
            ages[-1] = float(np.float32(age0) + np.float32(5.0))
        trajs.append(mod.TrajectoryResult(
            tokens=toks, ages=ages, prompt_tokens=list(prompt),
            prompt_ages=[0.0, 30.0, age0], backend="engine"))
    return mod.FuturesResult(
        risk=mod.RiskReport(horizon=5.0,
                            items=[mod.RiskItem(token=15, risk=0.5)]),
        trajectories=trajs, n_futures=n, backend="engine",
        sharing={"forks": n, "prefix_cache": {"hits": 1, "misses": 1}})


def test_diff_futures_vs_jax():
    for seed in range(4):
        args = dict(horizon=5.0, vocab_size=1289, shared_prefix_len=2,
                    top=10)
        got = diff_futures(CounterfactualEdit("remove", 40),
                           _futures(schemas, seed),
                           _futures(schemas, seed + 10), **args)
        want = jcf.diff_futures(jcf.CounterfactualEdit("remove", 40),
                                _futures(jschemas, seed),
                                _futures(jschemas, seed + 10), **args)
        assert got.to_json() == want.to_json()
        np.testing.assert_array_equal(got.chapter_delta, want.chapter_delta)


def test_schemas_json_vs_jax():
    def rollup(mod, cs):
        results = [cs.PatientResult(index=0, result=_futures(mod, 0),
                                    chapter_risk=np.array([0.5, 0.25]),
                                    retries=1, latency_s=0.125),
                   cs.PatientResult(index=1, error="RuntimeError: x",
                                    retries=2, latency_s=1.5)]
        return cs.CohortSweepResult(
            horizon=5.0, n_patients=2, n_failed=1,
            events_total=results[0].n_events, wall_s=2.0,
            chapter_mean=np.array([0.5, 0.25]),
            chapter_hist=np.array([[0, 1], [1, 0]]),
            hist_edges=np.array([0.0, 0.5, 1.0]),
            sharing={"prefix_cache": {"hits": 3, "partial_hits": 1,
                                      "misses": 4}},
            results=results)
    got = rollup(schemas, cohort_schemas)
    want = rollup(jschemas, jcs)
    assert got.to_json() == want.to_json()
    assert list(got.to_json()) == list(want.to_json())
    assert got.prefix_hit_rate == want.prefix_hit_rate == 0.5
    assert isinstance(got, CohortSweepResult)
    assert isinstance(got.results[0], PatientResult)


# ---------------------------------------------------------------------------
# sweeps on the port's engine
# ---------------------------------------------------------------------------
def test_sweep_bit_identical_to_oracle_at_any_concurrency(setup):
    params, cfg = setup
    pats = _patients(5)
    runs = {}
    for workers in (1, 3):
        be = _engine(params, cfg)
        seen = []
        inner = be.sample_futures

        def sample(req, inner=inner, be=be, seen=seen):
            seen.append(be.engine.running)
            return inner(req)
        be.sample_futures = sample
        se = ScenarioEngine(be, max_in_flight=workers, seed=11)
        res = se.sweep(pats, n_futures=3, max_new=6, horizon=20.0)
        # workers > 1 submit into the background loop, which the sweep
        # starts and stops; one worker drives the engine in the foreground
        assert all(seen) == (workers > 1) and not be.engine.running
        assert res.n_failed == 0 and res.n_patients == 5
        assert res.events_total > 0
        stats = assert_sweep_parity(res, params, cfg, pats, seed=11,
                                    n_futures=3, max_new=6, horizon=20.0,
                                    slots=K, max_context=W, device="cpu")
        assert stats == {"patients_checked": 5,
                         "events_checked": res.events_total}
        runs[workers] = res
    for p1, p3 in zip(runs[1].results, runs[3].results):
        assert [(t.tokens, t.ages) for t in p1.result.trajectories] == \
               [(t.tokens, t.ages) for t in p3.result.trajectories]
        np.testing.assert_array_equal(p1.chapter_risk, p3.chapter_risk)
    np.testing.assert_array_equal(runs[1].chapter_hist, runs[3].chapter_hist)


def test_sweep_parity_catches_a_divergence(setup):
    params, cfg = setup
    pats = _patients(2)
    res = ScenarioEngine(_engine(params, cfg), max_in_flight=1,
                         seed=11).sweep(pats, n_futures=3, max_new=6,
                                        horizon=20.0)
    with pytest.raises(AssertionError, match="diverge"):
        assert_sweep_parity(res, params, cfg, pats, seed=12, n_futures=3,
                            max_new=6, horizon=20.0, slots=K, max_context=W,
                            device="cpu")


def test_sweep_local_backend_and_json(setup):
    params, cfg = setup
    pats = _patients(3)
    se = ScenarioEngine(LocalBackend(params, cfg, device="cpu"),
                        max_in_flight=2, seed=2)
    res = se.sweep(pats, n_futures=2, max_new=5, horizon=20.0, hist_bins=4)
    assert res.n_failed == 0
    assert res.chapter_hist.shape == (res.chapter_mean.shape[0], 4)
    assert res.chapter_hist.sum(axis=1).max() <= res.n_ok
    d = json.loads(json.dumps(res.to_json()))
    assert d["n_patients"] == 3 and len(d["patients"]) == 3
    assert d["events_total"] == res.events_total
    assert 0.0 <= d["prefix_hit_rate"] <= 1.0


# ---------------------------------------------------------------------------
# scheduler: retry, deadline, failure isolation
# ---------------------------------------------------------------------------
class _FlakyBackend:
    """Fails the first ``fail_n`` attempts per patient, then succeeds."""
    name = "flaky"
    vocab_size = 96

    def __init__(self, fail_n=1, hang_index=None):
        self.fail_n = fail_n
        self.hang_index = hang_index
        self.attempts = {}
        self._lk = threading.Lock()

    def sample_futures(self, req):
        idx = int(req.request_id.split("-")[1])
        with self._lk:
            k = self.attempts[idx] = self.attempts.get(idx, 0) + 1
        if idx == self.hang_index or k <= self.fail_n:
            raise RuntimeError(f"flaky failure #{k}")
        traj = schemas.TrajectoryResult(tokens=[15], ages=[1.0],
                                        prompt_tokens=list(req.tokens),
                                        prompt_ages=list(req.ages),
                                        backend=self.name)
        return schemas.FuturesResult(
            risk=schemas.RiskReport(
                horizon=req.horizon,
                items=[schemas.RiskItem(token=15, risk=1.0)]),
            trajectories=[traj] * req.n_futures,
            n_futures=req.n_futures, backend=self.name)


def test_sweep_retries_transient_failures():
    b = _FlakyBackend(fail_n=1)
    se = ScenarioEngine(b, max_in_flight=2, seed=0, retries=2)
    res = se.sweep(_patients(4), n_futures=2, max_new=4)
    assert res.n_failed == 0
    assert all(p.retries == 1 for p in res.results)
    assert all(b.attempts[i] == 2 for i in range(4))


def test_sweep_isolates_exhausted_patients():
    b = _FlakyBackend(fail_n=0, hang_index=1)
    se = ScenarioEngine(b, max_in_flight=2, seed=0, retries=1)
    res = se.sweep(_patients(4), n_futures=2, max_new=4)
    assert res.n_failed == 1 and res.n_ok == 3
    bad = res.results[1]
    assert not bad.ok and "RuntimeError" in bad.error
    assert b.attempts[1] == 2
    assert res.events_total == 3 * 2
    d = res.to_json()
    assert d["patients"][1]["ok"] is False and "error" in d["patients"][1]


def test_sweep_deadline_caps_retries():
    b = _FlakyBackend(fail_n=10**9)
    se = ScenarioEngine(b, max_in_flight=1, seed=0, retries=50,
                        patient_deadline=0.0)
    res = se.sweep(_patients(2), n_futures=2, max_new=4)
    assert res.n_failed == 2
    for p in res.results:
        assert "deadline" in p.error and "0" in p.error
    assert all(n <= 2 for n in b.attempts.values())


# ---------------------------------------------------------------------------
# counterfactuals through the engine
# ---------------------------------------------------------------------------
def test_counterfactual_arms_hit_the_prefix_cache(setup):
    params, cfg = setup
    S = 20
    rng = np.random.default_rng(0)
    toks = np.concatenate([[3], rng.integers(13, 90, S - 1)]).astype(np.int32)
    ages = np.concatenate([[0.0], np.sort(
        rng.uniform(1.0, 40.0, S - 1))]).astype(np.float32)
    be = _engine(params, cfg, block_size=4, blocks=128)
    se = ScenarioEngine(be, seed=3)
    edits = [CounterfactualEdit("insert", 44, age=float(ages[-2])),
             CounterfactualEdit("substitute", int(toks[-1]), new_code=50)]
    before = dict(be.engine.pool_stats()["prefix_cache"])
    reps = se.counterfactual(toks, ages, edits, n_futures=3, max_new=5,
                             horizon=30.0)
    assert len(reps) == 2
    for r in reps:
        assert r.shared_prefix_len >= S - 2
        assert np.all(np.abs(r.chapter_delta) <= 1.0)
        assert len(r.baseline.trajectories) == 3
        d = json.loads(json.dumps(r.to_json()))
        assert d["shared_prefix_len"] == r.shared_prefix_len
        assert len(d["chapter_delta"]) == len(r.baseline_chapter)
    pc = be.engine.pool_stats()["prefix_cache"]
    hits = (pc["hits"] + pc["partial_hits"]
            - before["hits"] - before["partial_hits"])
    assert hits == len(edits)               # once per arm
