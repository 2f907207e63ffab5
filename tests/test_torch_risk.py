"""The port's risk and calibration layers against the JAX package's.

* On the same trajectories the aggregations are equal exactly:
  ``futures_risk_items``, ``futures_chapter_risk``, the chapter map,
  ``pack_futures_trajectories`` and ``monte_carlo_risk`` over given
  trajectories (counts of 0/1 occurrences, the same fp32 cutoff), and
  ``cohort_stats``.
* Analytic risk on the same logits: fp32 logsumexp, softmax and exp in two
  libraries, measured on the CPU over four seeds to agree within 2.4e-7
  absolute on probabilities below 1; the test allows 1e-6.  The fp64 host
  twin is the same numpy code and agrees exactly.  ``next_event_risk``
  through the two models on one set of weights adds the models' logit
  difference (< 8e-4, ``tests/test_torch_model.py``) times a risk below 1;
  measured < 1.4e-6 over four seeds, the test allows 1e-5.
* ``monte_carlo_risk``'s own sampling route (injected uniforms or a seeded
  generator) equals its aggregation of the trajectories that
  ``generate_trajectories`` returns for them, and the JAX package's
  aggregation of those trajectories; ``generate_cohort`` is those
  trajectories cut at ``n_generated``, and ``calibration_report`` the JAX
  package's ``cohort_stats`` of them.
* ``engine_oracle_trajectories`` are the futures the port's engine forks,
  bit for bit, so ``monte_carlo_risk`` over them equals the risk of the
  engine's ``sample_futures``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import calibration as jax_calibration
from repro.core import risk as jax_risk
from repro_torch.configs import get_config
from repro_torch.core import calibration, generate_trajectories, risk
from repro_torch.data import vocab
from repro_torch.models import init_params, to_flat_numpy
from repro_torch.serve import BatchedEngine

torch.set_num_threads(2)

V_FULL = 1289


def jax_params(flat):
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return out


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config("delphi-2m", reduced=True).replace(dtype="float32")
    jcfg = jax_config("delphi-2m", reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=2, device="cpu")
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _futures(seed, n=12, V=V_FULL, age0=50.0):
    """n futures of 0-9 events with increasing fp32 ages, some landing on
    the horizon cutoff exactly."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        k = int(rng.integers(0, 10))
        toks = [int(t) for t in rng.integers(1, V, k)]
        ages = list(np.float32(age0) + np.cumsum(
            rng.uniform(0.1, 2.5, k)).astype(np.float32))
        if k and j % 3 == 0:
            ages[-1] = np.float32(np.float32(age0) + np.float32(5.0))
        out.append((toks, [float(a) for a in ages]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_futures_aggregations_equal_the_jax_packages(seed):
    futs = _futures(seed)
    age0, horizon = 50.0, 5.0
    assert risk.futures_risk_items(futs, age0, horizon, V_FULL, top=20) == \
        jax_risk.futures_risk_items(futs, age0, horizon, V_FULL, top=20)
    np.testing.assert_array_equal(
        risk.futures_chapter_risk(futs, age0, horizon, V_FULL),
        jax_risk.futures_chapter_risk(futs, age0, horizon, V_FULL))
    # futures without ages count every token
    bare = [(t, []) for t, _ in futs]
    assert risk.futures_risk_items(bare, age0, horizon, V_FULL) == \
        jax_risk.futures_risk_items(bare, age0, horizon, V_FULL)


@pytest.mark.parametrize("V", [96, V_FULL, 2000])
def test_disease_chapter_map_equals_the_jax_packages(V):
    np.testing.assert_array_equal(risk.disease_chapter_map_np(V),
                                  jax_risk.disease_chapter_map_np(V))
    assert torch.equal(risk.disease_chapter_map(V, device="cpu"),
                       torch.from_numpy(jax_risk.disease_chapter_map_np(V)))


def test_pack_futures_trajectories_equals_the_jax_packages():
    rng = np.random.default_rng(3)
    toks = rng.integers(3, V_FULL, 7)
    ages = np.sort(rng.uniform(40, 50, 7)).astype(np.float32)
    futs = _futures(4, n=6)
    mine = risk.pack_futures_trajectories(toks, ages, futs, max_new=10,
                                          device="cpu")
    theirs = jax_risk.pack_futures_trajectories(toks, ages, futs, max_new=10)
    assert set(mine) == set(theirs)
    for key in mine:
        np.testing.assert_array_equal(mine[key].numpy(),
                                      np.asarray(theirs[key]))


@pytest.mark.parametrize("seed", [0, 5])
def test_monte_carlo_risk_on_identical_trajectories_is_exact(seed):
    cfg, jcfg, params, jp = _setup()
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, 6)
    ages = np.sort(rng.uniform(40, 50, 6)).astype(np.float32)
    futs = _futures(seed + 10, n=16, V=cfg.vocab_size,
                    age0=float(ages[-1]))
    mine = risk.monte_carlo_risk(
        params, cfg, torch.from_numpy(toks), torch.from_numpy(ages),
        horizon=5.0, chapter_of=risk.disease_chapter_map(cfg.vocab_size,
                                                device="cpu"),
        trajectories=risk.pack_futures_trajectories(toks, ages, futs,
                                                    max_new=10,
                                                    device="cpu"))
    theirs = jax_risk.monte_carlo_risk(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(ages), horizon=5.0,
        chapter_of=jax_risk.disease_chapter_map(cfg.vocab_size),
        trajectories=jax_risk.pack_futures_trajectories(toks, ages, futs,
                                                        max_new=10))
    for key in ("code_risk", "death_risk", "chapter_risk"):
        np.testing.assert_array_equal(mine[key].numpy(),
                                      np.asarray(theirs[key]))
    # the same numbers as the host-side aggregation
    items = dict(risk.futures_risk_items(futs, float(ages[-1]), 5.0,
                                         cfg.vocab_size, top=cfg.vocab_size))
    np.testing.assert_array_equal(
        mine["code_risk"].numpy(),
        np.asarray([items[i] for i in range(cfg.vocab_size)], np.float32))


def test_analytic_risk_vs_jax():
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((4, V_FULL)) * 3 - 6).astype(np.float32)
    for h in (1.0, 5.0, 30.0):
        mine = risk.analytic_next_event_risk(torch.from_numpy(logits), h)
        theirs = jax_risk.analytic_next_event_risk(jnp.asarray(logits), h)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(
            risk.analytic_next_event_risk_np(logits[0], h),
            jax_risk.analytic_next_event_risk_np(logits[0], h))
    r = risk.analytic_next_event_risk(torch.from_numpy(logits), 5.0)
    assert (r >= 0).all() and (r.sum(-1) <= 1 + 1e-5).all()
    r_inf = risk.analytic_next_event_risk(torch.from_numpy(logits), 1e9)
    torch.testing.assert_close(r_inf, torch.softmax(
        torch.from_numpy(logits), -1), atol=1e-5, rtol=0)


def test_next_event_risk_vs_jax():
    cfg, jcfg, params, jp = _setup()
    rng = np.random.default_rng(8)
    toks = rng.integers(3, cfg.vocab_size, (2, 8)).astype(np.int32)
    ages = np.sort(rng.uniform(30, 80, (2, 8)), axis=1).astype(np.float32)
    mine = risk.next_event_risk(params, cfg, torch.from_numpy(toks),
                                torch.from_numpy(ages), horizon=5.0)
    theirs = jax_risk.next_event_risk(jp, jcfg, jnp.asarray(toks),
                                      jnp.asarray(ages), horizon=5.0)
    assert mine.shape == (2, cfg.vocab_size) and torch.isfinite(mine).all()
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5,
                               rtol=0)


def test_monte_carlo_risk_samples_through_the_port():
    """Sampled by the port's ``generate_trajectories``: with injected
    uniforms, and with a seeded generator, the sampled route equals
    ``monte_carlo_risk`` over the trajectories that one
    ``generate_trajectories`` call returns for the same uniforms (or
    seed), exactly, and the JAX package's ``monte_carlo_risk`` over those
    same trajectories.  (The two packages' samplers are held against each
    other margin-aware in ``tests/test_torch_model.py``: their logits differ
    in the last bits, so a near tie may go either way and the sampled risks
    of the two are not compared directly.)"""
    cfg, jcfg, params, jp = _setup()
    rng = np.random.default_rng(9)
    S, N, max_new, horizon = 6, 8, 6, 10.0
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, S))
    ages = torch.from_numpy(np.sort(rng.uniform(40, 50, S))
                            .astype(np.float32))
    u = torch.from_numpy(rng.random((N, max_new, cfg.vocab_size),
                                    dtype=np.float32))
    chap = risk.disease_chapter_map(cfg.vocab_size, device="cpu")
    kw = dict(horizon=horizon, n_samples=N, max_new=max_new,
              chapter_of=chap)

    def sampled(**how):
        return generate_trajectories(params, cfg, toks[None].expand(N, S),
                                     ages[None].expand(N, S),
                                     max_new=max_new, **how)

    with torch.no_grad():
        r = risk.monte_carlo_risk(params, cfg, toks, ages, uniforms=u, **kw)
        trajs = sampled(uniforms=u)
        given = risk.monte_carlo_risk(params, cfg, toks, ages,
                                      trajectories=trajs, **kw)
        r_gen = risk.monte_carlo_risk(params, cfg, toks, ages,
                                      torch.Generator().manual_seed(3), **kw)
        given_gen = risk.monte_carlo_risk(
            params, cfg, toks, ages,
            trajectories=sampled(generator=torch.Generator().manual_seed(3)),
            **kw)
    assert int(trajs["n_generated"].sum()) > 0
    for key in ("code_risk", "death_risk", "chapter_risk"):
        assert torch.equal(r[key], given[key]), key
        assert torch.equal(r_gen[key], given_gen[key]), key
    theirs = jax_risk.monte_carlo_risk(
        jp, jcfg, jnp.asarray(toks.numpy()), jnp.asarray(ages.numpy()),
        horizon=horizon, n_samples=N, max_new=max_new,
        chapter_of=jax_risk.disease_chapter_map(cfg.vocab_size),
        trajectories={k: jnp.asarray(v.numpy()) for k, v in trajs.items()})
    for key in ("code_risk", "death_risk", "chapter_risk"):
        np.testing.assert_array_equal(r[key].numpy(),
                                      np.asarray(theirs[key]))
    assert r["code_risk"].shape == (cfg.vocab_size,)
    assert 0.0 <= float(r["death_risk"]) <= 1.0
    assert r["chapter_risk"].shape == (int(chap.max()) + 1,)
    assert 0.0 <= float(r["chapter_risk"].min()) <= \
        float(r["chapter_risk"].max()) <= 1.0


def test_risk_tensors_default_to_the_card(monkeypatch):
    """``pack_futures_trajectories`` and ``disease_chapter_map`` put their
    tensors on the card unless the caller asks for the CPU, and raise
    without one rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    futs = _futures(6, n=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        risk.pack_futures_trajectories([3, 4], [40.0, 41.0], futs,
                                       max_new=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        risk.disease_chapter_map(V_FULL)
    packed = risk.pack_futures_trajectories([3, 4], [40.0, 41.0], futs,
                                            max_new=10, device="cpu")
    assert all(v.device.type == "cpu" for v in packed.values())


def test_engine_oracle_trajectories_are_the_engines_futures():
    cfg, _, params, _ = _setup()
    rng = np.random.default_rng(10)
    toks = rng.integers(3, cfg.vocab_size, 9).astype(np.int32)
    ages = np.sort(rng.uniform(40, 60, 9)).astype(np.float32)
    n, max_new = 4, 6
    u = rng.random((n, max_new, cfg.vocab_size), dtype=np.float32)
    packed = risk.engine_oracle_trajectories(
        params, cfg, toks, ages, n_samples=n, max_new=max_new, uniforms=u,
        slots=4, max_context=64, device="cpu")
    eng = BatchedEngine(params, cfg, slots=4, max_context=64, cache="paged",
                        device="cpu")
    kids = eng.sample_futures(toks, ages, n=n, max_new=max_new, uniforms=u)
    futs = [(k.out_tokens, k.out_ages) for k in kids]
    via_engine = risk.pack_futures_trajectories(toks, ages, futs,
                                                max_new=max_new,
                                                device="cpu")
    for key in packed:
        assert torch.equal(packed[key], via_engine[key]), key
    a = risk.monte_carlo_risk(params, cfg, torch.from_numpy(toks),
                              torch.from_numpy(ages), horizon=5.0,
                              trajectories=packed)
    b = risk.monte_carlo_risk(params, cfg, torch.from_numpy(toks),
                              torch.from_numpy(ages), horizon=5.0,
                              trajectories=via_engine)
    assert torch.equal(a["code_risk"], b["code_risk"])


def test_cohort_stats_equal_the_jax_packages():
    rng = np.random.default_rng(12)
    trajs = []
    for j in range(20):
        k = int(rng.integers(1, 15))
        tok = rng.integers(1, V_FULL, k).astype(np.int64)
        if j % 4 == 0:
            tok[-1] = 1                                  # Death
        trajs.append((tok, np.sort(rng.uniform(0.5, 90, k))
                      .astype(np.float32)))
    mine = calibration.cohort_stats(trajs)
    theirs = jax_calibration.cohort_stats(trajs)
    assert mine.keys() == theirs.keys()
    for key in mine:
        np.testing.assert_array_equal(np.asarray(mine[key]),
                                      np.asarray(theirs[key]))


def test_calibration_report_runs_on_the_port():
    """``generate_cohort`` is the non-empty trajectories of one
    ``generate_trajectories`` call a seed (a ``torch.Generator`` seeded
    with it), cut at ``n_generated``; ``calibration_report`` is the JAX
    package's ``cohort_stats`` of the held-out data and of that cohort, and
    the L1 distance of their chapter profiles.  (The JAX package draws its
    cohort from ``jax.random`` keys, so the cohorts themselves differ.)"""
    cfg, _, params, _ = _setup()
    cfg = cfg.replace(vocab_size=V_FULL)
    params = init_params(cfg, seed=2, device="cpu")
    B, max_new = 4, 8
    with torch.no_grad():
        held = calibration.generate_cohort(params, cfg, [5], max_new=max_new,
                                           batch=B)
        out = generate_trajectories(
            params, cfg, torch.tensor([[vocab.SEX_FEMALE, vocab.NO_EVENT]],
                                 dtype=torch.int32)
            .expand(B, 2), torch.tensor([[0.0, 40.0]]).expand(B, 2),
            max_new=max_new, generator=torch.Generator().manual_seed(5))
    want = [(out["tokens"][b, 2:2 + n].numpy(), out["ages"][b, 2:2 + n]
             .numpy()) for b, n in enumerate(out["n_generated"].tolist())
            if n]
    assert held and len(held) == len(want)
    for (t, a), (wt, wa) in zip(held, want):
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(a, wa)
    with torch.no_grad():
        rep = calibration.calibration_report(params, cfg, held, n_batches=2,
                                             max_new=max_new, batch=B)
        model = calibration.generate_cohort(params, cfg, range(2),
                                            max_new=max_new, batch=B)
    assert set(rep) == {"data", "model", "chapter_l1"}
    for part, trajs in (("data", held), ("model", model)):
        theirs = jax_calibration.cohort_stats(trajs)
        assert rep[part].keys() == theirs.keys()
        for key in theirs:
            np.testing.assert_array_equal(np.asarray(rep[part][key]),
                                          np.asarray(theirs[key]))
    assert rep["chapter_l1"] == float(np.abs(
        rep["data"]["chapter_freq"] - rep["model"]["chapter_freq"]).sum())
    assert 0.0 <= rep["chapter_l1"] <= 2.0
    assert rep["model"]["chapter_freq"].shape == (26,)
