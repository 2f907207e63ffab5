"""The port's privacy audit harness against the JAX package's, and the
canary loop end to end on the CPU.

* Canaries (numpy, copied): ``rare_code_pool``, ``make_canaries``,
  ``inject_canaries`` and ``split_canaries`` equal to JAX's bit for bit.
* ``roc_auc`` and ``bootstrap_auc_ci``: the same numpy code, equal to
  JAX's exactly.
* The probes against the memorizing fake backend of
  ``tests/test_privacy.py`` separate members from held-out twins.
* ``PrivacyAuditReport`` JSON crosses the packages both ways.
* ``run_audit`` through the port's ``LocalBackend`` on an untrained model.
* The CPU twin of ``scripts/cohort_audit_roundtrip.py``: a reduced Delphi
  trained by the port with member canaries planted, served by the port's
  ``InferenceServer`` over its paged engine, audited by the port's CLI
  over HTTP; the report is valid and JAX reads it.
"""
import json

import numpy as np
import pytest
import torch
from hypcompat import given, settings, st

from repro.data.synthetic import SimulatorConfig as JaxSimulatorConfig
from repro.privacy import attacks as jattacks
from repro.privacy import audit as jaudit
from repro.privacy import canary as jcanary
from repro_torch.api.client import EngineBackend, LocalBackend
from repro_torch.api.schemas import (FuturesResult, RiskItem, RiskReport,
                                     TrajectoryResult)
from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.data import (SimulatorConfig, batches, cohort,
                              generate_dataset, hazard_params,
                              pack_trajectories, patient)
from repro_torch.data import vocab as V
from repro_torch.privacy import (PrivacyAuditReport, bootstrap_auc_ci,
                                 extraction_probe, extraction_rate,
                                 inject_canaries, make_canaries,
                                 membership_score, rare_code_pool, roc_auc,
                                 run_audit, split_canaries)
from repro_torch.privacy.audit import main as audit_main
from repro_torch.serve.server import InferenceServer
from repro_torch.train import OptimizerConfig, train_loop

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# canaries and simulator streams, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_cohort_patients_and_hazards_vs_jax(seed):
    from repro.data import synthetic as jsyn
    cfg, jcfg = SimulatorConfig(seed=seed), JaxSimulatorConfig(seed=seed)
    for got, want in zip(hazard_params(cfg), jsyn.hazard_params(jcfg)):
        np.testing.assert_array_equal(got, want)
    got, want = cohort(range(6), cfg), jsyn.cohort(range(6), jcfg)
    for (t, a), (jt, ja) in zip(got, want):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(a, ja)
        assert t.dtype == jt.dtype and a.dtype == ja.dtype
    t, a = patient(4, cfg)
    np.testing.assert_array_equal(t, got[4][0])


@pytest.mark.parametrize("n,seed,secret_len,prefix_events",
                         [(6, 3, 4, 8), (8, 0, 3, 6), (5, 9, 2, 3)])
def test_canaries_vs_jax(n, seed, secret_len, prefix_events):
    cfg, jcfg = SimulatorConfig(seed=1), JaxSimulatorConfig(seed=1)
    np.testing.assert_array_equal(rare_code_pool(cfg),
                                  jcanary.rare_code_pool(jcfg))
    got = make_canaries(n, cfg, seed=seed, secret_len=secret_len,
                        prefix_events=prefix_events)
    want = jcanary.make_canaries(n, jcfg, seed=seed, secret_len=secret_len,
                                 prefix_events=prefix_events)
    assert [c.to_json() for c in got] == [c.to_json() for c in want]
    for c, j in zip(got, want):
        np.testing.assert_array_equal(c.tokens, j.tokens)
        np.testing.assert_array_equal(c.ages, j.ages)
        assert c.tokens.dtype == j.tokens.dtype
        assert c.ages.dtype == j.ages.dtype
        assert c.secret_tokens == j.secret_tokens
    members, nonmembers = split_canaries(got)
    jm, jn = jcanary.split_canaries(want)
    assert [c.index for c in members] == [c.index for c in jm]
    assert [c.index for c in nonmembers] == [c.index for c in jn]
    train = [(np.asarray([3, 20], np.int32),
              np.asarray([0.0, 1.0], np.float32))]
    out = inject_canaries(train, got, repeats=3)
    jout = jcanary.inject_canaries(train, want, repeats=3)
    assert len(out) == len(jout) == 1 + 3 * len(members)
    for (t, a), (jt, ja) in zip(out, jout):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(a, ja)
    out[1][0][0] = -1                       # copies, not views
    assert members[0].tokens[0] != -1


def test_canaries_well_formed():
    cfg = SimulatorConfig(seed=0)
    pool = set(int(V.DISEASE0 + c) for c in rare_code_pool(cfg))
    a, _, _, _ = hazard_params(cfg)
    assert len(pool) == max(8, int(len(a) * 0.05))
    for x in make_canaries(6, cfg, seed=3, secret_len=4, prefix_events=8):
        assert x.member == (x.index % 2 == 0)
        assert len(x.secret_tokens) == 4 and set(x.secret_tokens) <= pool
        assert np.all(np.diff(x.ages) >= 0)
        assert V.DEATH not in list(x.prefix_tokens)[1:]
        assert x.rarity > 0


# ---------------------------------------------------------------------------
# attack statistics, exactly
# ---------------------------------------------------------------------------
SCORES = st.lists(st.floats(-8, 0, width=32, allow_subnormal=False),
                  min_size=0, max_size=7)


@settings(max_examples=30, deadline=None)
@given(pos=SCORES, neg=SCORES, seed=st.integers(0, 50))
def test_auc_and_ci_vs_jax(pos, neg, seed):
    assert roc_auc(pos, neg) == jattacks.roc_auc(pos, neg)
    assert bootstrap_auc_ci(pos, neg, n_boot=40, seed=seed) == \
        jattacks.bootstrap_auc_ci(pos, neg, n_boot=40, seed=seed)


def test_roc_auc_units():
    assert roc_auc([2.0, 3.0], [0.0, 1.0]) == 1.0
    assert roc_auc([0.0, 1.0], [2.0, 3.0]) == 0.0
    assert roc_auc([1.0], [1.0]) == 0.5
    assert roc_auc([], [1.0]) == 0.5
    assert roc_auc([2.0, 0.0], [1.0, 3.0]) == 0.25
    assert bootstrap_auc_ci([], [1.0]) == (0.5, 0.5)


# ---------------------------------------------------------------------------
# probes against a rigged backend (tests/test_privacy.py's)
# ---------------------------------------------------------------------------
class _MemorizingBackend:
    """High next-event probability on a member's secret tokens, which it
    regurgitates under sampling; uniform on everything else."""
    name = "memorizing"

    def __init__(self, members, vocab_size=V.VOCAB_SIZE):
        self.vocab_size = vocab_size
        self._known = {tuple(int(t) for t in c.tokens): c for c in members}

    def _lookup(self, tokens):
        for full, c in self._known.items():
            k = len(tokens)
            if k < len(full) and full[:k] == tuple(tokens):
                return full[k]
        return None

    def risk(self, tokens, ages, *, horizon, top):
        nxt = self._lookup([int(t) for t in tokens])
        if nxt is None:
            p = 1.0 / self.vocab_size
            items = [RiskItem(token=t, risk=p) for t in range(top)]
        else:
            items = [RiskItem(token=nxt, risk=0.9)]
        return RiskReport(horizon=horizon, items=items)

    def sample_futures(self, req):
        nxt = self._lookup(list(req.tokens))
        toks, ages = list(req.tokens), list(req.ages)
        out_t = []
        while nxt is not None and len(out_t) < req.max_new:
            out_t.append(nxt)
            toks.append(nxt)
            nxt = self._lookup(toks)
        traj = TrajectoryResult(
            tokens=out_t or [V.NO_EVENT],
            ages=[float(ages[-1]) + i + 1.0
                  for i in range(len(out_t) or 1)],
            prompt_tokens=[int(t) for t in req.tokens],
            prompt_ages=[float(a) for a in req.ages], backend=self.name)
        return FuturesResult(
            risk=RiskReport(horizon=req.horizon, items=[]),
            trajectories=[traj] * req.n_futures,
            n_futures=req.n_futures, backend=self.name)


def test_probes_separate_members_from_heldout():
    canaries = make_canaries(8, SimulatorConfig(seed=0), seed=2)
    members, nonmembers = split_canaries(canaries)
    b = _MemorizingBackend(members)
    for m in members:
        assert membership_score(b, m) > membership_score(
            b, nonmembers[0]) + 1.0
        assert extraction_probe(b, m, n_futures=2, max_new=8, match=2)
    rate_m, flags = extraction_rate(b, members, n_futures=2, max_new=8)
    rate_n, _ = extraction_rate(b, nonmembers, n_futures=2, max_new=8)
    assert rate_m == 1.0 and all(flags) and rate_n == 0.0
    report = run_audit(b, members, nonmembers, n_futures=2, max_new=8,
                       n_boot=50)
    assert report.mi_auc == 1.0 and report.extraction_gap == 1.0
    # JAX's audit of the same canaries through the same backend agrees
    jc = jcanary.make_canaries(8, JaxSimulatorConfig(seed=0), seed=2)
    jm, jn = jcanary.split_canaries(jc)
    want = jaudit.run_audit(b, jm, jn, n_futures=2, max_new=8, n_boot=50)
    assert report.to_json() == want.to_json()


def test_report_json_crosses_packages():
    r = PrivacyAuditReport(backend="x", n_members=2, n_nonmembers=2,
                           mi_auc=0.75, mi_auc_ci=(0.5, 1.0),
                           member_scores=[-1.0, -2.0],
                           nonmember_scores=[-3.0, -4.0],
                           member_extraction_rate=0.5,
                           nonmember_extraction_rate=0.0,
                           config={"seed": 1})
    wire = json.loads(json.dumps(r.to_json()))
    j = jaudit.PrivacyAuditReport.from_json(wire)
    assert j.to_json() == r.to_json() and j.extraction_gap == 0.5
    back = PrivacyAuditReport.from_json(json.loads(json.dumps(j.to_json())))
    assert back == r


def test_run_audit_local_backend_untrained():
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=1289)
    backend = LocalBackend(init_delphi(cfg, 2, "cpu"), cfg, device="cpu")
    canaries = make_canaries(4, SimulatorConfig(seed=0), seed=0,
                             secret_len=3, prefix_events=4)
    members, nonmembers = split_canaries(canaries)
    report = run_audit(backend, members, nonmembers, n_futures=2,
                       max_new=4, n_boot=25)
    assert report.n_members == 2 and report.n_nonmembers == 2
    assert 0.0 <= report.mi_auc <= 1.0
    assert all(s < 0 for s in report.member_scores + report.nonmember_scores)
    assert 0.0 <= report.member_extraction_rate <= 1.0
    d = report.to_json()
    assert d["backend"] == backend.name and d["config"]["n_boot"] == 25


# ---------------------------------------------------------------------------
# the canary loop over HTTP (the CPU twin of the round-trip script)
# ---------------------------------------------------------------------------
def test_audit_cli_over_http_on_a_model_the_port_trained(tmp_path):
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=1289)
    sim = SimulatorConfig(n_train=96, n_val=4, seed=0)
    train, _ = generate_dataset(sim)
    canaries = make_canaries(4, sim, seed=0, secret_len=3, prefix_events=6)
    train = inject_canaries(train, canaries, repeats=8)
    steps = 40
    params, hist = train_loop(
        init_delphi(cfg, 2, "cpu"), cfg,
        OptimizerConfig(lr=6e-4, total_steps=steps),
        batches(pack_trajectories(train, 32), 16, seed=0), steps=steps,
        log_fn=lambda s: None, device="cpu")
    assert hist["loss"][-1] < hist["loss"][0]
    server = InferenceServer(
        EngineBackend.create(params, cfg, slots=8, max_context=64,
                             cache="paged", prefix_cache=True,
                             device="cpu"), port=0).start()
    out = tmp_path / "audit.json"
    try:
        rc = audit_main(["--url", server.address, "--canaries", "4",
                         "--secret-len", "3", "--prefix-events", "6",
                         "--sim-seed", "0", "--seed", "0",
                         "--n-futures", "2", "--max-new", "4",
                         "--n-boot", "50", "--out", str(out)])
    finally:
        server.stop()
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["backend"] == "remote"
    assert report["n_members"] == 2 and report["n_nonmembers"] == 2
    assert 0.0 <= report["mi_auc"] <= 1.0
    lo, hi = report["mi_auc_ci"]
    assert 0.0 <= lo <= hi <= 1.0
    for k in ("member_extraction_rate", "nonmember_extraction_rate"):
        assert 0.0 <= report[k] <= 1.0
    assert len(report["member_scores"]) == 2
    assert all(s <= 0.0 for s in report["member_scores"])
    assert jaudit.PrivacyAuditReport.from_json(report).to_json() == report
    assert report["config"]["n_boot"] == 50


def test_audit_cli_refuses_artifact():
    with pytest.raises(SystemExit, match="not ported yet"):
        audit_main(["--artifact", "somewhere"])
    with pytest.raises(SystemExit, match="--url"):
        audit_main([])
