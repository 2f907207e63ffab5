"""The port's ``repro_torch.api`` on the CPU, against the JAX package's
``repro.api``: the error registry, the schemas' JSON, validation errors of
the same bad inputs, ``LocalBackend`` (stream against generate, futures),
``Client.from_engine`` against JAX's on bridged weights, and a reduced
Mamba2 through ``EngineBackend``.

Event sequences across execution paths or packages are held margin-aware
(ROADMAP rule 5): each trajectory step by step against a reference model on
its own prefix (margin and age tolerance 2e-3, as in
``tests/test_torch_engine.py``), and two free runs event for event up to
their first divergence.  Inside one path of the port they are bit-equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.api import errors as jax_errors
from repro.api import schemas as jax_schemas
from repro.configs import get_config as jax_config
from repro.core import init_delphi
from repro.models import forward as jax_forward
from repro.serve import BatchedEngine as JaxEngine
from repro.train import checkpoint as jax_checkpoint
from repro_torch import api
from repro_torch.api import errors, schemas
from repro_torch.configs import get_config
from repro_torch.core.parity import (check_lm_trajectories,
                                     check_trajectories, compare_runs,
                                     port_logits_fn)
from repro_torch.core.risk import analytic_next_event_risk_np
from repro_torch.models import init_params, load_checkpoint
from repro_torch.serve import BatchedEngine, ring_reference_futures

torch.set_num_threads(2)

W, K = 64, 4
TOKS = [3, 10, 20, 30, 41]
AGES = [0.0, 7.5, 15.0, 22.5, 30.0]


def _cfg():
    return get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)


def _jcfg():
    return jax_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)


@functools.lru_cache(maxsize=None)
def _params():
    return init_params(_cfg(), seed=7, device="cpu")


@functools.lru_cache(maxsize=None)
def _jparams():
    return init_delphi(_jcfg(), jax.random.PRNGKey(7))


def _uniforms(shape, seed=42):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Errors and schemas against the JAX package's
# ---------------------------------------------------------------------------
def test_error_registry_equals_jax():
    mine = {c: (k.__name__, k.http_status)
            for c, k in errors.ApiError.registry.items()}
    theirs = {c: (k.__name__, k.http_status)
              for c, k in jax_errors.ApiError.registry.items()}
    assert mine == theirs
    assert set(errors.__all__) == set(jax_errors.__all__)
    for code in list(theirs) + ["some_new_code"]:
        e, je = (errors.error_from_code(code, "m"),
                 jax_errors.error_from_code(code, "m"))
        assert (type(e).__name__, e.code, e.http_status, e.to_json()) == \
            (type(je).__name__, je.code, je.http_status, je.to_json())
    body = {"error": {"code": "timeout", "message": "late"}}
    assert errors.error_from_json(body).to_json() == \
        jax_errors.error_from_json(body).to_json()
    assert isinstance(errors.error_from_json({}), errors.InternalServerError)


def _schema_objects(mod):
    u2 = _uniforms((3, 96))
    u3 = _uniforms((2, 3, 96), seed=1)
    tr = mod.TrajectoryResult(tokens=[5, 7], ages=[31.5, 40.25],
                              prompt_tokens=TOKS, prompt_ages=AGES,
                              backend="engine", request_id="r-1")
    risk = mod.RiskReport(horizon=5.0, items=[mod.RiskItem(5, 0.25),
                                              mod.RiskItem(7, 0.125)],
                          backend="engine")
    return [
        mod.GenerateRequest(tokens=TOKS, ages=AGES, max_new=3, uniforms=u2,
                            request_id="r-1", max_age=80.0, death_token=1),
        mod.GenerateRequest(tokens=TOKS, seed=4),
        mod.TrajectoryEvent(index=0, token=5, age=31.5),
        mod.TrajectoryEvent(index=1, token=9),
        tr,
        mod.FuturesRequest(tokens=TOKS, ages=AGES, n_futures=2, max_new=3,
                           uniforms=u3, horizon=2.5, top=4, seed=3,
                           request_id="f-1"),
        risk,
        mod.FuturesResult(risk=risk, trajectories=[tr, tr], n_futures=2,
                          backend="engine", sharing={"forks": 1}),
    ]


def test_schemas_json_equals_jax_both_ways():
    assert schemas.WIRE_PROTOCOL_VERSION == jax_schemas.WIRE_PROTOCOL_VERSION
    for mine, theirs in zip(_schema_objects(schemas),
                            _schema_objects(jax_schemas)):
        j = mine.to_json()
        assert j == theirs.to_json()
        back = type(mine).from_json(theirs.to_json())
        assert back.to_json() == j
        assert type(theirs).from_json(j).to_json() == j
    # uniforms cross as base64 raw fp32 bytes, bit for bit
    req = _schema_objects(schemas)[0]
    got = schemas.GenerateRequest.from_json(req.to_json())
    assert got.uniforms.dtype == np.float32
    assert got.uniforms.tobytes() == np.asarray(req.uniforms).tobytes()
    with pytest.raises(errors.RngNotSerializableError):
        schemas.GenerateRequest(tokens=TOKS,
                                rng=np.random.default_rng(0)).to_json()
    with pytest.raises(errors.ProtocolVersionError):
        schemas.GenerateRequest.from_json({"tokens": TOKS,
                                           "protocol_version": "999"})


# ---------------------------------------------------------------------------
# Validation: same class and code as the JAX client
# ---------------------------------------------------------------------------
BAD_GENERATE = [
    dict(tokens=[], ages=[]),
    dict(tokens=list(range(3, 103)), ages=[0.0] * 100),
    dict(tokens=[3, 10]),
    dict(tokens=[3, 10], ages=[0.0]),
    dict(tokens=TOKS, ages=AGES, max_new=6, uniforms=np.full((2, 2), 0.5)),
    dict(tokens=TOKS, ages=AGES, max_age=33.0),
    dict(tokens=TOKS, ages=AGES, death_token=5),
    dict(tokens=TOKS, ages=AGES, seed=7),
    dict(tokens=TOKS, ages=AGES, rng=np.random.default_rng(0)),
]
BAD_FUTURES = [
    dict(tokens=TOKS, ages=AGES, n_futures=0),
    dict(tokens=TOKS, ages=AGES, n_futures=2, max_new=3,
         uniforms=np.full((1, 3, 96), 0.5)),
    dict(tokens=[], ages=[]),
]


@functools.lru_cache(maxsize=None)
def _clients():
    port_eng = api.Client.from_engine(BatchedEngine(
        _params(), _cfg(), slots=K, max_context=W, device="cpu"))
    jax_eng = jax_api.Client.from_engine(JaxEngine(
        _jparams(), _jcfg(), slots=K, max_context=W))
    return port_eng, jax_eng


def _raised(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    e = ei.value
    return type(e).__name__, getattr(e, "code", None)


@pytest.mark.parametrize("i", range(len(BAD_GENERATE)))
def test_generate_validation_equals_jax(i):
    mine, theirs = _clients()
    kw = BAD_GENERATE[i]
    for call in ("generate", "stream"):
        got = _raised(lambda: getattr(mine, call)(**kw))
        want = _raised(lambda: getattr(theirs, call)(**kw))
        assert got == want and got[1] is not None


@pytest.mark.parametrize("i", range(len(BAD_FUTURES)))
def test_futures_validation_equals_jax(i):
    mine, theirs = _clients()
    kw = BAD_FUTURES[i]
    assert _raised(lambda: mine.sample_futures(**kw)) == \
        _raised(lambda: theirs.sample_futures(**kw))


def test_local_backend_validates_like_the_engine():
    local = api.Client.from_params(_params(), _cfg(), device="cpu")
    mine, _ = _clients()
    for kw in BAD_GENERATE[:5]:
        assert _raised(lambda: local.generate(**kw)) == \
            _raised(lambda: mine.generate(**kw))


def test_client_surface():
    assert set(api.Client.backends()) == {"engine", "local", "remote"}
    assert set(api.__all__) == set(jax_api.__all__) - {"ArtifactBackend"}
    with pytest.raises(NotImplementedError, match="SDK runtime"):
        api.Client.from_artifact("nowhere")
    with pytest.raises(TypeError):
        _clients()[0].generate(api.GenerateRequest(tokens=TOKS), max_new=3)


# ---------------------------------------------------------------------------
# LocalBackend
# ---------------------------------------------------------------------------
def _held(params, cfg, prompts, trajs, uniforms):
    return check_trajectories(
        prompts, trajs, uniforms, port_logits_fn(params, cfg),
        margin_tol=2e-3, age_rtol=2e-3, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=cfg.max_seq_len)


def test_local_stream_and_generate_agree():
    """The host loop (batch-1 prefill, ``decode_step``, fp64 host
    sampler) and ``generate_trajectories`` (the device sampler) are two
    paths: each is held to the model on its own prefix, and they agree up
    to their first divergence."""
    params, cfg = _params(), _cfg()
    local = api.Client.from_params(params, cfg, device="cpu")
    prompts, runs_g, runs_s, us = [], [], [], []
    for seed in range(4):
        u = _uniforms((8, cfg.vocab_size), seed=seed)
        g = local.generate(tokens=TOKS, ages=AGES, max_new=8, uniforms=u)
        s = list(local.stream(tokens=TOKS, ages=AGES, max_new=8,
                              uniforms=u))
        assert [e.index for e in s] == list(range(len(s)))
        assert g.backend == "local"
        prompts.append((TOKS, AGES))
        runs_g.append((g.tokens, g.ages))
        runs_s.append(([e.token for e in s], [e.age for e in s]))
        us.append(u)
    for runs in (runs_g, runs_s):
        held = _held(params, cfg, prompts, runs, us)
        assert held["steps"] == sum(len(t) for t, _ in runs) > 0
    free = compare_runs(runs_g, runs_s, age_rtol=0.25)
    assert free["compared"] >= 4


def test_local_futures_equal_generate_rows():
    """``LocalBackend.sample_futures`` batches N rows through one
    ``generate_trajectories``: each row equals a one-row ``generate``
    margin-aware, and the report aggregates the rows."""
    params, cfg = _params(), _cfg()
    local = api.Client.from_params(params, cfg, device="cpu")
    u = _uniforms((3, 6, cfg.vocab_size), seed=5)
    fr = local.sample_futures(tokens=TOKS, ages=AGES, n_futures=3,
                              max_new=6, uniforms=u, horizon=50.0, top=5)
    assert fr.n_futures == 3 and len(fr.trajectories) == 3
    runs = [(t.tokens, t.ages) for t in fr.trajectories]
    held = _held(params, cfg, [(TOKS, AGES)] * 3, runs, list(u))
    assert held["steps"] == sum(len(t) for t, _ in runs) > 0
    # generator futures: the same seed gives the same futures
    a = local.sample_futures(tokens=TOKS, ages=AGES, n_futures=2,
                             max_new=4, seed=11)
    b = local.sample_futures(tokens=TOKS, ages=AGES, n_futures=2,
                             max_new=4, seed=11)
    assert [t.tokens for t in a.trajectories] == \
        [t.tokens for t in b.trajectories]


def test_local_and_engine_risk_equal_the_model():
    params, cfg = _params(), _cfg()
    mine, _ = _clients()
    local = api.Client.from_params(params, cfg, device="cpu")
    lg = port_logits_fn(params, cfg)(np.asarray([TOKS], np.int32),
                                     np.asarray([AGES], np.float32))[0, -1]
    want = analytic_next_event_risk_np(lg, 5.0)
    for client in (mine, local):
        rep = client.risk(TOKS, AGES, horizon=5.0, top=8)
        assert [i.token for i in rep.items] == \
            list(np.argsort(-want)[:8])
        np.testing.assert_allclose([i.risk for i in rep.items],
                                   np.sort(want)[::-1][:8], rtol=1e-5)


# ---------------------------------------------------------------------------
# EngineBackend: the engine's own paths, and against JAX's client
# ---------------------------------------------------------------------------
def test_engine_backend_futures_equal_oracle_with_sharing():
    params, cfg = _params(), _cfg()
    client = api.Client.serving(params, cfg, slots=K, max_context=W,
                                cache="paged", prefix_cache=True,
                                device="cpu")
    u = _uniforms((K, 6, cfg.vocab_size), seed=3)
    ora = ring_reference_futures(params, cfg, TOKS, AGES, n=K, max_new=6,
                                 uniforms=u, slots=K, max_context=W,
                                 device="cpu")
    fr = client.sample_futures(tokens=TOKS, ages=AGES, n_futures=K,
                               max_new=6, uniforms=u)
    assert [(t.tokens, t.ages) for t in fr.trajectories] == \
        [(list(t), [float(x) for x in a]) for t, a in ora]
    assert fr.sharing["cache"] == "paged" and fr.sharing["forks"] == 1
    stream = list(client.stream(tokens=TOKS, ages=AGES, max_new=6,
                                uniforms=u[0]))
    gen = client.generate(tokens=TOKS, ages=AGES, max_new=6, uniforms=u[0])
    assert [(e.token, e.age) for e in stream] == list(zip(gen.tokens,
                                                          gen.ages))


def test_engine_client_against_jax_on_bridged_weights(tmp_path):
    jcfg, cfg = _jcfg(), _cfg()
    jp = init_delphi(jcfg, jax.random.PRNGKey(6))
    jax_checkpoint.save(str(tmp_path), jp, jcfg)
    params = load_checkpoint(str(tmp_path), cfg, "cpu")
    mine = api.Client.from_engine(BatchedEngine(
        params, cfg, slots=K, max_context=W, device="cpu"))
    theirs = jax_api.Client.from_engine(JaxEngine(jp, jcfg, slots=K,
                                                  max_context=W))
    rng = np.random.default_rng(8)
    prompts, us, my_runs, their_runs = [], [], [], []
    for _ in range(4):
        S = int(rng.integers(3, 12))
        toks = rng.integers(3, cfg.vocab_size, S).astype(np.int32).tolist()
        ages = np.sort(rng.uniform(20, 60, S)).astype(np.float32).tolist()
        u = rng.random((8, cfg.vocab_size), dtype=np.float32)
        a = mine.generate(tokens=toks, ages=ages, max_new=8, uniforms=u)
        b = theirs.generate(tokens=toks, ages=ages, max_new=8, uniforms=u)
        assert a.backend == b.backend == "engine"
        prompts.append((toks, ages))
        us.append(u)
        my_runs.append((a.tokens, a.ages))
        their_runs.append((b.tokens, b.ages))
    jf = jax.jit(lambda t, a: jax_forward(jp, jcfg, {"tokens": t,
                                                    "ages": a})["logits"])
    held = check_trajectories(
        prompts, my_runs, us,
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32),
                                   jnp.asarray(a))),
        margin_tol=2e-3, age_rtol=2e-3, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=W)
    assert held["steps"] == sum(len(t) for t, _ in my_runs) > 0
    free = compare_runs(their_runs, my_runs, age_rtol=0.25)
    assert free["compared"] >= 4


def test_mamba2_through_engine_backend():
    """A generic LM (reduced Mamba2) through ``EngineBackend``: tokens
    only, no ages; the engine's Gumbel tokens are held to the model on
    their own prefixes; foreground stream == generate bit for bit."""
    cfg = get_config("mamba2-780m", reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=2, device="cpu")
    client = api.Client.serving(params, cfg, slots=2, max_context=128,
                                device="cpu")
    b = client.backend
    assert (b.has_ages, b.seq_len) == (False, 128)
    rng = np.random.default_rng(0)
    prompts, outs, us = [], [], []
    for S in (5, 40):
        toks = rng.integers(0, cfg.vocab_size, S).astype(np.int32).tolist()
        u = rng.random((6, cfg.vocab_size), dtype=np.float32)
        r = client.generate(tokens=toks, max_new=6, uniforms=u)
        assert r.ages == [] and len(r.tokens) == 6
        evs = list(client.stream(tokens=toks, max_new=6, uniforms=u))
        assert [e.token for e in evs] == r.tokens
        assert all(e.age is None for e in evs)
        prompts.append(toks)
        outs.append(r.tokens)
        us.append(u)
    held = check_lm_trajectories(prompts, outs, us,
                                 port_logits_fn(params, cfg),
                                 margin_tol=1e-4)
    assert held["steps"] == 12
    with pytest.raises(errors.InvalidRequestError):
        client.generate(tokens=[1, 2], max_new=3,
                        uniforms=np.full((3, 5), 0.5, np.float32))
    local = api.Client.from_params(params, cfg, seq_len=128, device="cpu")
    lr = local.generate(tokens=prompts[0], max_new=6, uniforms=us[0])
    assert lr.backend == "local" and len(lr.tokens) == 6
    held = check_lm_trajectories([prompts[0]], [lr.tokens], [us[0]],
                                 port_logits_fn(params, cfg),
                                 margin_tol=1e-4)
    assert held["steps"] == 6
