"""The port's ``ReferenceEngine`` (the seed host-loop engine, the slow
baseline of a serving benchmark) on the CPU, against the JAX package's.

Both engines draw a uniform row per sampled event from their own
generators (threefry and Philox streams differ), so the test hands both
the same rows: ``monkeypatch`` replaces the name ``sample_next_event`` in
each engine's module by a wrapper that samples on the row of the request
being emitted (row ``len(out_tokens)`` of that request's numpy-seeded
uniforms); each engine's ``_emit`` is wrapped only to record which request
that is.  No file of either package changes.

The port's trajectories are then held step by step against the JAX model
on their own prefixes (``core.parity.check_trajectories``, margin and age
tolerance 2e-3, as ``tests/test_torch_engine.py``), and the two free runs
agree event for event up to each request's first divergence (ages within
0.25 relative there): margin-aware, as ROADMAP's North star rule 5 asks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serve import ReferenceEngine as JaxReferenceEngine
from repro.serve import Request as JaxRequest
from repro.serve import engine as jax_engine_mod
from repro_torch.configs import get_config
from repro_torch.core.parity import (check_lm_trajectories,
                                     check_trajectories, compare_runs)
from repro_torch.models import from_jax_flat
from repro_torch.serve import BatchedEngine, ReferenceEngine, Request
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(2)

MAX_NEW, W, SLOTS = 12, 64, 4
MARGIN = 2e-3


def jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _setup(arch="delphi-2m"):
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(5))
    return cfg, jcfg, from_jax_flat(jax_flat(jp), cfg, device="cpu"), jp


def _requests(cfg, n, seed=0, delphi=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        S = int(rng.integers(2, 20))
        toks = rng.integers(3, cfg.vocab_size, S).astype(np.int32)
        ages = (np.sort(rng.uniform(50, 75, S)).astype(np.float32)
                if delphi else None)
        u = rng.random((MAX_NEW, cfg.vocab_size), dtype=np.float32)
        out.append((toks, ages, u))
    return out


def _inject(monkeypatch, engine_cls, module, name, make):
    """Wrap ``engine_cls._emit`` to record the request being emitted, and
    replace ``module.<name>`` by ``make(real, rows)``, where ``rows()``
    is that request's next uniform row."""
    current, uniforms = {}, {}
    real_emit = engine_cls._emit

    def emit(self, slot, logits):
        current["req"] = self.slot_req[slot]
        return real_emit(self, slot, logits)

    def row():
        r = current["req"]
        return uniforms[id(r)][len(r.out_tokens)]
    monkeypatch.setattr(engine_cls, "_emit", emit)
    monkeypatch.setattr(module, name, make(getattr(module, name), row))
    return uniforms


def _run_port(params, cfg, reqs, monkeypatch, **kw):
    def make(real, row):
        return lambda lg, u: real(lg, torch.from_numpy(row())[None])
    name = "sample_next_event" if cfg.age_encoding else "gumbel_sample"
    if cfg.age_encoding:
        uniforms = _inject(monkeypatch, ReferenceEngine, engine_mod, name,
                           make)
    else:
        uniforms = _inject(
            monkeypatch, ReferenceEngine, engine_mod, name,
            lambda real, row: (lambda lg, u, t: real(
                lg, torch.from_numpy(row())[None], t)))
    eng = ReferenceEngine(params, cfg, slots=SLOTS, max_context=W,
                          device="cpu", **kw)
    rs = []
    for t, a, u in reqs:
        r = Request(tokens=t, ages=a, max_new=MAX_NEW)
        uniforms[id(r)] = u
        eng.submit(r)
        rs.append(r)
    eng.run()
    return eng, rs


def _run_jax(jp, jcfg, reqs, monkeypatch):
    uniforms = _inject(
        monkeypatch, JaxReferenceEngine, jax_engine_mod, "sample_next_event",
        lambda real, row: (lambda lg, u: real(lg, jnp.asarray(row()))))
    eng = JaxReferenceEngine(jp, jcfg, slots=SLOTS, max_context=W)
    rs = []
    for t, a, u in reqs:
        r = JaxRequest(tokens=t, ages=a, max_new=MAX_NEW)
        uniforms[id(r)] = u
        eng.submit(r)
        rs.append(r)
    eng.run()
    return eng, rs


def test_reference_engine_vs_jax_reference_engine(monkeypatch):
    """10 requests on 4 slots (refilled past capacity) through both
    reference engines under the same uniform rows: every request done,
    the port's events held against the JAX model step by step and the
    free runs equal up to each first divergence."""
    cfg, jcfg, params, jp = _setup()
    reqs = _requests(cfg, 10)
    _, jrs = _run_jax(jp, jcfg, reqs, monkeypatch)
    eng, rs = _run_port(params, cfg, reqs, monkeypatch)
    assert all(r.done for r in rs) and len(eng.completed) == len(reqs)
    mine = [(r.out_tokens, r.out_ages) for r in rs]
    assert sum(len(t) for t, _ in mine) >= len(reqs)
    jf = jax.jit(lambda t, a: jax_forward(jp, jcfg, {"tokens": t,
                                                    "ages": a})["logits"])
    held = check_trajectories(
        [(t, a) for t, a, _ in reqs], mine, [u for _, _, u in reqs],
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32),
                                   jnp.asarray(a))),
        margin_tol=MARGIN, age_rtol=MARGIN, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=W)
    assert held["steps"] == sum(len(t) for t, _ in mine)
    free = compare_runs([(r.out_tokens, r.out_ages) for r in jrs], mine,
                        age_rtol=0.25)
    assert free["compared"] >= len(reqs)


def test_max_age_crossing_event_is_still_emitted(monkeypatch):
    """The pre-parity-fix rule: the event whose waiting time takes the age
    past ``max_age`` is emitted and ends the request; ``BatchedEngine``
    censors it (emits nothing).  With ``max_age`` 0.001 years past the
    prompt's last age, the first waiting time (``exp(-logit) ln 2`` at
    uniforms of 0.5) crosses it."""
    cfg, _, params, _ = _setup()
    toks = np.asarray([5, 9, 14], np.int32)
    ages = np.asarray([60.0, 61.0, 62.0], np.float32)
    cfg = cfg.replace(max_age=62.001)
    u = np.full((MAX_NEW, cfg.vocab_size), 0.5, np.float32)
    eng, (r,) = _run_port(params, cfg, [(toks, ages, u)], monkeypatch)
    assert r.done and len(r.out_tokens) == 1
    assert r.out_ages[0] > cfg.max_age
    beng = BatchedEngine(params, cfg, slots=1, max_context=W, device="cpu")
    br = Request(tokens=toks, ages=ages, max_new=MAX_NEW, uniforms=u)
    beng.submit(br)
    beng.run()
    assert br.done and br.out_tokens == []


def test_prefill_is_exact_length_batch_one_and_decode_one_call_a_tick(
        monkeypatch):
    """Admission slot by slot: a (1, S) prefill at each prompt's exact
    length into a ring of ``max_context``; each tick one ``decode_step``
    over every slot at per-slot steps."""
    cfg, _, params, _ = _setup()
    reqs = _requests(cfg, 6, seed=2)
    shapes, widths, decodes = [], [], []
    real_fwd, real_dec = engine_mod.forward, engine_mod.decode_step

    def fwd(p, c, batch, **kw):
        shapes.append(tuple(batch["tokens"].shape))
        widths.append(kw.get("cache_width"))
        return real_fwd(p, c, batch, **kw)

    def dec(p, c, cache, batch, step, **kw):
        decodes.append((tuple(batch["tokens"].shape), tuple(step.shape)))
        return real_dec(p, c, cache, batch, step, **kw)
    monkeypatch.setattr(engine_mod, "forward", fwd)
    monkeypatch.setattr(engine_mod, "decode_step", dec)
    eng = ReferenceEngine(params, cfg, slots=SLOTS, max_context=W,
                          device="cpu", seed=1)
    for t, a, _ in reqs:
        eng.submit(Request(tokens=t, ages=a, max_new=MAX_NEW))
    ticks = 0
    while eng.step():
        ticks += 1
    assert shapes == [(1, len(t)) for t, _, _ in reqs]
    assert widths == [W] * len(reqs)
    assert decodes == [((SLOTS, 1), (SLOTS,))] * ticks
    assert len(eng.completed) == len(reqs)


def test_generator_runs_repeat_and_seeds_differ():
    cfg, _, params, _ = _setup()
    reqs = _requests(cfg, 5, seed=3)

    def run(seed):
        eng = ReferenceEngine(params, cfg, slots=SLOTS, max_context=W,
                              device="cpu", seed=seed)
        rs = [Request(tokens=t, ages=a, max_new=MAX_NEW) for t, a, _ in reqs]
        for r in rs:
            eng.submit(r)
        eng.run()
        return [(r.out_tokens, r.out_ages) for r in rs]
    assert run(0) == run(0)
    assert run(0) != run(1)


LM_ARCHS = ["tinyllama-1.1b", "olmoe-1b-7b", "mamba2-780m", "zamba2-1.2b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_lm_requests_complete_and_hold_against_jax(arch,
                                                           monkeypatch):
    """A reduced generic LM (dense, MoE, Mamba2, the hybrid): every
    request gets its ``max_new`` tokens (no Death, no ages); under
    injected rows each token is the argmax of the JAX model's Gumbel
    scores on its own prefix, or within 1e-3 of it."""
    cfg, jcfg, params, jp = _setup(arch)
    reqs = _requests(cfg, 6, seed=4, delphi=False)
    eng, rs = _run_port(params, cfg, reqs, monkeypatch)
    assert [len(r.out_tokens) for r in rs] == [MAX_NEW] * len(reqs)
    assert all(r.done and r.out_ages == [] for r in rs)
    jf = jax.jit(lambda t: jax_forward(jp, jcfg, {"tokens": t})["logits"])
    held = check_lm_trajectories(
        [t for t, _, _ in reqs], [r.out_tokens for r in rs],
        [u for _, _, u in reqs],
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32))),
        margin_tol=1e-3)
    assert held["steps"] == MAX_NEW * len(reqs)


def test_context_end_finishes_a_request():
    """A request whose next write would pass ``max_context`` is done, as
    the reference's ``slot_step + 1 >= max_context`` rule."""
    cfg, _, params, _ = _setup()
    toks = np.arange(3, 3 + 60, dtype=np.int32)
    ages = np.linspace(40, 50, 60).astype(np.float32)
    eng = ReferenceEngine(params, cfg.replace(max_age=1e9), slots=1,
                          max_context=W, device="cpu")
    r = Request(tokens=toks, ages=ages, max_new=100)
    eng.submit(r)
    eng.run()
    assert r.done
    assert (len(r.out_tokens) == W - len(toks)
            or r.out_tokens[-1] == cfg.death_token)


def test_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """Like every entry point of the port: the card by default, and
    without one it raises instead of carrying on on the CPU."""
    cfg, _, params, _ = _setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReferenceEngine(params, cfg, slots=2, max_context=32)
    eng = ReferenceEngine(params, cfg, slots=2, max_context=32, device="cpu")
    assert eng.params["embed/embed"].device.type == "cpu"
