"""The generation steps of the port's quickstart and serve-batched examples
against the JAX package, and the export example's ``main``, on the CPU.

With JAX's ``init_delphi(cfg, PRNGKey(0))`` (full-width Delphi-2M, fp32)
carried across by ``from_jax_flat`` and injected uniforms:

* ``torch_quickstart.predict`` against ``repro.core.generate_trajectories``;
* ``torch_serve_batched.serve`` against JAX's ``BatchedEngine`` at the
  example's knobs.

Event sequences across packages are held margin-aware (ROADMAP rule 5,
``repro_torch.core.parity``): each trajectory of the port step by step
against JAX's model on its own prefix (margin and age tolerance 2e-3, as
in ``tests/test_torch_api.py``), and the two free runs event for event up
to their first divergence (ages within 0.25 relative up to it).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.core import generate_trajectories as jax_generate
from repro.core import init_delphi as jax_init_delphi
from repro.models import forward as jax_forward
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.core.parity import check_trajectories, compare_runs
from repro_torch.models import from_jax_flat
from test_torch_examples import jax_flat, load, run_main

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _jax_model(seq_len):
    jcfg = jax_config("delphi-2m").replace(dtype="float32",
                                           max_seq_len=seq_len)
    return jcfg, jax_init_delphi(jcfg, jax.random.PRNGKey(0))


def _jax_logits_fn(jp, jcfg):
    f = jax.jit(lambda t, a: jax_forward(jp, jcfg, {"tokens": t,
                                                   "ages": a})["logits"])
    return lambda t, a: np.asarray(f(jnp.asarray(t, jnp.int32),
                                     jnp.asarray(a)))


def _uniforms(n, V, seed):
    return np.random.default_rng(seed).uniform(size=(n, V)).astype(
        np.float32)


def test_export_twin_main_returns_0_on_the_cpu(capsys, monkeypatch):
    run_main("torch_export_and_serve.py", capsys, monkeypatch)


def test_quickstart_generation_holds_against_jax():
    tq = load("examples/torch_quickstart.py")
    cfg = tq.make_config(96)
    jcfg, jp = _jax_model(96)
    params = from_jax_flat(jax_flat(jp), cfg, device="cpu")
    train, _, _, _ = tq.make_data(64, 96)
    max_new = 24
    prompts, mine, theirs, us = [], [], [], []
    for i in range(3):
        tok, age = train[i]
        half = max(len(tok) // 2, 2)
        pt, pa = tok[:half], age[:half]
        u = _uniforms(max_new, cfg.vocab_size, 10 + i)
        prompts.append((pt.tolist(), pa.tolist()))
        us.append(u)
        mine.append(tq.predict(params, cfg, pt, pa, max_new=max_new,
                               uniforms=u))
        out = jax_generate(jp, jcfg, jnp.asarray(pt[None]),
                           jnp.asarray(pa[None]), jax.random.PRNGKey(7),
                           max_new=max_new, uniforms=jnp.asarray(u[None]))
        n = int(out["n_generated"][0])
        theirs.append((np.asarray(out["tokens"][0, half:half + n]).tolist(),
                       np.asarray(out["ages"][0, half:half + n]).tolist()))
    held = check_trajectories(
        prompts, mine, us, _jax_logits_fn(jp, jcfg), margin_tol=2e-3,
        age_rtol=2e-3, max_age=cfg.max_age, death_token=cfg.death_token,
        max_context=10 ** 9)
    assert held["steps"] == sum(len(t) for t, _ in mine) > 0
    free = compare_runs(theirs, mine, age_rtol=0.25)
    assert free["compared"] >= 3


def test_serve_batched_generation_holds_against_the_jax_engine():
    ts = load("examples/torch_serve_batched.py")
    cfg = ts.make_config()
    jcfg, jp = _jax_model(ts.MAX_CONTEXT)
    params = from_jax_flat(jax_flat(jp), cfg, device="cpu")
    prompts = ts.make_requests(4)
    max_new = 6
    us = [_uniforms(max_new, cfg.vocab_size, 20 + i)
          for i in range(len(prompts))]
    _, reqs = ts.serve(params, cfg, prompts, slots=4, max_new=max_new,
                       device="cpu", uniforms=us)
    mine = [(r.out_tokens, r.out_ages) for r in reqs]
    eng = JaxEngine(jp, jcfg, slots=4, max_context=ts.MAX_CONTEXT)
    jreqs = [JaxRequest(tokens=t, ages=a, max_new=max_new, uniforms=u)
             for (t, a), u in zip(prompts, us)]
    for r in jreqs:
        eng.submit(r)
    eng.run()
    theirs = [(r.out_tokens, r.out_ages) for r in jreqs]
    held = check_trajectories(
        [(t.tolist(), a.tolist()) for t, a in prompts], mine, us,
        _jax_logits_fn(jp, jcfg), margin_tol=2e-3, age_rtol=2e-3,
        max_age=cfg.max_age, death_token=cfg.death_token,
        max_context=ts.MAX_CONTEXT)
    assert held["steps"] == sum(len(t) for t, _ in mine) > 0
    free = compare_runs(theirs, mine, age_rtol=0.25)
    assert free["compared"] >= 4
