"""The port's ring-cache ``BatchedEngine`` on the CPU against the JAX
package's ``BatchedEngine(cache="ring")``.

Both engines serve the same numpy-seeded prompts with the same injected
uniforms.  Free-running trajectories part at the first argmin that falls
inside the two packages' numeric disagreement (and ages drift apart before:
see ``repro_torch.core.parity``), so each of the port's trajectories is held
step by step against the JAX model on its own prefix, with a margin and age
tolerance of 2e-3 (the waiting-time disagreement measured on these
configurations is < 6e-4), and the two runs must agree event for event up
to each request's first divergence (ages there within 0.25 relative).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import forward as jax_forward
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core.parity import (check_lm_trajectories,
                                     check_trajectories, compare_runs)
from repro_torch.launch import serve as launch
from repro_torch.models import init_params, to_flat_numpy
from repro_torch.serve import (BatchedEngine, Request, RequestCancelledError,
                               RequestTimeoutError)
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(2)

MAX_NEW, W = 12, 64


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
    params = init_params(cfg, seed=3, device="cpu")
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        S = int(rng.integers(2, 20))
        toks = rng.integers(3, cfg.vocab_size, S).astype(np.int32)
        ages = np.sort(rng.uniform(50, 75, S)).astype(np.float32)
        u = rng.random((MAX_NEW, cfg.vocab_size), dtype=np.float32)
        out.append((toks, ages, u))
    return out


def _serve_port(params, cfg, reqs, **kw):
    eng = BatchedEngine(params, cfg, slots=4, max_context=W, device="cpu",
                        **kw)
    rs = [Request(tokens=t, ages=a, max_new=MAX_NEW, uniforms=u)
          for t, a, u in reqs]
    for r in rs:
        eng.submit(r)
    eng.run()
    return eng, rs


def test_port_engine_vs_jax_engine():
    cfg, jcfg, params, jp = _setup()
    reqs = _requests(cfg, 10)
    jeng = JaxEngine(jp, jcfg, slots=4, max_context=W)
    jrs = [JaxRequest(tokens=t, ages=a, max_new=MAX_NEW, uniforms=u)
           for t, a, u in reqs]
    for r in jrs:
        jeng.submit(r)
    jeng.run()
    eng, rs = _serve_port(params, cfg, reqs)
    assert all(r.done and r.error is None for r in rs)
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert jeng.host_syncs == jeng.ticks + jeng.admit_batches
    mine = [(r.out_tokens, r.out_ages) for r in rs]
    assert sum(len(t) for t, _ in mine) >= 10

    jf = jax.jit(lambda t, a: jax_forward(jp, jcfg, {"tokens": t,
                                                    "ages": a})["logits"])
    held = check_trajectories(
        [(t, a) for t, a, _ in reqs], mine, [u for _, _, u in reqs],
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32),
                                   jnp.asarray(a))),
        margin_tol=2e-3, age_rtol=2e-3, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=W)
    assert held["steps"] == sum(len(t) for t, _ in mine)
    free = compare_runs([(r.out_tokens, r.out_ages) for r in jrs], mine,
                        age_rtol=0.25)
    assert free["compared"] >= len(reqs)    # at least every first event


def test_port_engine_runs_are_bit_identical_and_sync_once_per_tick(
        monkeypatch):
    cfg, _, params, _ = _setup()
    reqs = _requests(cfg, 7, seed=1)
    copies = []
    real = engine_mod._to_host
    monkeypatch.setattr(engine_mod, "_to_host",
                        lambda x: copies.append(x.shape) or real(x))

    def no_sync(*a, **k):
        raise AssertionError("a device value was read on the host")
    # a tick reads device values only through the one packed copy
    for name in ("item", "tolist", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    eng1, rs1 = _serve_port(params, cfg, reqs)
    eng2, rs2 = _serve_port(params, cfg, reqs)
    monkeypatch.undo()
    assert [(r.out_tokens, r.out_ages) for r in rs1] == \
        [(r.out_tokens, r.out_ages) for r in rs2]
    for eng in (eng1, eng2):
        assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert len(copies) == eng1.host_syncs + eng2.host_syncs
    assert all(s[0] == 4 for s in copies)       # (4, slots) packed rows
    # bucketed admission: pow2 batch rows, pow2 (>= 8) prompt widths
    for nb, sb in eng1.prefill_shapes:
        assert nb & (nb - 1) == 0 and sb & (sb - 1) == 0 and sb >= 8


def test_generator_sampled_runs_are_reproducible():
    cfg, _, params, _ = _setup()
    outs = []
    for _ in range(2):
        eng = BatchedEngine(params, cfg, slots=3, max_context=W, seed=11,
                            device="cpu")
        rs = [Request(tokens=t, ages=a, max_new=MAX_NEW)
              for t, a, _ in _requests(cfg, 5, seed=2)]
        for r in rs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in rs)
        outs.append([(r.out_tokens, r.out_ages) for r in rs])
    assert outs[0] == outs[1]


def test_cancel_and_request_timeout():
    cfg, _, params, _ = _setup()
    reqs = _requests(cfg, 6, seed=3)
    eng = BatchedEngine(params, cfg, slots=2, max_context=W, device="cpu")
    rs = [Request(tokens=t, ages=a, max_new=MAX_NEW, uniforms=u)
          for t, a, u in reqs]
    for r in rs:
        eng.submit(r)
    eng.step()                               # two admitted, four queued
    assert eng.cancel(rs[5].request_id)      # a queued request
    assert eng.cancel(rs[0].request_id) or rs[0].done   # an in-flight one
    assert not eng.cancel("no-such-request")
    eng.run()
    assert isinstance(rs[5].error, RequestCancelledError)
    assert all(r.done for r in rs)
    assert eng.host_syncs == eng.ticks + eng.admit_batches

    late = BatchedEngine(params, cfg, slots=2, max_context=W, device="cpu",
                         request_timeout=0.0)
    r = Request(tokens=reqs[0][0], ages=reqs[0][1], max_new=MAX_NEW)
    late.submit(r)
    late.run()
    assert isinstance(r.error, RequestTimeoutError)


def _mamba_reduced():
    return get_config("mamba2-780m", reduced=True).replace(dtype="float32")


@pytest.mark.parametrize("kw,error", [
    (dict(prefill_chunk_tokens=32), ValueError),       # on the ring
    (dict(prefix_cache=True), ValueError),             # on the ring
    (dict(cache="paged", max_context=50, block_size=16), ValueError),
    (dict(cache="paged", block_size=16, blocks=4), ValueError),
    (dict(cache="paged", arch="mamba2"), ValueError),
])
def test_engine_refuses_what_is_not_ported(kw, error):
    """What the engine refuses, as the JAX package's engine does: chunked
    prefill or a prefix cache on the ring, a context that is not a block
    multiple, a pool smaller than one slot, and the paged cache on a
    recurrent model."""
    cfg, _, params, _ = _setup()
    kw = dict(kw)
    if kw.pop("arch", None) == "mamba2":
        cfg = _mamba_reduced()
        params = init_params(cfg, seed=0, device="cpu")
    kw.setdefault("max_context", W)
    with pytest.raises(error):
        BatchedEngine(params, cfg, slots=2, device="cpu", **kw)


@pytest.mark.parametrize("change", [
    dict(age_encoding=False, dual_head=False),
    dict(age_encoding=False, dual_head=False, arch_type="moe", n_experts=4,
         top_k=2, moe_d_ff=64)],
    ids=["generic-dense", "moe"])
def test_engine_refuses_hold_fork_and_generic_sampling(change):
    """Hold, fork and ``sample_futures`` are ported (tests/test_torch_prefix
    .py), and so is generic (Gumbel) sampling, for Mamba2, for a generic
    dense LM (RoPE) and for an MoE LM: reduced Delphi with no age encoding
    and no dual head (and, for "moe", 4 experts of width 64, top-2, in
    place of its MLP) serves token-only requests, and its tokens are held
    step by step against the JAX model's Gumbel scores under the same
    uniforms (margin 2e-3).  An MoE config with no experts is refused
    where it is made (``ModelConfig``), before any engine."""
    cfg, jcfg, params, _ = _setup()
    if cfg.replace(**change).arch_type == "moe":
        with pytest.raises(ValueError, match="n_experts"):
            cfg.replace(arch_type="moe")
    cfg = cfg.replace(**change)
    params = init_params(cfg, seed=3, device="cpu")
    jcfg = jcfg.replace(**change)
    jp = jax_params(to_flat_numpy(params))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, cfg.vocab_size, S).astype(np.int32)
               for S in (5, 17, 30)]
    us = [rng.random((MAX_NEW, cfg.vocab_size), dtype=np.float32)
          for _ in prompts]
    eng = BatchedEngine(params, cfg, slots=2, max_context=W, device="cpu")
    rs = [Request(tokens=t, max_new=MAX_NEW, uniforms=u)
          for t, u in zip(prompts, us)]
    for r in rs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.error is None and len(r.out_tokens) == MAX_NEW
               and not r.out_ages for r in rs)
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    jf = jax.jit(lambda t: jax_forward(jp, jcfg, {"tokens": t})["logits"])
    held = check_lm_trajectories(
        prompts, [r.out_tokens for r in rs], us,
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32))),
        margin_tol=2e-3)
    assert held["steps"] == len(prompts) * MAX_NEW


def test_serve_cli_on_cpu(capsys):
    out = launch.main(["--arch", "delphi-2m", "--requests", "3", "--slots",
                       "2", "--max-new", "4", "--device", "cpu"])
    eng = out["engine"]
    assert len(out["done"]) == 3
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert "served 3 requests" in capsys.readouterr().out
    assert launch.parse_args(["--cache", "paged"]).cache == "paged"
    assert launch.parse_args(["--replicas", "2"]).replicas == 2
    for bad in (["--cache", "dense"], ["--replicas", "0"]):
        with pytest.raises(SystemExit):
            launch.parse_args(bad)
