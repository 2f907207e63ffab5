"""The port's engine on its background loop, on the CPU: background ==
foreground bit for bit (ring, paged), the ``on_event``/``on_done`` hooks,
``retain_completed``, ``stop()`` with work in flight, a tick that raises,
background ``sample_futures`` == ``ring_reference_futures``,
``drop_prefix_cache`` refused while running, ``health_stats``' keys against
the JAX engine's, the structured errors of cancelled and expired requests
(in the engine and over HTTP, beside the JAX server), and the lock around
the kernel library's first build.

Every wait has a timeout and every started engine or server stops in the
test's ``finally``.
"""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.api.client import EngineBackend as JaxEngineBackend
from repro.configs import get_config as jax_config
from repro.core import init_delphi
from repro.serve import BatchedEngine as JaxEngine
from repro.serve.server import InferenceServer as JaxServer
from repro_torch.api import errors as port_errors
from repro_torch.api.client import EngineBackend
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.models import init_params
from repro_torch.serve import (BatchedEngine, Request, RequestCancelledError,
                               RequestTimeoutError, ring_reference_futures)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.server import InferenceServer

torch.set_num_threads(2)

W, BS, K = 64, 16, 4
TOKS = np.asarray([3, 10, 20, 30, 41], np.int32)
AGES = np.linspace(0.0, 30.0, 5).astype(np.float32)
WAIT = 60.0


def _cfg():
    return get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    return init_params(cfg, seed=7, device="cpu"), cfg


def _uniforms(shape, seed=42):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _long_uniforms(max_new, cfg, seed=42):
    """Uniforms that never sample Death: the request runs its budget."""
    u = _uniforms((max_new, cfg.vocab_size), seed)
    u[:, cfg.death_token] = 1e-12
    return u


def _prompts(n):
    return [((np.arange(3, 3 + 4 + i) % 90).astype(np.int32),
             np.linspace(0.0, 20.0 + i, 4 + i).astype(np.float32))
            for i in range(n)]


def _engine(params, cfg, cache, **kw):
    extra = dict(cache="paged", block_size=BS) if cache == "paged" else {}
    return BatchedEngine(params, cfg, slots=K, max_context=W, device="cpu",
                         **extra, **kw)


def _wait_done(reqs, timeout=WAIT):
    """Block on each request's ``on_done`` (set before submit)."""
    for r in reqs:
        assert r._evt.wait(timeout), f"{r.request_id} never finished"


def _hooked(req):
    req._evt = threading.Event()
    req.on_done = lambda _r, _e=req._evt: _e.set()
    return req


# ---------------------------------------------------------------------------
# Background == foreground, hooks, retain_completed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_background_equals_foreground(setup, cache):
    params, cfg = setup
    max_new = 8
    fg = _engine(params, cfg, cache)
    bg = _engine(params, cfg, cache).start()
    try:
        for i, (t, a) in enumerate(_prompts(3)):
            u = _uniforms((max_new, cfg.vocab_size), seed=i)
            ref = Request(tokens=t, ages=a, max_new=max_new, uniforms=u)
            fg.submit(ref)
            fg.run()
            got = _hooked(Request(tokens=t, ages=a, max_new=max_new,
                                  uniforms=u))
            bg.submit(got)
            _wait_done([got])
            assert got.error is None and len(ref.out_tokens) > 0
            assert got.out_tokens == ref.out_tokens
            assert got.out_ages == ref.out_ages
    finally:
        bg.stop()
    assert bg.host_syncs == bg.ticks + bg.admit_batches


def test_hooks_follow_the_outputs_and_on_done_fires_once(setup):
    params, cfg = setup
    eng = _engine(params, cfg, "paged").start()
    seen, done = [], []
    try:
        reqs = []
        for i, (t, a) in enumerate(_prompts(3)):
            r = Request(tokens=t, ages=a, max_new=6,
                        uniforms=_uniforms((6, cfg.vocab_size), seed=i))
            r.on_event = (lambda tok, age, _i=i: seen.append((_i, tok, age)))
            r._evt = threading.Event()
            r.on_done = (lambda req, _e=r._evt: (done.append(req),
                                                 _e.set()))
            reqs.append(r)
        for r in reqs:
            eng.submit(r)
        _wait_done(reqs)
    finally:
        eng.stop()
    for i, r in enumerate(reqs):
        assert [(tok, age) for j, tok, age in seen if j == i] == \
            list(zip(r.out_tokens, r.out_ages))
        assert sum(d is r for d in done) == 1
    # background default: finished requests are not kept
    assert eng.completed == []


def test_retain_completed(setup):
    params, cfg = setup
    for retain in (False, True):
        eng = _engine(params, cfg, "ring").start(retain_completed=retain)
        try:
            r = _hooked(Request(tokens=TOKS, ages=AGES, max_new=3))
            eng.submit(r)
            _wait_done([r])
        finally:
            eng.stop()
        assert eng.completed == ([r] if retain else [])


def test_many_submitters_and_cancellers_stress(setup):
    """More submitting threads than cores, a short switch interval: every
    request ends exactly once (done or cancelled), the id registry and the
    pool drain, and the one-sync-a-tick count holds."""
    import sys
    params, cfg = setup
    eng = _engine(params, cfg, "paged").start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ends, reqs = [], []
    lock = threading.Lock()
    try:
        def submitter(k):
            for j in range(6):
                r = Request(tokens=TOKS, ages=AGES, max_new=4,
                            request_id=f"s{k}-{j}")
                r._evt = threading.Event()
                r.on_done = (lambda req, _e=r._evt: (ends.append(req),
                                                     _e.set()))
                with lock:
                    reqs.append(r)
                eng.submit(r)
                if j % 3 == 2:
                    eng.cancel(r.request_id)
        ts = [threading.Thread(target=submitter, args=(k,))
              for k in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT)
        assert not any(t.is_alive() for t in ts)
        _wait_done(reqs)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert len(reqs) == 72 and len(ends) == 72
    assert {id(r) for r in ends} == {id(r) for r in reqs}
    assert all(r.error is None or isinstance(r.error, RequestCancelledError)
               for r in reqs)
    assert not eng._by_id and not eng.pending
    assert eng.allocator.used == 0
    assert eng.host_syncs == eng.ticks + eng.admit_batches


# ---------------------------------------------------------------------------
# stop() and a tick that raises
# ---------------------------------------------------------------------------
def test_stop_fails_inflight_waiters_within_seconds(setup):
    params, cfg = setup
    eng = _engine(params, cfg, "paged")
    orig = eng.step
    eng.step = lambda: (time.sleep(0.02), orig())[1]    # a slow tick
    reqs = [_hooked(Request(tokens=TOKS, ages=AGES, max_new=60,
                            uniforms=_long_uniforms(60, cfg, seed=i)))
            for i in range(2 * K)]
    eng.start()
    for r in reqs:
        eng.submit(r)
    time.sleep(0.2)
    t0 = time.monotonic()
    eng.stop()
    _wait_done(reqs, timeout=5.0)
    assert time.monotonic() - t0 < 5.0
    assert all(isinstance(r.error, RuntimeError)
               and "engine stopped" in str(r.error) for r in reqs)
    assert not eng.running
    assert eng.allocator.used == 0


@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_failing_tick_fails_inflight_then_serves(setup, monkeypatch, cache):
    params, cfg = setup
    boom = RuntimeError("device fault in the tick")
    orig = engine_mod._tick_core
    calls = [0]

    def tick_once_bad(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            raise boom
        return orig(*a, **kw)
    monkeypatch.setattr(engine_mod, "_tick_core", tick_once_bad)
    eng = _engine(params, cfg, cache)
    reqs = [_hooked(Request(tokens=t, ages=a, max_new=6,
                            uniforms=_uniforms((6, cfg.vocab_size), seed=i)))
            for i, (t, a) in enumerate(_prompts(3))]
    for r in reqs:
        eng.submit(r)              # all queued before the first step
    eng.start()
    try:
        _wait_done(reqs)
        assert all(r.error is boom for r in reqs)
        assert eng.running
        assert all(r is None for r in eng.slot_req)
        if cache == "paged":
            assert eng.allocator.free == eng.allocator.capacity
            assert (eng._table == -1).all()
        # the next request gets a fresh engine's result
        u = _uniforms((8, cfg.vocab_size), seed=9)
        after = _hooked(Request(tokens=TOKS, ages=AGES, max_new=8,
                                uniforms=u))
        eng.submit(after)
        _wait_done([after])
    finally:
        eng.stop()
    fresh = _engine(params, cfg, cache)
    ref = Request(tokens=TOKS, ages=AGES, max_new=8, uniforms=u)
    fresh.submit(ref)
    fresh.run()
    assert after.error is None
    assert (after.out_tokens, after.out_ages) == (ref.out_tokens,
                                                  ref.out_ages)


# ---------------------------------------------------------------------------
# Futures, the prefix cache, health_stats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_background_sample_futures_equals_oracle(setup, cache):
    params, cfg = setup
    n, max_new = K, 6
    u = _uniforms((n, max_new, cfg.vocab_size), seed=3)
    ora = [(list(t), list(a)) for t, a in ring_reference_futures(
        params, cfg, TOKS, AGES, n=n, max_new=max_new, uniforms=u,
        slots=K, max_context=W, device="cpu")]
    kw = dict(prefix_cache=True) if cache == "paged" else {}
    eng = _engine(params, cfg, cache, **kw).start()
    try:
        for _ in range(2):          # the second parent admits by reference
            kids = eng.sample_futures(TOKS, AGES, n=n, max_new=max_new,
                                      uniforms=u, wait_timeout=WAIT)
            assert all(k.done and k.error is None for k in kids)
            assert [(k.out_tokens, [np.float32(a) for a in k.out_ages])
                    for k in kids] == ora
    finally:
        eng.stop()
    if cache == "paged":
        assert eng.prefix.hits >= 1


def test_background_sample_futures_times_out(setup):
    params, cfg = setup
    eng = _engine(params, cfg, "ring")
    orig = eng.step
    eng.step = lambda: (time.sleep(0.05), orig())[1]
    eng.start()
    try:
        with pytest.raises(RequestTimeoutError) as ei:
            eng.sample_futures(TOKS, AGES, n=2, max_new=40,
                               uniforms=np.stack([_long_uniforms(40, cfg, s)
                                                  for s in range(2)]),
                               wait_timeout=0.1)
        assert ei.value.code == "timeout"
    finally:
        eng.stop()


def test_drop_prefix_cache_refused_while_running(setup):
    params, cfg = setup
    eng = _engine(params, cfg, "paged", prefix_cache=True).start()
    try:
        with pytest.raises(RuntimeError, match="stop\\(\\) the background"):
            eng.drop_prefix_cache()
    finally:
        eng.stop()
    eng.drop_prefix_cache()


def test_run_refused_while_running_as_jax(setup):
    """``run()`` after ``start()`` raises the JAX engine's error (two
    threads would otherwise tick one engine); after ``stop()`` it runs."""
    params, cfg = setup
    jcfg = jax_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    jeng = JaxEngine(init_delphi(jcfg, jax.random.PRNGKey(7)), jcfg,
                     slots=K, max_context=W)
    messages = []
    for eng in (_engine(params, cfg, "ring"), jeng):
        eng.start()
        try:
            with pytest.raises(RuntimeError) as err:
                eng.run()
            messages.append(str(err.value))
        finally:
            eng.stop()
        assert eng.run() == []
    assert messages[0] == messages[1]
    assert "submit() and wait on the request" in messages[0]


@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_health_stats_keys_equal_jax(setup, cache):
    params, cfg = setup
    jcfg = jax_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    kw = dict(cache="paged", block_size=BS) if cache == "paged" else {}
    jeng = JaxEngine(init_delphi(jcfg, jax.random.PRNGKey(7)), jcfg,
                     slots=K, max_context=W, **kw)
    eng = _engine(params, cfg, cache)
    mine, theirs = eng.health_stats(), jeng.health_stats()
    assert set(mine) == set(theirs)
    assert set(mine["memory"]) == set(theirs["memory"])
    assert mine["running"] is False and mine["slots"] == K


# ---------------------------------------------------------------------------
# The structured errors of cancelled and expired requests
# ---------------------------------------------------------------------------
def test_engine_ends_cancelled_and_expired_with_wire_codes(setup):
    params, cfg = setup
    eng = _engine(params, cfg, "paged")
    r = Request(tokens=TOKS, ages=AGES, max_new=20, request_id="c1")
    eng.submit(r)
    eng.step()
    assert eng.cancel("c1")
    eng.run()
    assert isinstance(r.error, port_errors.RequestCancelledError)
    assert (r.error.code, r.error.http_status) == ("request_cancelled", 409)
    assert str(r.error) == "request cancelled"
    eng = _engine(params, cfg, "paged", request_timeout=0.0)
    r = Request(tokens=TOKS, ages=AGES, max_new=20)
    eng.submit(r)
    eng.run()
    assert isinstance(r.error, port_errors.RequestTimeoutError)
    assert (r.error.code, r.error.http_status) == ("timeout", 504)
    assert str(r.error) == "request exceeded its engine deadline"
    # the serve package keeps exporting the same classes
    assert RequestCancelledError is port_errors.RequestCancelledError
    assert RequestTimeoutError is port_errors.RequestTimeoutError


def _post(url, path, payload, timeout=WAIT):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _cancel_and_expire_over_http(server, cfg, tag):
    """(status, code) of a generate cancelled mid-flight and of one that
    outlives the engine's deadline, against a started ``server`` whose
    engine ticks slowly."""
    u = _long_uniforms(200, cfg)
    body = {"tokens": TOKS.tolist(), "ages": AGES.tolist(), "max_new": 200,
            "uniforms": u.tolist(), "request_id": f"{tag}-cancel"}
    out = {}
    t = threading.Thread(target=lambda: out.update(
        cancel=_post(server.address, "/v1/generate", body)))
    t.start()
    eng = server.backend.engine
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline and not any(
            r is not None for r in eng.slot_req):
        time.sleep(0.01)
    st, res = _post(server.address, "/v1/cancel",
                    {"request_id": f"{tag}-cancel"})
    assert st == 200 and res["cancelled"] is True
    t.join(WAIT)
    assert not t.is_alive()
    eng.request_timeout = 0.2
    st_t, res_t = _post(server.address, "/v1/generate",
                        dict(body, request_id=f"{tag}-expire"))
    return ((out["cancel"][0], out["cancel"][1]["error"]["code"]),
            (st_t, res_t["error"]["code"]))


def _slow(engine):
    orig = engine.step
    engine.step = lambda: (time.sleep(0.01), orig())[1]


def test_http_cancel_and_timeout_codes_equal_jax(setup):
    params, cfg = setup
    backend = EngineBackend.create(params, cfg, slots=K, max_context=256,
                                   cache="paged", device="cpu")
    _slow(backend.engine)
    server = InferenceServer(backend, port=0).start()
    try:
        mine = _cancel_and_expire_over_http(server, cfg, "port")
    finally:
        server.stop()
    jcfg = jax_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    jb = JaxEngineBackend.create(init_delphi(jcfg, jax.random.PRNGKey(7)),
                                 jcfg, slots=K, max_context=256,
                                 cache="paged")
    _slow(jb.engine)
    jserver = JaxServer(jb, port=0).start()
    try:
        theirs = _cancel_and_expire_over_http(jserver, cfg, "jax")
    finally:
        jserver.stop()
    assert mine == theirs == ((409, "request_cancelled"), (504, "timeout"))


# ---------------------------------------------------------------------------
# The kernel library's first build, from two threads at once
# ---------------------------------------------------------------------------
def test_library_first_build_runs_once_across_threads(monkeypatch):
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return "libfake.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace(argtypes=None, restype=None)
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    build.library.cache_clear()
    build._load.cache_clear()
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(
            build.library())) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert len(builds) == 1
        assert len(got) == 4 and all(g is got[0] for g in got)
    finally:
        build.library.cache_clear()
        build._load.cache_clear()
