"""The port's HTTP/SSE server and ``RemoteBackend`` on the CPU: twins of
``tests/test_http.py``, plus the wire both ways against the JAX package.

* A fresh server's ``Client.connect(url).generate`` under injected uniforms
  equals ``Client.from_engine`` on a twin engine with the same knobs bit
  for bit (tokens and ages), one request at a time, on the ring and the
  paged cache; ``/v1/stream`` equals ``/v1/generate``; ``/v1/futures``
  equals ``ring_reference_futures``.
* Every validation failure is a structured JSON error with the same HTTP
  status and code as the JAX server gives for the same payload.
* JAX's ``RemoteBackend`` drives the port's server and the port's drives
  JAX's; manifests and health reports have the same keys.
* The CLI refuses ``--artifact`` and boots, answers and stops on SIGINT.

Every socket read and wait has a timeout; every server stops in teardown.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.api.client import EngineBackend as JaxEngineBackend
from repro.configs import get_config as jax_config
from repro.core import init_delphi
from repro.serve.server import InferenceServer as JaxServer
from repro_torch.api import (ApiError, Client, FuturesRequest,
                             GenerateRequest, RemoteBackend,
                             RequestCancelledError, TrajectoryResult,
                             WIRE_PROTOCOL_VERSION)
from repro_torch.api.client import EngineBackend
from repro_torch.api.errors import InvalidRequestError
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve import ring_reference_futures
from repro_torch.serve import server as server_mod
from repro_torch.serve.server import InferenceServer

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOKS = [3, 10, 20]
AGES = [0.0, 15.0, 28.0]
WAIT = 60


def _cfg():
    return get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    params = init_params(cfg, seed=7, device="cpu")
    backend = EngineBackend.create(params, cfg, slots=4, max_context=64,
                                   device="cpu")
    server = InferenceServer(backend, port=0).start()
    yield params, cfg, server
    server.stop()


@pytest.fixture(scope="module")
def jax_server():
    jcfg = jax_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    backend = JaxEngineBackend.create(init_delphi(jcfg, jax.random.PRNGKey(7)),
                                      jcfg, slots=4, max_context=64)
    server = JaxServer(backend, port=0).start()
    yield server
    server.stop()


def _engine_backend(params, cfg, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_context", 64)
    return EngineBackend.create(params, cfg, device="cpu", **kw)


def _uniforms(max_new, V, seed=42):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(max_new, V)).astype(np.float32)


def _long_running_uniforms(max_new, cfg, seed=42):
    """Uniforms that never sample Death: a long request runs its budget."""
    u = _uniforms(max_new, cfg.vocab_size, seed)
    u[:, cfg.death_token] = 1e-12
    return u


def _post_raw(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=WAIT) as r:
        return json.loads(r.read())


def _prompts(n):
    return [(list(range(3, 6 + i)), np.linspace(0.0, 20.0 + i, 3 + i)
             .astype(np.float32).tolist()) for i in range(n)]


# ---------------------------------------------------------------------------
# Discovery endpoints
# ---------------------------------------------------------------------------
def test_manifest_and_healthz(setup):
    _, cfg, server = setup
    m = _get(server.address, "/v1/manifest")
    assert m["protocol_version"] == WIRE_PROTOCOL_VERSION
    assert m["backend"] == "engine"
    assert m["model"]["vocab_size"] == cfg.vocab_size
    assert m["model"]["has_ages"] is True
    assert set(m["endpoints"]) == {"generate", "generate_batch", "risk",
                                   "futures", "stream", "cancel",
                                   "manifest", "healthz"}
    h = _get(server.address, "/v1/healthz")
    assert h["ok"] and h["engine"]["running"]


def test_manifest_and_healthz_keys_equal_jax(setup, jax_server):
    _, _, server = setup
    for path in ("/v1/manifest", "/v1/healthz"):
        mine, theirs = _get(server.address, path), _get(jax_server.address,
                                                         path)
        assert set(mine) == set(theirs)
        for k, v in theirs.items():
            if isinstance(v, dict):
                assert set(mine[k]) == set(v), (path, k)
    assert _get(server.address, "/v1/manifest")["endpoints"] == \
        _get(jax_server.address, "/v1/manifest")["endpoints"]


def test_background_engine_does_not_retain_completed(setup):
    _, _, server = setup
    remote = Client.connect(server.address)
    for _ in range(3):
        remote.generate(tokens=TOKS, ages=AGES, max_new=2)
    assert server.backend.engine.completed == []


# ---------------------------------------------------------------------------
# Remote == an in-process twin, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_remote_bit_identical_to_twin_engine(setup, cache):
    """One request at a time on a fresh server and a fresh twin engine with
    the same knobs: the same admission groups, so the same GEMM shapes and
    the same prefix-cache state, hence the same bits."""
    params, cfg, _ = setup
    kw = dict(cache="paged", prefix_cache=True) if cache == "paged" else {}
    server = InferenceServer(_engine_backend(params, cfg, **kw),
                             port=0).start()
    try:
        remote = Client.connect(server.address)
        twin = Client.from_engine(_engine_backend(params, cfg, **kw).engine)
        for i, (t, a) in enumerate(_prompts(4)):
            u = _uniforms(6, cfg.vocab_size, seed=i)
            r = remote.generate(tokens=t, ages=a, max_new=6, uniforms=u)
            w = twin.generate(tokens=t, ages=a, max_new=6, uniforms=u)
            assert len(r.tokens) > 0
            assert (r.tokens, r.ages) == (w.tokens, w.ages)
            assert r.prompt_tokens == t and r.prompt_ages == a
            assert r.backend == "remote[engine]"
            evs = list(remote.stream(tokens=t, ages=a, max_new=6,
                                     uniforms=u))
            assert [(e.token, e.age) for e in evs] == list(zip(r.tokens,
                                                               r.ages))
            assert [e.index for e in evs] == list(range(len(evs)))
    finally:
        server.stop()


def test_remote_futures_equal_oracle(setup):
    params, cfg, _ = setup
    server = InferenceServer(_engine_backend(params, cfg, cache="paged",
                                             prefix_cache=True),
                             port=0).start()
    try:
        remote = Client.connect(server.address)
        u = np.stack([_uniforms(6, cfg.vocab_size, seed=100 + i)
                      for i in range(4)])
        ora = ring_reference_futures(params, cfg, TOKS, AGES, n=4,
                                     max_new=6, uniforms=u, slots=4,
                                     max_context=64, device="cpu")
        for _ in range(2):
            fr = remote.sample_futures(tokens=TOKS, ages=AGES, n_futures=4,
                                       max_new=6, uniforms=u, top=5)
            assert [(t.tokens, t.ages) for t in fr.trajectories] == \
                [(list(t), [float(x) for x in a]) for t, a in ora]
            assert fr.backend == "remote[engine]"
        assert fr.sharing["prefix_cache"]["hits"] >= 1
    finally:
        server.stop()


def test_remote_generate_batch_order_and_concurrency(setup):
    _, cfg, server = setup
    remote = Client.connect(server.address)
    reqs = [GenerateRequest(tokens=np.arange(3, 6 + i).tolist(),
                            ages=np.linspace(0, 20 + i, 3 + i).tolist(),
                            max_new=4)
            for i in range(6)]
    outs = remote.generate_batch(reqs)
    assert len(outs) == 6
    for req, out in zip(reqs, outs):
        assert isinstance(out, TrajectoryResult)
        assert out.prompt_tokens == list(req.tokens)
        assert len(out.tokens) == len(out.ages) <= 4
    results, errors = {}, []

    def worker(i):
        try:
            results[i] = Client.connect(server.address).generate(
                tokens=[3, 10 + i, 20 + i], ages=AGES, max_new=3)
        except Exception as e:              # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(results) == 8
    for i, r in results.items():
        assert r.prompt_tokens == [3, 10 + i, 20 + i]


def test_remote_risk_matches_engine(setup):
    _, _, server = setup
    remote = Client.connect(server.address)
    rl = server.backend.risk(TOKS, AGES, horizon=5.0, top=8)
    rr = remote.risk(TOKS, AGES, horizon=5.0, top=8)
    assert [(i.token, i.risk) for i in rr.items] == \
        [(i.token, i.risk) for i in rl.items]
    assert rr.backend == "remote[engine]"


# ---------------------------------------------------------------------------
# Error codes, the same as the JAX server's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload,code", [
    ({"tokens": [], "ages": []}, "empty_trajectory"),
    ({"tokens": list(range(100)), "ages": [0.0] * 100}, "too_long"),
    ({"tokens": [3, 10]}, "ages_required"),
    ({"tokens": [3, 10], "ages": [0.0]}, "ages_length_mismatch"),
])
def test_http_error_codes(setup, jax_server, payload, code):
    _, _, server = setup
    status, body = _post_raw(server.address, "/v1/generate", payload)
    assert status == 400
    assert body["error"]["code"] == code
    assert (status, code) == (lambda s, b: (s, b["error"]["code"]))(
        *_post_raw(jax_server.address, "/v1/generate", payload))
    remote = RemoteBackend(server.address)
    with pytest.raises(ApiError) as ei:
        remote.generate(GenerateRequest.from_json(dict(payload)))
    assert ei.value.code == code


@pytest.mark.parametrize("path,payload", [
    ("/v1/generate", {"tokens": TOKS, "ages": AGES, "max_age": 33.0}),
    ("/v1/generate", {"tokens": TOKS, "ages": AGES, "seed": 7}),
    ("/v1/generate", {"tokens": TOKS, "ages": AGES, "max_new": 6,
                      "uniforms": [[0.5, 0.5]]}),
    ("/v1/generate", {"tokens": TOKS, "ages": AGES, "max_new": "many"}),
    ("/v1/generate", {"tokens": ["x"], "ages": [0.0]}),
    ("/v1/risk", {"tokens": TOKS, "ages": AGES, "horizon": "x"}),
    ("/v1/risk", {"ages": AGES}),
    ("/v1/stream", {"tokens": [], "ages": []}),
    ("/v1/futures", {"tokens": TOKS, "ages": AGES, "n_futures": 0}),
    ("/v1/generate_batch", {"requests": [{"tokens": []}]}),
    ("/v1/generate_batch", {}),
    ("/v1/cancel", {}),
    ("/v1/nope", {}),
    ("/v1/generate", {"tokens": TOKS, "ages": AGES,
                      "protocol_version": "999"}),
    ("/v1/risk", {"tokens": TOKS, "ages": AGES, "protocol_version": "999"}),
    ("/v1/stream", {"tokens": TOKS, "ages": AGES,
                    "protocol_version": "999"}),
    ("/v1/generate_batch", {"requests": [], "protocol_version": "999"}),
])
def test_http_errors_equal_jax(setup, jax_server, path, payload):
    _, _, server = setup
    mine = _post_raw(server.address, path, payload)
    theirs = _post_raw(jax_server.address, path, payload)
    assert mine[0] == theirs[0] >= 400
    assert mine[1]["error"]["code"] == theirs[1]["error"]["code"]


def test_http_bad_uniforms_then_keeps_serving(setup):
    _, _, server = setup
    status, body = _post_raw(server.address, "/v1/generate",
                             {"tokens": TOKS, "ages": AGES, "max_new": 6,
                              "uniforms": [[0.5, 0.5]]})
    assert (status, body["error"]["code"]) == (400, "invalid_request")
    status, _ = _post_raw(server.address, "/v1/generate",
                          {"tokens": TOKS, "ages": AGES, "max_new": 2})
    assert status == 200


def test_http_error_invalid_json(setup, jax_server):
    _, _, server = setup
    got = []
    for url in (server.address, jax_server.address):
        req = urllib.request.Request(
            url + "/v1/generate", data=b"{not json",
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=WAIT)
        got.append((ei.value.code,
                    json.loads(ei.value.read())["error"]["code"]))
    assert got[0] == got[1] == (400, "invalid_request")


def test_engine_stop_unblocks_inflight_waiters(setup):
    params, cfg, _ = setup
    backend = _engine_backend(params, cfg)
    backend.request_timeout = 60.0
    orig = backend.engine.step
    backend.engine.step = lambda: (time.sleep(0.01), orig())[1]
    backend.engine.start()
    outcome = {}

    def run():
        try:
            outcome["out"] = backend.generate_batch(
                [GenerateRequest(tokens=TOKS, ages=AGES, max_new=60,
                                 uniforms=_long_running_uniforms(60, cfg))
                 for _ in range(8)])
        except Exception as e:              # noqa: BLE001
            outcome["err"] = e

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.2)
    backend.engine.stop()
    t.join(timeout=15)
    assert not t.is_alive()
    assert "stopped" in str(outcome["err"])


def test_remote_stream_validates_eagerly(setup):
    _, _, server = setup
    remote = Client.connect(server.address)
    with pytest.raises(ApiError) as ei:
        remote.stream(tokens=[], ages=[])
    assert ei.value.code == "empty_trajectory"


def test_remote_rejects_rng_before_the_wire(setup):
    _, _, server = setup
    remote = Client.connect(server.address)
    with pytest.raises(ApiError) as ei:
        remote.generate(tokens=TOKS, ages=AGES,
                        rng=np.random.default_rng(0))
    assert ei.value.code == "rng_not_serializable"


def test_serve_artifact_refused():
    """Serving an exported artifact needs the port of the SDK runtime: the
    CLI refuses ``--artifact`` and ``Client.from_artifact`` raises."""
    with pytest.raises(SystemExit, match="--artifact is not ported yet"):
        server_mod.main(["--artifact", "somewhere", "--port", "0"])
    with pytest.raises(NotImplementedError, match="SDK runtime"):
        Client.from_artifact("somewhere")


# ---------------------------------------------------------------------------
# The wire, both ways
# ---------------------------------------------------------------------------
def test_jax_remote_drives_the_port_server(setup):
    _, cfg, server = setup
    u = _uniforms(6, cfg.vocab_size, seed=5)
    mine = Client.connect(server.address)
    theirs = jax_api.Client.connect(server.address)
    a = mine.generate(tokens=TOKS, ages=AGES, max_new=6, uniforms=u)
    b = theirs.generate(tokens=TOKS, ages=AGES, max_new=6, uniforms=u)
    assert (a.tokens, a.ages, a.backend) == (b.tokens, b.ages, b.backend)
    assert [(e.token, e.age) for e in theirs.stream(
        tokens=TOKS, ages=AGES, max_new=6, uniforms=u)] == \
        list(zip(a.tokens, a.ages))
    uf = np.stack([_uniforms(4, cfg.vocab_size, seed=i) for i in range(2)])
    fa = mine.sample_futures(tokens=TOKS, ages=AGES, n_futures=2, max_new=4,
                             uniforms=uf)
    fb = theirs.sample_futures(tokens=TOKS, ages=AGES, n_futures=2,
                               max_new=4, uniforms=uf)
    # the same futures and report; ``sharing`` counts over the engine's
    # life, so the second call sees one more fork
    assert {k: v for k, v in fa.to_json().items() if k != "sharing"} == \
        {k: v for k, v in fb.to_json().items() if k != "sharing"}
    assert fb.sharing["forks"] == fa.sharing["forks"] + 1
    assert mine.risk(TOKS, AGES).to_json() == theirs.risk(TOKS,
                                                           AGES).to_json()
    with pytest.raises(jax_api.ApiError) as ei:
        theirs.generate(tokens=[], ages=[])
    assert ei.value.code == "empty_trajectory"


def test_port_remote_drives_the_jax_server(jax_server):
    cfg = _cfg()
    u = _uniforms(6, cfg.vocab_size, seed=5)
    mine = Client.connect(jax_server.address)
    theirs = jax_api.Client.connect(jax_server.address)
    a = mine.generate(tokens=TOKS, ages=AGES, max_new=6, uniforms=u)
    b = theirs.generate(tokens=TOKS, ages=AGES, max_new=6, uniforms=u)
    assert (a.tokens, a.ages, a.backend) == (b.tokens, b.ages, b.backend)
    assert [(e.token, e.age) for e in mine.stream(
        tokens=TOKS, ages=AGES, max_new=6, uniforms=u)] == \
        list(zip(b.tokens, b.ages))
    uf = np.stack([_uniforms(4, cfg.vocab_size, seed=i) for i in range(2)])
    fa = mine.sample_futures(tokens=TOKS, ages=AGES, n_futures=2, max_new=4,
                             uniforms=uf)
    fb = theirs.sample_futures(tokens=TOKS, ages=AGES, n_futures=2,
                               max_new=4, uniforms=uf)
    # the same futures and report; ``sharing`` counts over the engine's
    # life, so the second call sees one more fork
    assert {k: v for k, v in fa.to_json().items() if k != "sharing"} == \
        {k: v for k, v in fb.to_json().items() if k != "sharing"}
    assert fb.sharing["forks"] == fa.sharing["forks"] + 1
    assert mine.risk(TOKS, AGES).to_json() == theirs.risk(TOKS,
                                                           AGES).to_json()
    with pytest.raises(ApiError) as ei:
        mine.generate(tokens=[], ages=[])
    assert ei.value.code == "empty_trajectory"


# ---------------------------------------------------------------------------
# HTTP/1.1 keep-alive
# ---------------------------------------------------------------------------
def test_keep_alive_reuses_one_connection(setup):
    _, _, server = setup
    remote = RemoteBackend(server.address)
    assert remote.connections_opened == 1       # the manifest handshake
    for _ in range(3):
        remote.generate(GenerateRequest(tokens=TOKS, ages=AGES, max_new=2))
    remote.healthz()
    assert remote.connections_opened == 1
    list(remote.stream(GenerateRequest(tokens=TOKS, ages=AGES, max_new=2)))
    assert remote.connections_opened == 2       # SSE is close-delimited
    remote.generate(GenerateRequest(tokens=TOKS, ages=AGES, max_new=2))
    assert remote.connections_opened == 2
    remote.close()


def test_keep_alive_off_dials_per_call(setup):
    _, _, server = setup
    remote = RemoteBackend(server.address, keep_alive=False)
    n0 = remote.connections_opened
    remote.healthz()
    remote.healthz()
    assert remote.connections_opened == n0 + 2


def test_keep_alive_survives_stale_socket(setup):
    _, _, server = setup
    remote = RemoteBackend(server.address)
    remote.healthz()
    remote._conn.close()                        # simulate an idle drop
    assert remote.healthz()["ok"]


def test_burst_of_connections_needs_no_syn_retry(setup):
    """32 clients connect at once while the engine's loop ticks (and holds
    the interpreter lock in stretches): the listen backlog takes them all.
    With the stdlib's backlog of 5 some connects wait for the kernel's 1 s
    SYN retry."""
    import socket
    params, cfg, _ = setup
    server = InferenceServer(_engine_backend(params, cfg, slots=2,
                                             max_context=256),
                             port=0).start()
    host, port = server.httpd.server_address[:2]
    busy = threading.Thread(target=lambda: Client.connect(
        server.address).generate(tokens=TOKS, ages=AGES, max_new=200,
                                 uniforms=_long_running_uniforms(200, cfg)))
    try:
        busy.start()
        time.sleep(0.3)
        took, socks = [], []

        def connect():
            t0 = time.perf_counter()
            socks.append(socket.create_connection((host, port), timeout=10))
            took.append(time.perf_counter() - t0)
        ts = [threading.Thread(target=connect) for _ in range(32)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT)
        assert len(took) == 32 and max(took) < 0.9, sorted(took)[-4:]
    finally:
        for sck in socks:
            sck.close()
        busy.join(WAIT)
        server.stop()
    assert server.httpd.request_queue_size >= 32


# ---------------------------------------------------------------------------
# Cancellation over the wire
# ---------------------------------------------------------------------------
def test_cancel_unknown_id_and_dedicated_connection(setup):
    _, _, server = setup
    remote = RemoteBackend(server.address)
    remote.healthz()
    n0 = remote.connections_opened
    assert remote.cancel("no-such-request") is False
    assert remote.connections_opened == n0 + 1


def test_unknown_endpoint_with_body_keeps_connection_in_sync(setup):
    _, _, server = setup
    remote = RemoteBackend(server.address)
    with pytest.raises(ApiError) as ei:
        remote._request("POST", "/v1/generte",
                        {"tokens": [1, 2, 3], "junk": "x" * 256})
    assert ei.value.code == "unknown_endpoint"
    assert remote.healthz()["ok"]
    assert remote.connections_opened == 1


def test_duplicate_request_id_is_rejected(setup):
    params, cfg, _ = setup
    backend = _engine_backend(params, cfg, slots=1, max_context=512,
                              cache="paged")
    orig = backend.engine.step
    backend.engine.step = lambda: (time.sleep(0.01), orig())[1]
    server = InferenceServer(backend, port=0).start()
    try:
        remote = Client.connect(server.address)
        results = []

        def blocker():
            try:
                results.append(remote.generate(
                    GenerateRequest(tokens=TOKS, ages=AGES, max_new=480,
                                    uniforms=_long_running_uniforms(480, cfg),
                                    request_id="dup")))
            except ApiError as e:       # cancelled below
                results.append(e)
        t = threading.Thread(target=blocker)
        t.start()
        deadline = time.monotonic() + WAIT
        while backend.engine.slot_req[0] is None \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(InvalidRequestError) as ei:
            Client.connect(server.address).generate(
                GenerateRequest(tokens=TOKS, ages=AGES, max_new=2,
                                request_id="dup"))
        assert ei.value.code == "invalid_request"
        backend.cancel("dup")
        t.join(WAIT)
        assert isinstance(results[0], RequestCancelledError)
    finally:
        server.stop()


def test_sse_streams_per_event_not_buffered(setup):
    params, cfg, _ = setup
    backend = _engine_backend(params, cfg, slots=1, max_context=512,
                              cache="paged")
    server = InferenceServer(backend, port=0).start()
    try:
        remote = Client.connect(server.address)
        it = remote.stream(GenerateRequest(
            tokens=TOKS, ages=AGES, max_new=400,
            uniforms=_long_running_uniforms(400, cfg)))
        next(it)
        assert any(r is not None for r in backend.engine.slot_req), \
            "first frame only arrived after the request completed"
        assert 1 + sum(1 for _ in it) == 400
    finally:
        server.stop()


def test_cancel_inflight_stream_emits_cancelled_frame(setup):
    params, cfg, _ = setup
    backend = _engine_backend(params, cfg, slots=1, max_context=512,
                              cache="paged")
    orig = backend.engine.step
    backend.engine.step = lambda: (time.sleep(0.02), orig())[1]
    server = InferenceServer(backend, port=0).start()
    try:
        remote = Client.connect(server.address)
        it = remote.stream(GenerateRequest(
            tokens=TOKS, ages=AGES, max_new=480,
            uniforms=_long_running_uniforms(480, cfg),
            request_id="cancel-me"))
        got = [next(it)]
        assert remote.cancel("cancel-me") is True
        with pytest.raises(RequestCancelledError) as ei:
            for ev in it:
                got.append(ev)
        assert (ei.value.code, ei.value.http_status) == \
            ("request_cancelled", 409)
        assert len(got) < 480
        h = remote.backend.healthz()
        assert h["engine"]["memory"]["blocks_used"] == 0
        assert h["engine"]["memory"]["cache"] == "paged"
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def test_server_cli_boots_answers_and_stops_on_sigint():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.server", "--config",
         "delphi-2m", "--reduced", "--device", "cpu", "--port", "0",
         "--slots", "2", "--max-context", "64", "--cache", "paged"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        url, lines = None, []
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if " backend on http://" in line:
                url = line.split(" backend on ")[1].split()[0]
        assert url, "".join(lines)
        assert any("[paged] on cpu" in ln for ln in lines)
        assert _get(url, "/v1/healthz")["engine"]["running"]
        r = Client.connect(url).generate(tokens=TOKS, ages=AGES, max_new=3)
        assert r.backend == "remote[engine]"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def test_cli_refuses_knobs_without_the_paged_cache():
    for argv in (["--config", "delphi-2m", "--reduced", "--device", "cpu",
                  "--prefix-cache"],
                 ["--config", "delphi-2m", "--reduced", "--device", "cpu",
                  "--prefill-chunk-tokens", "32"],
                 []):
        with pytest.raises(SystemExit):
            server_mod._build_backend(server_mod.parse_args(argv))
    args = server_mod.parse_args(["--config", "delphi-2m", "--reduced",
                                  "--device", "cpu", "--backend", "local"])
    backend = server_mod._build_backend(args)
    assert backend.name == "local" and backend.cfg.dtype == "float32"
    req = FuturesRequest(tokens=TOKS, ages=AGES, n_futures=2, max_new=3)
    assert len(backend.sample_futures(req).trajectories) == 2
