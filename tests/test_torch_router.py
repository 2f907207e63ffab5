"""The port's multi-replica router on the CPU, with in-process replicas:
twins of ``tests/test_router.py`` (prefix-affinity scheduling,
supervision, parity with a direct server, pinned cancel, failover mid
stream, the structured 503 when every replica is down, drain), the
scheduler's digests against the JAX package's, and the launcher's
``--replicas`` sharding.

A ``RouterServer`` over N in-process replicas is a drop-in for a single
``InferenceServer``: bit-identical results under injected uniforms, one
request at a time, and the same wire errors.  Every wait has a timeout and
every router stops in teardown.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.serve.prefix import prompt_digests as jax_prompt_digests
from repro_torch.api import (Client, GenerateRequest, RemoteBackend,
                             ReplicaUnavailableError, WIRE_PROTOCOL_VERSION)
from repro_torch.api.client import EngineBackend
from repro_torch.api.errors import RequestCancelledError
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch
from repro_torch.models import init_params
from repro_torch.serve import router as router_mod
from repro_torch.serve import server as server_mod
from repro_torch.serve.prefix import prompt_digests
from repro_torch.serve.router import (PrefixAffinityScheduler,
                                      ReplicaSupervisor, RouterServer)
from repro_torch.serve.server import InferenceServer

torch.set_num_threads(2)

TOKS = [3, 10, 20]
AGES = [0.0, 15.0, 28.0]


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    return init_params(cfg, seed=7, device="cpu"), cfg


def _make_backend_factory(params, cfg):
    def make_backend(i):
        return EngineBackend.create(params, cfg, slots=4, max_context=64,
                                    cache="paged", prefix_cache=True,
                                    device="cpu")
    return make_backend


@pytest.fixture(scope="module")
def router2(setup):
    """Two in-process replicas behind one router (non-destructive tests)."""
    params, cfg = setup
    sup = ReplicaSupervisor.in_process(
        _make_backend_factory(params, cfg), 2, probe_interval=0.1)
    router = RouterServer(sup, port=0).start()
    yield router
    router.stop()


@pytest.fixture(scope="module")
def direct(setup):
    """Single direct engine server: the bit-parity reference."""
    params, cfg = setup
    server = InferenceServer(_make_backend_factory(params, cfg)(0),
                             port=0).start()
    yield server
    server.stop()


def _uniforms(max_new, V, seed=42):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(max_new, V)).astype(np.float32)


def _long_running_uniforms(max_new, cfg, seed=42):
    u = _uniforms(max_new, cfg.vocab_size, seed)
    u[:, cfg.death_token] = 1e-12
    return u


def _post_raw(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# prompt_digests: the shared router/replica vocabulary
# ---------------------------------------------------------------------------
def test_prompt_digests_chain_extends():
    toks = list(range(3, 40))
    ages = [float(i) for i in range(len(toks))]
    chain_short, key_short = prompt_digests(toks[:32], ages[:32], 16)
    chain_long, key_long = prompt_digests(toks, ages, 16)
    # a longer prompt's chain extends the shorter one's chain exactly
    assert chain_long[:len(chain_short)] == chain_short
    assert len(chain_short) == 2 and len(chain_long) == 2
    assert key_short != key_long            # whole-prompt keys fold length
    # the router hashes histories exactly as the JAX package's does
    assert (chain_long, key_long) == jax_prompt_digests(toks, ages, 16)


# ---------------------------------------------------------------------------
# Scheduler unit tests (no HTTP)
# ---------------------------------------------------------------------------
class _FakeReplica:
    def __init__(self, name, free=None, inflight=0):
        self.name = name
        self._free = free
        self.inflight = inflight

    def free_blocks(self):
        return self._free


def test_scheduler_affinity_and_fallback():
    sched = PrefixAffinityScheduler(block_size=4)
    a, b = _FakeReplica("a", free=10), _FakeReplica("b", free=20)
    toks = list(range(3, 15))
    ages = [float(i) for i in range(len(toks))]
    r1, aff1 = sched.route(toks, ages, [a, b])
    assert not aff1 and r1 is b             # fallback: most free blocks
    # same prefix again: affinity holds it on b even though loads changed
    b.inflight = 5
    r2, aff2 = sched.route(toks, ages, [a, b])
    assert aff2 and r2 is b
    # an EXTENSION of the prefix still lands on b (chain walk)
    r3, aff3 = sched.route(toks + [77, 78, 79, 80], ages + [12., 13., 14., 15.],
                           [a, b])
    assert aff3 and r3 is b
    # a disjoint history falls back again
    r4, aff4 = sched.route([50, 51, 52, 53, 54], [0., 1., 2., 3., 4.], [a, b])
    assert not aff4
    st = sched.stats()
    assert st["affinity_routed"] == 2 and st["fallback_routed"] == 2
    assert st["tracked_digests"] > 0


def test_scheduler_forget_and_candidate_filter():
    sched = PrefixAffinityScheduler(block_size=4)
    a, b = _FakeReplica("a", free=10), _FakeReplica("b", free=5)
    toks, ages = list(range(3, 11)), [float(i) for i in range(8)]
    r1, _ = sched.route(toks, ages, [a, b])
    assert r1 is a
    # owner not in the candidate set (dead / draining): falls back
    r2, aff2 = sched.route(toks, ages, [b])
    assert r2 is b and not aff2
    # forget a dead replica's digests entirely
    dropped = sched.forget("b")
    assert dropped > 0
    r3, aff3 = sched.route(toks, ages, [a, b])
    assert not aff3                         # b's claim was forgotten
    with pytest.raises(ReplicaUnavailableError):
        sched.route(toks, ages, [])


def test_scheduler_least_loaded_tiebreak():
    sched = PrefixAffinityScheduler(block_size=4)
    a = _FakeReplica("a", free=None, inflight=3)
    b = _FakeReplica("b", free=None, inflight=1)
    r, aff = sched.route([3, 4, 5], [0., 1., 2.], [a, b])
    assert r is b and not aff               # unknown pools: fewest in-flight


# ---------------------------------------------------------------------------
# Supervisor: probing + health state machine
# ---------------------------------------------------------------------------
def test_supervisor_marks_unhealthy_after_consecutive_failures():
    # adopt a port nothing listens on: every probe fails
    sup = ReplicaSupervisor.adopt(["http://127.0.0.1:9"],
                                  probe_timeout=0.2)
    lost = []
    sup.on_unhealthy = lost.append
    r = sup.replicas[0]
    assert r.healthy                        # optimistic until proven dead
    for i in range(r.max_failures - 1):
        sup.probe_once()
        assert r.healthy and not lost
    sup.probe_once()                        # crosses the threshold
    assert not r.healthy and lost == ["r0"]
    sup.probe_once()                        # edge fires once, not per probe
    assert lost == ["r0"]
    assert sup.healthy() == []


def test_supervisor_probe_restores_health(router2):
    # probe an in-process replica through a second supervisor adopting it
    url = router2.supervisor.replicas[0].url
    sup = ReplicaSupervisor.adopt([url], probe_timeout=2.0)
    r = sup.replicas[0]
    r.probe_failed(), r.probe_failed(), r.probe_failed()
    assert not r.healthy
    sup.probe_once()                        # server answers: restored
    assert r.healthy
    snap = r.snapshot()
    assert snap["consecutive_failures"] == 0
    assert snap["healthz"]["ok"] is True


# ---------------------------------------------------------------------------
# Router wire surface: parity with a direct server
# ---------------------------------------------------------------------------
def test_router_manifest(router2, setup):
    _, cfg = setup
    with urllib.request.urlopen(router2.address + "/v1/manifest",
                                timeout=60) as r:
        m = json.loads(r.read())
    assert m["protocol_version"] == WIRE_PROTOCOL_VERSION
    assert m["backend"] == "router[engine]"
    assert m["model"]["vocab_size"] == cfg.vocab_size
    assert set(m["router"]["replicas"]) == {"r0", "r1"}


def test_router_generate_bit_parity(router2, direct, setup):
    _, cfg = setup
    u = _uniforms(8, cfg.vocab_size)
    via_router = Client.connect(router2.address).generate(
        tokens=TOKS, ages=AGES, max_new=8, uniforms=u)
    via_direct = Client.connect(direct.address).generate(
        tokens=TOKS, ages=AGES, max_new=8, uniforms=u)
    assert via_router.tokens == via_direct.tokens
    assert via_router.ages == via_direct.ages
    assert via_router.backend.startswith("remote[router[r")
    assert via_router.request_id is not None    # router-assigned id echoes


def test_router_stream_parity(router2, direct, setup):
    _, cfg = setup
    u = _uniforms(8, cfg.vocab_size)
    req = GenerateRequest(tokens=TOKS, ages=AGES, max_new=8, uniforms=u)
    ev_router = list(Client.connect(router2.address).backend.stream(req))
    ev_direct = list(Client.connect(direct.address).backend.stream(req))
    assert [(e.token, e.age) for e in ev_router] == \
           [(e.token, e.age) for e in ev_direct]


def test_router_futures_and_risk(router2, direct, setup):
    from repro_torch.api import FuturesRequest
    _, cfg = setup
    remote_r = Client.connect(router2.address)
    remote_d = Client.connect(direct.address)
    u = np.stack([_uniforms(6, cfg.vocab_size, seed=100 + i)
                  for i in range(3)])
    req = FuturesRequest(tokens=TOKS, ages=AGES, n_futures=3, max_new=6,
                         uniforms=u, horizon=5.0, top=5)
    fr = remote_r.backend.sample_futures(req)
    fd = remote_d.backend.sample_futures(req)
    assert [t.tokens for t in fr.trajectories] == \
           [t.tokens for t in fd.trajectories]
    assert [(i.token, i.risk) for i in fr.risk.items] == \
           [(i.token, i.risk) for i in fd.risk.items]
    assert fr.backend.startswith("remote[router[r")
    rep_r = remote_r.risk(TOKS, AGES, horizon=5.0, top=5)
    rep_d = remote_d.risk(TOKS, AGES, horizon=5.0, top=5)
    assert [(i.token, i.risk) for i in rep_r.items] == \
           [(i.token, i.risk) for i in rep_d.items]
    assert rep_r.backend.startswith("remote[router[r")


def test_router_validation_error_passthrough(router2):
    # replica-side validation failures keep their stable codes and statuses
    status, body = _post_raw(router2.address, "/v1/generate",
                             {"protocol_version": WIRE_PROTOCOL_VERSION,
                              "tokens": [], "max_new": 4})
    assert status == 400
    assert body["error"]["code"] == "empty_trajectory"


def test_router_affinity_counters_and_healthz(router2, setup):
    _, cfg = setup
    remote = Client.connect(router2.address)
    u = _uniforms(2, cfg.vocab_size)
    shared_toks = [5] * 20
    shared_ages = [float(i) for i in range(20)]
    before = remote.backend.healthz()["router"]["scheduler"]
    for i in range(4):
        remote.generate(tokens=shared_toks + [10 + i],
                        ages=shared_ages + [21.0],
                        max_new=2, uniforms=u)
    h = remote.backend.healthz()
    sched = h["router"]["scheduler"]
    # first routed the prefix somewhere; the repeats must follow it
    assert sched["affinity_routed"] >= before["affinity_routed"] + 3
    assert h["ok"] and h["backend"] == "router"
    reps = h["router"]["replicas"]
    assert set(reps) == {"r0", "r1"}
    for snap in reps.values():
        assert snap["healthy"] and snap["healthz"]["ok"]
        assert "blocks_free" in snap["healthz"]["engine"]["memory"]
    # the probe rollup carries each replica's prefix hit-rate delta
    time.sleep(0.3)                         # let a probe land post-traffic
    h2 = remote.backend.healthz()
    deltas = [s["prefix"] for s in h2["router"]["replicas"].values()]
    assert all(d is not None and "hit_rate" in d and "hits_delta" in d
               for d in deltas)


def test_router_pinned_cancel(router2, setup):
    _, cfg = setup
    u = _long_running_uniforms(40, cfg)
    remote = Client.connect(router2.address)
    it = remote.backend.stream(GenerateRequest(
        tokens=TOKS, ages=AGES, max_new=40, uniforms=u,
        request_id="pin-cancel-1"))
    next(it)                                # stream committed and pinned
    pinned = router2.pinned_replica("pin-cancel-1")
    assert pinned in ("r0", "r1")
    status, body = _post_raw(router2.address, "/v1/cancel",
                             {"protocol_version": WIRE_PROTOCOL_VERSION,
                              "request_id": "pin-cancel-1"})
    assert status == 200
    assert body["cancelled"] is True
    assert body["replica"] == pinned        # routed by pin, not broadcast
    with pytest.raises(RequestCancelledError):
        list(it)
    # terminal frame unwinds the pin
    deadline = time.time() + 5.0
    while router2.pinned_replica("pin-cancel-1") and time.time() < deadline:
        time.sleep(0.02)
    assert router2.pinned_replica("pin-cancel-1") is None


def test_cancel_unknown_id_fans_out(router2):
    status, body = _post_raw(router2.address, "/v1/cancel",
                             {"protocol_version": WIRE_PROTOCOL_VERSION,
                              "request_id": "never-seen"})
    assert status == 200
    assert body["cancelled"] is False and body["replica"] is None


def test_remote_backend_timeout_split(router2):
    rb = RemoteBackend(router2.address, connect_timeout=0.5,
                       read_timeout=77.0)
    assert rb.connect_timeout == 0.5 and rb.read_timeout == 77.0
    rb.close()
    rb2 = RemoteBackend(router2.address, timeout=33.0)
    assert rb2.connect_timeout == 33.0 and rb2.read_timeout == 33.0
    rb2.close()


# ---------------------------------------------------------------------------
# Failover: a replica dies mid-stream (destructive — own router)
# ---------------------------------------------------------------------------
def _park_after_first_event(sup, request_id):
    """Park the engine that serves ``request_id`` after its first event
    (the request's ``on_event`` hook blocks the loop's thread) until its
    replica's connections are severed: a kill then lands mid-stream
    whatever the host's load, never after the stream ran to its end.
    Returns the event that releases the engine (set it in teardown)."""
    release = threading.Event()
    for r in sup.replicas:
        engine = r.server.backend.engine
        submit = engine.submit

        def submit_parking(er, submit=submit):
            if er.request_id == request_id:
                on_event = er.on_event

                def on_event_then_park(token, age):
                    on_event(token, age)
                    release.wait()
                er.on_event = on_event_then_park
            return submit(er)
        engine.submit = submit_parking
        httpd = r.server.httpd
        sever = httpd.sever_connections

        def sever_then_release(sever=sever):
            sever()
            release.set()
        httpd.sever_connections = sever_then_release
    return release


def test_failover_mid_stream_kill(setup):
    params, cfg = setup
    sup = ReplicaSupervisor.in_process(
        _make_backend_factory(params, cfg), 2, probe_interval=0.1)
    router = RouterServer(sup, port=0).start()
    release = _park_after_first_event(sup, "doomed-stream")
    try:
        remote = Client.connect(router.address)
        u = _long_running_uniforms(40, cfg)
        it = remote.backend.stream(GenerateRequest(
            tokens=TOKS, ages=AGES, max_new=40, uniforms=u,
            request_id="doomed-stream"))
        next(it)                            # committed: pinned to a replica
        victim = router.pinned_replica("doomed-stream")
        assert victim is not None
        sup.replica(victim).kill()
        # the PINNED stream surfaces the structured replica_unavailable —
        # never a silent replay of already-emitted events on the survivor
        with pytest.raises(ReplicaUnavailableError):
            list(it)
        # fresh idempotent calls retry onto the survivor
        survivor = [r.name for r in sup.replicas if r.name != victim][0]
        out = remote.generate(tokens=TOKS, ages=AGES, max_new=4,
                              uniforms=u[:4])
        assert f"router[{survivor}:" in out.backend
        h = remote.backend.healthz()
        assert h["ok"]
        assert h["router"]["replicas"][victim]["healthy"] is False
        assert h["router"]["replicas"][survivor]["healthy"] is True
        # zero-leak invariant on the survivor's pool: stop ticking, drop
        # the prefix index, and every block must return to the allocator
        eng = sup.replica(survivor).server.backend.engine
        eng.stop()
        eng.drop_prefix_cache()
        st = eng.pool_stats()
        assert st["blocks_used"] == 0 and st["shared_blocks"] == 0
    finally:
        release.set()
        router.stop()


def test_a_probe_from_before_a_transport_failure_restores_nothing():
    """A healthz probe that began before a proxied call saw the replica
    die answered for the replica as it was: it must not mark the dead
    replica healthy again (the next probe, begun after, may)."""
    from repro_torch.serve.router import ReplicaHandle
    r = ReplicaHandle("r0", "http://127.0.0.1:1")
    before = r.deaths()
    assert r.mark_unhealthy() and not r.healthy
    r.probe_ok({"ok": True}, before)
    assert not r.healthy and r.snapshot()["consecutive_failures"] == 3
    r.probe_ok({"ok": True}, r.deaths())
    assert r.healthy and r.snapshot()["consecutive_failures"] == 0


def test_prober_counts_a_cut_healthz_body_as_a_failure():
    """A replica that dies while it writes its healthz leaves a body cut
    short: ``http.client.IncompleteRead``, which the prober counts as one
    failure instead of ending its thread."""
    import socket
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    url = "http://127.0.0.1:%d" % srv.getsockname()[1]

    def serve_cut():
        for _ in range(2):
            conn, _ = srv.accept()
            conn.recv(4096)
            conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 100\r\n"
                         b"\r\n{\"ok\": tr")
            conn.close()
    t = threading.Thread(target=serve_cut, daemon=True)
    t.start()
    try:
        with pytest.raises(OSError, match="IncompleteRead"):
            router_mod._get_json(url, "/v1/healthz", timeout=10.0)
        sup = ReplicaSupervisor.adopt([url], probe_interval=0.1)
        sup.probe_once()
        assert sup.replicas[0].snapshot()["consecutive_failures"] == 1
    finally:
        t.join(timeout=10.0)
        srv.close()


def test_all_replicas_down_is_structured_503(setup):
    params, cfg = setup
    sup = ReplicaSupervisor.in_process(
        _make_backend_factory(params, cfg), 2, probe_interval=0.1)
    router = RouterServer(sup, port=0).start()
    try:
        remote = Client.connect(router.address)
        for r in list(sup.replicas):
            r.kill()
        status, body = _post_raw(router.address, "/v1/generate",
                                 {"protocol_version": WIRE_PROTOCOL_VERSION,
                                  "tokens": TOKS, "ages": AGES,
                                  "max_new": 2, "seed": 0})
        assert status == 503
        assert body["error"]["code"] == "replica_unavailable"
        with pytest.raises(ReplicaUnavailableError):
            remote.generate(tokens=TOKS, ages=AGES, max_new=2, seed=0)
        h = remote.backend.healthz()
        assert h["ok"] is False
    finally:
        router.stop()


def test_drain_then_stop(setup):
    params, cfg = setup
    sup = ReplicaSupervisor.in_process(
        _make_backend_factory(params, cfg), 2, probe_interval=0.1)
    router = RouterServer(sup, port=0).start()
    try:
        remote = Client.connect(router.address)
        u = _uniforms(2, cfg.vocab_size)
        remote.generate(tokens=TOKS, ages=AGES, max_new=2, uniforms=u)
        drained = router.drain_replica("r0", timeout=10.0)
        assert drained
        assert not sup.replica("r0").accepting
        # every subsequent request lands on r1
        for _ in range(3):
            out = remote.generate(tokens=TOKS, ages=AGES, max_new=2,
                                  uniforms=u)
            assert "router[r1:" in out.backend
        assert router.scheduler.stats()["tracked_digests"] >= 0
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# Affinity shows in the replica's own prefix hits; the CLI and the launcher
# ---------------------------------------------------------------------------
def test_second_futures_visit_hits_the_prefix_holder(setup):
    """A patient asked for futures twice: the second visit routes by
    affinity to the replica that holds the history, whose parent then
    admits by reference (a prefix hit there, none on the other)."""
    params, cfg = setup
    sup = ReplicaSupervisor.in_process(
        _make_backend_factory(params, cfg), 2, probe_interval=0.1)
    router = RouterServer(sup, port=0).start()
    try:
        remote = Client.connect(router.address)
        toks = list(range(3, 40))
        ages = np.linspace(30.0, 60.0, len(toks)).astype(np.float32).tolist()
        u = np.stack([_uniforms(4, cfg.vocab_size, seed=i)
                      for i in range(3)])
        first = remote.sample_futures(tokens=toks, ages=ages, n_futures=3,
                                      max_new=4, uniforms=u)
        holder = first.backend.split("router[")[1].split(":")[0]
        before = router.scheduler.stats()["affinity_routed"]
        second = remote.sample_futures(tokens=toks, ages=ages, n_futures=3,
                                       max_new=4, uniforms=u)
        assert f"router[{holder}:" in second.backend
        assert router.scheduler.stats()["affinity_routed"] == before + 1
        assert [t.tokens for t in second.trajectories] == \
            [t.tokens for t in first.trajectories]
        hits = {r.name: r.server.backend.engine.prefix.hits
                for r in sup.replicas}
        assert hits[holder] >= 1
        assert sum(hits.values()) == hits[holder]
    finally:
        router.stop()


def test_build_router_from_the_cli_namespace(setup):
    args = server_mod.parse_args(
        ["--config", "delphi-2m", "--reduced", "--device", "cpu",
         "--replicas", "2", "--port", "0", "--cache", "paged",
         "--slots", "2", "--max-context", "64"])
    router = router_mod.build_router(args).start()
    try:
        reps = router.supervisor.replicas
        assert len(reps) == 2
        engines = [r.server.backend.engine for r in reps]
        assert all(e.prefix is not None and e.paged for e in engines)
        # one parameter set for every in-process replica
        assert engines[0].params["embed/embed"].data_ptr() == \
            engines[1].params["embed/embed"].data_ptr()
        out = Client.connect(router.address).generate(
            tokens=TOKS, ages=AGES, max_new=3)
        assert out.backend.startswith("remote[router[r")
    finally:
        router.stop()
    argv = router_mod._replica_argv_base(args)
    assert argv[argv.index("--device") + 1] == "cpu"
    assert "--artifact" not in argv


def test_build_router_over_artifact_replicas(tmp_path):
    """``--artifact DIR --replicas 2``: each in-process replica loads the
    artifact on ``--device``, and a subprocess replica's argv carries
    both."""
    from repro_torch.sdk import export_model
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=32)
    d = str(tmp_path / "art")
    export_model(init_params(cfg, seed=3, device="cpu"), cfg, d)
    args = server_mod.parse_args(["--artifact", d, "--device", "cpu",
                                  "--replicas", "2", "--port", "0"])
    router = router_mod.build_router(args).start()
    try:
        reps = router.supervisor.replicas
        assert [r.server.backend.name for r in reps] == ["artifact"] * 2
        out = Client.connect(router.address).generate(
            tokens=[3, 10, 20], ages=[0.0, 15.0, 28.0], max_new=3)
        assert out.backend.startswith("remote[router[r")
    finally:
        router.stop()
    argv = router_mod._replica_argv_base(args)
    assert argv[:4] == ["--artifact", d, "--device", "cpu"]


def test_launcher_shards_over_replicas(capsys):
    out = launch.main(["--arch", "delphi-2m", "--requests", "4", "--slots",
                       "2", "--max-new", "3", "--device", "cpu",
                       "--replicas", "2", "--cache", "paged"])
    assert len(out["done"]) == 4 and len(out["engines"]) == 2
    assert sum(out["shards"].values()) == 4
    assert out["routing"]["affinity_routed"] + \
        out["routing"]["fallback_routed"] == 4
    for eng in out["engines"]:
        assert not eng.running
        assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert "sharded 4 requests over 2 engines" in capsys.readouterr().out
