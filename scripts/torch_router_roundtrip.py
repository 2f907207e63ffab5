"""Two-replica router == a direct server, and a failover storm, on the port.

The twin of ``scripts/router_roundtrip.py`` on ``repro_torch``, on
``--device`` (the card unless ``--device cpu``): two in-process engine
replicas behind a ``RouterServer`` and one direct ``InferenceServer`` over
the same reduced Delphi-2M weights in fp32.  It asserts

* generate, SSE stream and futures through the router are bit-identical
  to the direct server under injected uniforms (the router adds a network
  hop and a scheduling decision, never a numeric one),
* repeated shared-history prompts are affinity-routed (the scheduler's
  counters),
* a failover storm (kill replica 0 in flight) loses no fresh request
  (each retries onto the survivor), surfaces the structured
  ``replica_unavailable`` on the pinned stream, and leaves the survivor's
  pool leak-free; with both replicas dead the router answers 503
  ``replica_unavailable``.

Run:  PYTHONPATH=src python scripts/torch_router_roundtrip.py [--device cpu]
"""
import argparse
import json
import sys
import urllib.error
import urllib.request

import numpy as np

from repro_torch.api import (Client, FuturesRequest, GenerateRequest,
                             ReplicaUnavailableError)
from repro_torch.api.client import EngineBackend
from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.serve.router import ReplicaSupervisor, RouterServer
from repro_torch.serve.server import InferenceServer


def _post_raw(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    params = init_delphi(cfg, 7, args.device)

    toks, ages = [3, 10, 20], [0.0, 15.0, 28.0]
    max_new = 6
    u = np.random.default_rng(42).uniform(
        size=(max_new, cfg.vocab_size)).astype(np.float32)
    u_long = np.random.default_rng(43).uniform(
        size=(40, cfg.vocab_size)).astype(np.float32)
    u_long[:, cfg.death_token] = 1e-12      # streams run their full max_new

    def make_backend(i):
        return EngineBackend.create(params, cfg, slots=4, max_context=64,
                                    cache="paged", prefix_cache=True,
                                    device=args.device)

    direct = InferenceServer(make_backend(-1), port=0).start()
    sup = ReplicaSupervisor.in_process(make_backend, 2, probe_interval=0.2)
    router = RouterServer(sup, port=0).start()
    try:
        via_router = Client.connect(router.address)
        via_direct = Client.connect(direct.address)

        # 1) bit-identical generation through the router
        res_r = via_router.generate(tokens=toks, ages=ages, max_new=max_new,
                                    uniforms=u)
        res_d = via_direct.generate(tokens=toks, ages=ages, max_new=max_new,
                                    uniforms=u)
        assert res_r.tokens == res_d.tokens, \
            f"router tokens {res_r.tokens} != direct {res_d.tokens}"
        assert res_r.ages == res_d.ages
        assert res_r.backend.startswith("remote[router[r"), res_r.backend
        assert res_r.request_id, "router must echo a routed request id"

        # 2) SSE through the router == direct SSE, frame for frame
        req = GenerateRequest(tokens=toks, ages=ages, max_new=max_new,
                              uniforms=u)
        ev_r = list(via_router.backend.stream(req))
        ev_d = list(via_direct.backend.stream(req))
        assert [(e.token, e.age) for e in ev_r] == \
               [(e.token, e.age) for e in ev_d], "SSE divergence"

        # 3) futures parity (pinned by router-assigned id, engine forks)
        uf = np.stack([np.random.default_rng(100 + i).uniform(
            size=(max_new, cfg.vocab_size)).astype(np.float32)
            for i in range(3)])
        freq = FuturesRequest(tokens=toks, ages=ages, n_futures=3,
                              max_new=max_new, uniforms=uf, horizon=5.0)
        fr = via_router.backend.sample_futures(freq)
        fd = via_direct.backend.sample_futures(freq)
        assert [t.tokens for t in fr.trajectories] == \
               [t.tokens for t in fd.trajectories], "futures divergence"

        # 4) shared histories are affinity-routed
        shared_t, shared_a = [5] * 20, [float(i) for i in range(20)]
        for i in range(6):
            via_router.generate(tokens=shared_t + [10 + i],
                                ages=shared_a + [21.0],
                                max_new=2, uniforms=u[:2])
        sched = via_router.backend.healthz()["router"]["scheduler"]
        assert sched["affinity_routed"] >= 5, sched
        n_parity = len(res_r.tokens) + len(ev_r)

        # 5) failover storm: pin a stream to r0... then kill r0 mid-flight
        sit = via_router.backend.stream(GenerateRequest(
            tokens=toks, ages=ages, max_new=40, uniforms=u_long,
            request_id="storm-pinned"))
        next(sit)                           # committed: stream is pinned
        victim = router.pinned_replica("storm-pinned")
        survivor = [r.name for r in sup.replicas if r.name != victim][0]
        sup.replica(victim).kill()
        try:
            list(sit)
            raise AssertionError("pinned stream must fail on replica death")
        except ReplicaUnavailableError:
            pass                            # structured failover signal
        # ...and hammer fresh generates: every one must land on the survivor
        for i in range(8):
            out = via_router.generate(tokens=toks, ages=ages, max_new=2,
                                      uniforms=u[:2])
            assert f"router[{survivor}:" in out.backend, out.backend
        h = via_router.backend.healthz()
        assert h["ok"] and not h["router"]["replicas"][victim]["healthy"]

        # 6) survivor pool is leak-free after the storm
        eng = sup.replica(survivor).server.backend.engine
        eng.stop()
        eng.drop_prefix_cache()
        st = eng.pool_stats()
        assert st["blocks_used"] == 0 and st["shared_blocks"] == 0, st
        eng.start()

        # 7) both replicas dead -> structured 503 replica_unavailable
        sup.replica(survivor).kill()
        status, body = _post_raw(router.address, "/v1/generate",
                                 {"tokens": toks, "ages": ages,
                                  "max_new": 2, "seed": 0})
        assert status == 503, (status, body)
        assert body["error"]["code"] == "replica_unavailable", body

        print(f"OK torch router round-trip on {args.device}: {n_parity} "
              f"events bit-identical "
              f"2-replica router vs direct engine (generate + SSE + "
              f"futures), affinity rate {sched['affinity_rate']:.2f}, "
              f"failover storm survived ({victim} killed mid-stream, 8/8 "
              f"retries on {survivor}, zero-leak pool, all-down -> 503 "
              f"replica_unavailable)")
    finally:
        router.stop()
        direct.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
