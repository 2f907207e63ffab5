"""Boot the port's HTTP front-end and round-trip the wire protocol.

Serves a reduced Delphi-2M ``EngineBackend`` through
``repro_torch.serve.server`` on an ephemeral port, on ``--device`` (the
card unless ``--device cpu``), and drives it through
``Client(RemoteBackend(url))``, asserting

* generate over the wire equals ``Client.from_engine`` on a twin engine
  with the same knobs bit for bit (tokens and ages), one request at a time,
  under injected uniforms (they cross as base64 raw fp32 bytes),
* SSE streaming yields exactly the events of generate,
* ``/v1/futures`` equals ``ring_reference_futures`` bit for bit,
* ``/v1/risk`` equals the closed form on the twin's logits,
* every validation failure, a cancelled request and an expired one surface
  as structured JSON errors with their stable codes and statuses.

Run:  PYTHONPATH=src python scripts/torch_serve_http_roundtrip.py
      [--device cpu] [--dtype float32|bfloat16]
"""
import argparse
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from repro_torch.api import ApiError, Client, GenerateRequest
from repro_torch.api.client import EngineBackend
from repro_torch.configs import get_config
from repro_torch.core.risk import analytic_next_event_risk_np
from repro_torch.models import init_params
from repro_torch.serve import ring_reference_futures
from repro_torch.serve.server import InferenceServer


def _post_raw(url, path, payload, timeout=120):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _slow_ticks(engine, seconds=0.01):
    """Give a long request time to be cancelled or to expire."""
    step = engine.step
    engine.step = lambda: (time.sleep(seconds), step())[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype=args.dtype, vocab_size=96, max_seq_len=48, max_age=1e9)
    params = init_params(cfg, seed=7, device=args.device)
    knobs = dict(slots=4, max_context=64, cache="paged", prefix_cache=True,
                 device=args.device)
    V = cfg.vocab_size
    rng = np.random.default_rng(42)
    toks, ages = [3, 10, 20], [0.0, 15.0, 28.0]

    server = InferenceServer(EngineBackend.create(params, cfg, **knobs),
                             port=0).start()
    twin = Client.serving(params, cfg, **knobs)
    try:
        remote = Client.connect(server.address)
        # 1) generate over the wire == the twin, bit for bit; SSE == generate
        n_events = 0
        for S in (3, 7, 20):
            t = (np.arange(3, 3 + S) % 90).tolist()
            a = np.linspace(0.0, 30.0, S).astype(np.float32).tolist()
            u = rng.uniform(size=(6, V)).astype(np.float32)
            res = remote.generate(tokens=t, ages=a, max_new=6, uniforms=u)
            ref = twin.generate(tokens=t, ages=a, max_new=6, uniforms=u)
            assert (res.tokens, res.ages) == (ref.tokens, ref.ages), \
                f"remote {res.tokens} != twin {ref.tokens}"
            assert res.backend == "remote[engine]"
            evs = list(remote.stream(tokens=t, ages=a, max_new=6,
                                     uniforms=u))
            assert [(e.token, e.age) for e in evs] == \
                list(zip(res.tokens, res.ages))
            n_events += len(res.tokens)
        assert n_events > 0

        # 2) futures == the straight-line oracle
        fu = rng.uniform(size=(4, 6, V)).astype(np.float32)
        fr = remote.sample_futures(tokens=toks, ages=ages, n_futures=4,
                                   max_new=6, uniforms=fu)
        ora = ring_reference_futures(params, cfg, toks, ages, n=4,
                                     max_new=6, uniforms=fu, slots=4,
                                     max_context=64, device=args.device)
        assert [(t.tokens, t.ages) for t in fr.trajectories] == \
            [(list(t), [float(x) for x in a]) for t, a in ora]

        # 3) risk == the closed form on the twin's logits
        rr = remote.risk(toks, ages, horizon=5.0, top=8)
        want = analytic_next_event_risk_np(twin.backend.logits(toks, ages),
                                           5.0)
        assert [i.token for i in rr.items] == \
            np.argsort(-want)[:8].tolist()
        np.testing.assert_allclose([i.risk for i in rr.items],
                                   np.sort(want)[::-1][:8], rtol=1e-6)

        # 4) validation failures -> stable JSON error codes
        cases = [
            ({"tokens": [], "ages": []}, 400, "empty_trajectory"),
            ({"tokens": list(range(100)), "ages": [0.0] * 100}, 400,
             "too_long"),
            ({"tokens": toks}, 400, "ages_required"),
            ({"tokens": toks, "ages": [0.0]}, 400, "ages_length_mismatch"),
            ({"tokens": toks, "ages": ages, "seed": 7}, 400,
             "unsupported_override"),
            ({"protocol_version": "999", "tokens": toks, "ages": ages}, 409,
             "protocol_version_mismatch"),
        ]
        for payload, want_status, want_code in cases:
            status, body = _post_raw(server.address, "/v1/generate", payload)
            assert (status, body["error"]["code"]) == \
                (want_status, want_code), (payload, status, body)
            try:
                remote.generate(GenerateRequest.from_json(dict(payload)))
                raise AssertionError(f"no error for {payload}")
            except ApiError as e:
                assert e.code == want_code, (payload, e.code)
    finally:
        server.stop()

    # 5) a cancelled request answers 409, an expired one 504
    backend = EngineBackend.create(params, cfg, slots=2, max_context=512,
                                   cache="paged", device=args.device)
    _slow_ticks(backend.engine)
    server = InferenceServer(backend, port=0).start()
    try:
        u = rng.uniform(size=(300, V)).astype(np.float32)
        u[:, cfg.death_token] = 1e-12           # never Death: runs long
        body = {"tokens": toks, "ages": ages, "max_new": 300,
                "uniforms": u.tolist(), "request_id": "rt-cancel"}
        out = {}
        t = threading.Thread(target=lambda: out.update(
            r=_post_raw(server.address, "/v1/generate", body)))
        t.start()
        deadline = time.monotonic() + 60
        while all(r is None for r in backend.engine.slot_req) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        status, res = _post_raw(server.address, "/v1/cancel",
                                {"request_id": "rt-cancel"})
        assert status == 200 and res["cancelled"], res
        t.join(120)
        assert (out["r"][0], out["r"][1]["error"]["code"]) == \
            (409, "request_cancelled"), out
        backend.engine.request_timeout = 0.2
        status, res = _post_raw(server.address, "/v1/generate",
                                dict(body, request_id="rt-expire"))
        assert (status, res["error"]["code"]) == (504, "timeout"), res
    finally:
        server.stop()

    print(f"OK torch http round-trip on {args.device} ({args.dtype}): "
          f"{n_events} events bit-identical remote vs twin engine (generate "
          f"+ SSE), futures == oracle, risk parity, {len(cases)} error "
          f"codes plus cancel 409 and timeout 504 mapped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
