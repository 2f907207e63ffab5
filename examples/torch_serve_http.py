"""Wire-protocol serving on the port: the App's client/server split, live.

Boots the port's HTTP/SSE front-end over an engine backend (the engine
ticks on a background thread while handler threads enqueue), then talks
to it as the paper's thin JS SDK would — generate, per-event SSE
streaming, and the closed-form risk panel — through
``Client.connect(url)``.

The twin of ``examples/serve_http.py`` on ``repro_torch``, on the card
unless ``--device cpu``.  The last line of the output is the kernels'
launch counts, as JSON.

Run:  PYTHONPATH=src python examples/torch_serve_http.py [--port 8478]
      [--device cpu]
(--port 0 picks an ephemeral port; the server is torn down at the end.
 To keep one running instead, use the `repro-torch-serve` CLI.)
"""
import argparse
import json

from repro_torch.api import Client
from repro_torch.api.client import EngineBackend
from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.data import vocab as V
from repro_torch.kernels import ops
from repro_torch.serve.server import InferenceServer

TOKENS = [V.SEX_MALE, V.LIFESTYLE0 + 2, V.DISEASE0 + 40]
AGES = [0.0, 30.0, 45.2]


def make_config():
    """Reduced Delphi-2M in fp32 (the JAX twin's model)."""
    return get_config("delphi-2m", reduced=True).replace(dtype="float32")


def start_server(params, cfg, *, slots: int, port: int, device):
    backend = EngineBackend.create(params, cfg, slots=slots,
                                   max_context=128, device=device)
    return backend, InferenceServer(backend, port=port).start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_config()
    params = init_delphi(cfg, 0, args.device)
    backend, server = start_server(params, cfg, slots=args.slots,
                                   port=args.port, device=args.device)
    try:
        print(f"== serving {backend.name} backend at {server.address} ==")
        client = Client.connect(server.address)
        m = client.backend.server_manifest
        print(f"manifest: wire v{m['protocol_version']}, "
              f"vocab={m['model']['vocab_size']}, "
              f"max_age={m['model']['max_age']}")

        print("\n== POST /v1/generate ==")
        res = client.generate(tokens=TOKENS, ages=AGES, max_new=12)
        for t, a in zip(res.tokens, res.ages):
            print(f"  age {a:5.1f}  {V.code_name(t)}")

        print("\n== POST /v1/stream (SSE, event per engine tick) ==")
        for ev in client.stream(tokens=TOKENS, ages=AGES, max_new=8):
            print(f"  [{ev.index}] age {ev.age:5.1f}  "
                  f"{V.code_name(ev.token)}")

        print("\n== POST /v1/risk (the App's left-hand panel) ==")
        rep = client.risk(TOKENS, AGES, horizon=5.0, top=5)
        for it in rep.items:
            print(f"  {it.risk:6.4f}  {V.code_name(it.token)}")

        print(f"\nhealthz: {client.backend.healthz()}")
    finally:
        server.stop()
    print("done.")
    print(json.dumps({"launch_counts": ops.launch_counts()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
