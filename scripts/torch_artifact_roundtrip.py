"""Export a reduced Delphi as the port's SDK artifact and round-trip it.

Catches export/runtime drift that unit tests cannot: the serialized
``torch.export`` graphs must load in the model-code-free runtime
(``repro_torch.sdk.Runtime``) on ``--device`` (the card unless ``--device
cpu``) and drive the clients, under injected uniforms:

* spec v2 (prefill + decode graphs): ``Client.from_artifact`` generate ==
  ``LocalBackend.stream`` of the same weights bit for bit (one function,
  exported and eager), and stream == generate;
* spec v1 (the full graph only) through the legacy ``InferenceSession``:
  == ``ArtifactBackend(use_decode_graph=False)`` on the v2 artifact bit for
  bit (the same full graph), and its events held step by step against the
  model on their own prefix (``repro_torch.core.parity``: the full graph
  runs the flash kernel where v2 decodes with the paged one).

Run:  PYTHONPATH=src python scripts/torch_artifact_roundtrip.py
      [--device cpu] [--dtype float32|bfloat16]
"""
import argparse
import os
import sys
import tempfile
import warnings

import numpy as np

from repro_torch.api import ArtifactBackend, Client, GenerateRequest
from repro_torch.configs import get_config
from repro_torch.core.parity import check_trajectories, port_logits_fn
from repro_torch.models import init_params
from repro_torch.sdk import InferenceSession, export_model, verify_checksums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype=args.dtype, vocab_size=96, max_seq_len=48)
    params = init_params(cfg, seed=7, device=args.device)
    toks, ages = [3, 10, 20], [0.0, 15.0, 28.0]
    max_new = 6
    u = np.random.default_rng(42).uniform(
        size=(max_new, cfg.vocab_size)).astype(np.float32)
    req = GenerateRequest(tokens=toks, ages=ages, max_new=max_new,
                          uniforms=u, max_age=1e9)
    with tempfile.TemporaryDirectory(prefix="torch_artifact_") as tmp:
        d2, d1 = os.path.join(tmp, "v2"), os.path.join(tmp, "v1")
        export_model(params, cfg, d2)
        export_model(params, cfg, d1, spec_version="1")
        for d in (d2, d1):
            verify_checksums(d, strict=True)

        client = Client.from_artifact(d2, device=args.device)
        assert client.backend.use_decode_graph, "v2 must ship decode"
        res = client.generate(req)
        assert len(res.tokens) > 0
        local = [(e.token, e.age) for e in Client.from_params(
            params, cfg, device=args.device).stream(req)]
        assert list(zip(res.tokens, res.ages)) == local, \
            f"v2 {res.tokens} != LocalBackend.stream {local}"
        streamed = [e.token for e in client.stream(req)]
        assert streamed == res.tokens

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            sess = InferenceSession(d1, device=args.device)
        legacy = sess.generate_trajectory(toks, ages, max_new=max_new,
                                          uniforms=u, max_age=1e9)
        full = Client(ArtifactBackend(d2, use_decode_graph=False,
                                      device=args.device)).generate(req)
        assert (legacy["tokens"], legacy["ages"]) == (full.tokens,
                                                      full.ages)
        held = check_trajectories(
            [(toks, ages)], [(legacy["tokens"], legacy["ages"])], [u],
            port_logits_fn(params, cfg), margin_tol=2e-3, age_rtol=2e-3,
            max_age=1e9, death_token=cfg.death_token,
            max_context=cfg.max_seq_len)
    print(f"OK torch artifact round-trip on {args.device} ({args.dtype}): "
          f"v2 generate == stream == LocalBackend.stream on "
          f"{len(res.tokens)} events; the v1 session == the v2 full graph "
          f"on {len(legacy['tokens'])} events, held to the model on "
          f"{held['steps']} steps ({len(held['near_ties'])} near-ties)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
