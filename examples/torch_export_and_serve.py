"""The paper's App on the port, end to end: train -> export the FAIR
artifact -> "ship to the client" -> load it in a model-code-free runtime ->
interactive generation.

The twin of ``examples/export_and_serve.py`` on ``repro_torch``, on the
card unless ``--device cpu``.  The artifact (``torch.export`` graphs, the
ONNX analogue) decouples inference from the training code; with spec v2
the client generates through the exported prefill and KV-cached decode
graphs (``repro_torch.api.Client``), whose attention runs the
``flash_attention`` and ``paged_decode_attention`` kernels through
``kernels/library.py``'s operators on the card.  The legacy
``InferenceSession`` shim keeps the v1 full-graph loop for comparison.
The last line of the output is the kernels' launch counts, as JSON.

Run:  PYTHONPATH=src python examples/torch_export_and_serve.py
      [--device cpu]
"""
import argparse
import json
import tempfile
import warnings

from repro_torch.api import Client
from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.data import (SimulatorConfig, batches, generate_dataset,
                              pack_trajectories)
from repro_torch.data import vocab as V
from repro_torch.kernels import ops
from repro_torch.sdk import InferenceSession, export_model, verify_checksums
from repro_torch.train import OptimizerConfig, train_loop

STEPS = 60


def make_config():
    """Delphi-2M at its published width, fp32, 96 positions."""
    return get_config("delphi-2m").replace(dtype="float32", max_seq_len=96)


def train(params, cfg, device):
    """:data:`STEPS` of training -> (trained params, the training set)."""
    train_set, _ = generate_dataset(SimulatorConfig(n_train=512, n_val=8))
    ti = batches(pack_trajectories(train_set, 96), 32, seed=0)
    params, _ = train_loop(params, cfg,
                           OptimizerConfig(lr=6e-4, warmup_steps=5,
                                           total_steps=STEPS),
                           ti, objective="delphi", steps=STEPS,
                           log_every=20, device=device)
    return params, train_set


def export(params, cfg, out_dir: str):
    """Export spec v2 into ``out_dir``; -> (checksum report, manifest)."""
    export_model(params, cfg, out_dir)
    report = verify_checksums(out_dir)
    with open(f"{out_dir}/manifest.json") as f:
        return report, json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_config()
    params = init_delphi(cfg, 0, args.device)

    print("== server side: train briefly on synthetic data ==")
    params, train_set = train(params, cfg, args.device)

    print("== export: the ONNX-conversion step (full + prefill + decode "
          "graphs, params, FAIR manifest) ==")
    with tempfile.TemporaryDirectory(prefix="delphi_artifact_") as d:
        report, m = export(params, cfg, d)
        print("   artifact:", d)
        print(f"   checksums: {report} ({', '.join(sorted(report.files))})")
        print("   FAIR manifest:", json.dumps(
            {k: m[k] for k in ("identifier", "spec_version",
                               "interchange_format", "license", "privacy")},
            indent=4))

        print("== client side: load the artifact (no model code, no "
              "network) ==")
        client = Client.from_artifact(d, device=args.device)
        tok, age = train_set[1]
        half = max(len(tok) // 2, 2)
        hist_t, hist_a = tok[:half].tolist(), age[:half].tolist()
        print(f"   input trajectory ({half} events, like the App's left "
              f"panel):")
        for t, a in list(zip(hist_t, hist_a))[-5:]:
            print(f"     age {a:5.1f}  {V.code_name(int(t))}")

        print("   predicted continuation (right panel), streamed as "
              "sampled:")
        n = 0
        for ev in client.stream(tokens=hist_t, ages=hist_a, max_new=20):
            print(f"     age {ev.age:5.1f}  {V.code_name(ev.token)}")
            n += 1
        print(f"   {n} events (termination: Death token or age 85, "
              f"paper defaults)")

        print("   5-year morbidity risks (the App's displayed output):")
        for item in client.risk(hist_t, hist_a, horizon=5.0, top=5).items:
            print(f"     {item.risk:6.1%}  {V.code_name(item.token)}")

        # the legacy shim: the v1 loop re-runs the full graph per event
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            sess = InferenceSession(d, device=args.device)
        out = sess.generate_trajectory(hist_t, hist_a, max_new=4)
        print(f"   InferenceSession (v1 full-graph loop): "
              f"{[V.code_name(t) for t in out['tokens']]}")
    print(json.dumps({"launch_counts": ops.launch_counts()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
