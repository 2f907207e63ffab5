#!/usr/bin/env python3
"""The ring and the paged Delphi path on one card, in turns, and where the
host's time goes in an engine step.

    python3 scripts/torch_paged_host.py [--pairs 10] [--out FILE]

Serves ``chip_smoke.py`` phase 3's requests (Delphi-2M bf16 from
``init_params(0)``, 32 synthetic prompts, 16 slots, ``max_context`` 256,
``max_new`` 48, generator uniforms) through ``repro_torch.launch.serve``
with ``--cache ring`` and ``--cache paged`` in turns: pair i runs the ring
first when i is even and the paged cache first otherwise.  It reports each
run's events/s, each side's median and quartile distance, and the pairs
each side won.

Then one more run of each, with the engine's step split on the host clock
into the control pass, admission (its prefill, block copy and packed copy
included), fork ops, block scheduling (``_ensure_blocks``), the flush
(deactivations, position resets, the table upload), the tick's launches
(``_tick_core``), the tick's packed copy (``_fetch``, which waits for the
device) and the rest (uniforms, host bookkeeping).  Prints a table and one
JSON line; with ``--out`` the JSON also goes to FILE.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("_apply_control", "_admit", "_apply_forks", "_ensure_blocks",
          "_flush_slot_updates", "_tick_core", "_fetch")


def serve_args(cache: str):
    from repro_torch.launch import serve as launch
    return launch.parse_args(["--arch", "delphi-2m", "--requests", "32",
                              "--slots", "16", "--max-new", "48", "--seed",
                              "0", "--cache", cache, "--device", "cuda"])


def split_run(cache: str) -> dict:
    """One run with the step's phases timed.  A phase called inside another
    (the admission's flush and packed copy) counts in the outer one."""
    import torch
    from repro_torch.launch import serve as launch
    from repro_torch.serve import engine as engine_mod
    acc = collections.defaultdict(float)
    depth = [0]

    def timed(name, fn):
        def run(*a, **k):
            if depth[0]:
                return fn(*a, **k)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[name] += time.perf_counter() - t0
                depth[0] -= 1
        return run

    real_core, real_init = engine_mod._tick_core, engine_mod.BatchedEngine.__init__
    engine_mod._tick_core = timed("_tick_core", real_core)

    def init(self, *a, **k):
        real_init(self, *a, **k)
        for name in PHASES[:-2] + ("_fetch",):
            setattr(self, name, timed(name, getattr(self, name)))
        self.step = timed_step(self, self.step)

    def timed_step(eng, fn):
        def run():
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                acc["step"] += time.perf_counter() - t0
        return run
    engine_mod.BatchedEngine.__init__ = init
    try:
        out = launch.serve(serve_args(cache))
    finally:
        engine_mod._tick_core = real_core
        engine_mod.BatchedEngine.__init__ = real_init
    torch.cuda.synchronize()
    eng = out["engine"]
    steps = eng.ticks + eng.admit_batches
    ms = {k: v * 1e3 for k, v in acc.items()}
    ms["rest"] = ms["step"] - sum(ms.get(p, 0.0) for p in PHASES)
    return {"cache": cache, "seconds": out["seconds"],
            "events": out["events"], "ticks": eng.ticks,
            "admit_batches": eng.admit_batches, "ms": ms,
            "ms_per_tick": {k: v / eng.ticks for k, v in ms.items()},
            "steps": steps}


def main() -> int:
    import subprocess

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_host: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.launch import serve as launch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for cache in ("ring", "paged"):           # builds, cuBLAS, allocator
        launch.serve(serve_args(cache))
    runs = {"ring": [], "paged": []}
    wins = {"ring": 0, "paged": 0}
    for i in range(args.pairs):
        order = ("ring", "paged") if i % 2 == 0 else ("paged", "ring")
        got = {}
        for cache in order:
            out = launch.serve(serve_args(cache))
            got[cache] = out["events"] / out["seconds"]
            runs[cache].append(got[cache])
        if got["ring"] != got["paged"]:
            wins[max(got, key=got.get)] += 1
    summary = {}
    for cache, r in runs.items():
        q = statistics.quantiles(r, n=4)
        summary[cache] = {"median": statistics.median(r),
                          "quartile_distance": q[2] - q[0],
                          "wins": wins[cache], "runs": r}
    split = {cache: split_run(cache) for cache in ("ring", "paged")}
    print(f"card: {card}")
    for cache, s in summary.items():
        print(f"{cache:5s} events/s: median {s['median']:.1f}, quartile "
              f"distance {s['quartile_distance']:.1f}, won {s['wins']} of "
              f"{args.pairs} pairs; runs "
              + " ".join(f"{x:.1f}" for x in s["runs"]))
    print("host ms a tick (instrumented runs): "
          + ", ".join(f"{c} {split[c]['ticks']} ticks" for c in split))
    for name in ("step",) + PHASES + ("rest",):
        print(f"  {name:20s} " + "  ".join(
            f"{c} {split[c]['ms_per_tick'].get(name, 0.0):8.3f}"
            for c in split))
    record = {"card": card, "pairs": args.pairs, "summary": summary,
              "split": split}
    line = json.dumps(record)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
