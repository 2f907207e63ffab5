"""Smoke-run every example of the port headlessly with fast arguments.

The twin of ``scripts/examples_smoke.py`` for ``examples/torch_*.py``: each
example runs in its own interpreter (import-order isolation, and exactly
how a user runs it) with ``--device`` (the card unless ``--device cpu``).
Each example's last line of output is its kernels' launch counts as JSON;
on the card, an example fails unless every kernel its path runs
(:data:`KERNELS`) launched at least once, so an example that quietly took
the plain route cannot pass.

Run:  PYTHONPATH=src python scripts/torch_examples_smoke.py
      [--device cpu] [--only torch_quickstart] [--jobs 2]
      [--json PATH]
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

#: example file -> fast-args override (the keys of scripts/examples_smoke.py
#: with the port's prefix).  The zoo runs all ten reduced architectures (a
#: few seconds): Mamba2's and Zamba2's rows are the only ones that drive
#: the ``ssd_intra`` kernel.
EXAMPLES = {
    "torch_quickstart.py": ["--steps", "2", "--patients", "64"],
    "torch_ablation_dual_loss.py": ["--steps", "2", "--patients", "64"],
    "torch_serve_batched.py": ["--requests", "4", "--slots", "4",
                               "--steps", "2", "--max-new", "6"],
    "torch_export_and_serve.py": [],
    "torch_federated_finetune.py": ["--clients", "2", "--pretrain-steps",
                                    "2", "--rounds", "1"],
    "torch_arch_zoo.py": [],
    "torch_serve_http.py": ["--port", "0", "--slots", "4"],
    "torch_cohort_sweep.py": ["--patients", "4", "--futures", "2",
                              "--max-new", "6", "--steps", "2"],
}

_DELPHI = ("tte_sample", "flash_attention", "paged_decode_attention")
#: example file -> the kernels its path launches on the card (training
#: takes the plain differentiable route and launches none)
KERNELS = {
    "torch_quickstart.py": _DELPHI,
    "torch_ablation_dual_loss.py": (),
    "torch_serve_batched.py": _DELPHI,
    "torch_export_and_serve.py": ("flash_attention",
                                  "paged_decode_attention"),
    "torch_federated_finetune.py": (),
    "torch_arch_zoo.py": ("flash_attention", "paged_decode_attention",
                          "ssd_intra"),
    "torch_serve_http.py": _DELPHI,
    "torch_cohort_sweep.py": _DELPHI,
}


def launch_counts(stdout: str):
    """The launch counts of an example's last line of output, or None."""
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1])["launch_counts"]
    except (IndexError, ValueError, KeyError, TypeError):
        return None


def run_one(root: str, name: str, extra, device: str, env, timeout: float):
    """-> {"name", "rc", "seconds", "launch_counts", "error", "tail"}."""
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "examples", name)] + extra
            + ["--device", device],
            env=env, cwd=root, capture_output=True, text=True,
            timeout=timeout)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", f"timed out after {timeout} s"
        out = out.decode() if isinstance(out, bytes) else out
    res = {"name": name, "rc": rc, "seconds": round(time.time() - t0, 1),
           "launch_counts": launch_counts(out), "error": None,
           "tail": (out[-2000:] + err[-2000:])}
    if rc != 0:
        res["error"] = f"exit code {rc}"
    elif res["launch_counts"] is None:
        res["error"] = "no launch counts on the last line"
    elif device.startswith("cuda"):
        idle = [k for k in KERNELS[name] if not res["launch_counts"].get(k)]
        if idle:
            res["error"] = f"launched none of {idle} on the card"
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", help="run a single example (stem or file)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--jobs", type=int, default=1,
                    help="examples run at a time")
    ap.add_argument("--json", help="write the per-example results here")
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src")] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))

    todo = {k: v for k, v in EXAMPLES.items()
            if not args.only or args.only in (k, k[:-3])}
    if not todo:
        print(f"torch_examples_smoke: no example matches --only "
              f"{args.only!r}", file=sys.stderr)
        return 2
    missing = [k for k in todo
               if not os.path.exists(os.path.join(root, "examples", k))]
    if missing:
        print(f"torch_examples_smoke: missing examples: {missing}",
              file=sys.stderr)
        return 2

    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        results = list(pool.map(
            lambda kv: run_one(root, kv[0], kv[1], args.device, env,
                               args.timeout), todo.items()))
    failures = []
    for r in results:
        status = "ok" if r["error"] is None else "FAIL"
        print(f"  {r['name']:30s} {status:5s} {r['seconds']:6.1f}s "
              f"{json.dumps(r['launch_counts'])}")
        if r["error"] is not None:
            failures.append(r["name"])
            sys.stderr.write(f"{r['name']}: {r['error']}\n{r['tail']}\n")
    if args.json:
        with open(args.json, "w") as f:
            json.dump([{k: v for k, v in r.items() if k != "tail"}
                       for r in results], f, indent=1)
    if failures:
        print(f"torch_examples_smoke: {len(failures)} failed: {failures}",
              file=sys.stderr)
        return 1
    print(f"torch_examples_smoke: all {len(todo)} examples ran clean on "
          f"{args.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
