"""Run the dense phases of ``chip_smoke.py`` alone on the card.

Builds the kernels, holds flash and paged against their plain versions at
every phase-2 case (the dense LMs' shapes among them), then runs phases
3k (TinyLlama-1.1B served), 3l (H2O-Danube-1.8B past its window), 3m
(Delphi-100M served), 3n (the generic-LM artifact) and 6e (Delphi-100M
training at S 1,024), each with its gates, and times flash and paged at
the shapes of 3k and 3l beside their bounds, plain versions and SDPA.
``--only`` picks phases (``3k,3l,3m,3n,6e``; the timing rows need 3k and
3l).  Every number goes to ``chiprun_out/dense_phases.json`` with the
card's name and power limit.

Run on the card, from the repository root:
    python3 scripts/torch_dense_phases.py [--only 3k,3l]
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="3k,3l,3m,3n,6e")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("torch_dense_phases: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        cs.log(f"== {name} took {seconds[name]:.1f}s")
        return out
    timed("build", build.library)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    timed("phase 2 (flash, paged)",
          lambda: (cs.check_flash(gen), cs.check_paged(gen)))
    out, rows = {}, {}
    for name, fn in (("3k", cs.tinyllama_path), ("3l", cs.danube_path),
                     ("3m", cs.delphi100m_path)):
        if name in only:
            out[name] = timed(name, fn)
    if "3n" in only:
        with tempfile.TemporaryDirectory() as tmp:
            out["3n"] = timed("3n", cs.lm_artifact_path, tmp)
    if "6e" in only:
        out["6e grads"] = timed("6e grads", cs.long_grads_path)
        out["6e train"] = timed("6e train", cs.long_train_path)
    if {"3k", "3l"} <= only:
        tl, dn = out["3k"], out["3l"]
        tc, dc = tl["cfg"], dn["cfg"]
        nb, sb = max(tl["prefill_shapes"], key=lambda s: s[0] * s[1] * s[1])
        t0 = time.perf_counter()
        rows = {
            "flash_attention 3k": cs.flash_row(
                gen, nb, tc.n_heads, sb, tc.head_dim, Hkv=tc.n_kv_heads),
            "flash_attention 3l": cs.flash_row(
                gen, 1, dc.n_heads, 4608, dc.head_dim, Hkv=dc.n_kv_heads,
                window=dc.sliding_window),
            "paged_decode_attention 3k": cs.paged_row(
                gen, *tl["layer0"], "phase 3k's ring", G=tc.q_per_kv),
            "paged_decode_attention 3l": cs.paged_row(
                gen, *dn["layer0"], "phase 3l's ring", G=dc.q_per_kv,
                window=dc.sliding_window)}
        seconds["rows"] = time.perf_counter() - t0
    for name, r in out.items():
        r.pop("layer0", None)
        if "cfg" in r:
            r["cfg"] = r["cfg"].name
        cs.log(f"{name}: {r}")
    for name, r in rows.items():
        cs.log(f"{name} [{r['shape']}]: kernel {r['kernel']}, plain "
               f"{r['plain']}, library {r['library']}, bound "
               f"{r['bound_ms']:.6f} ms ({r['bound_by']}), max abs err "
               f"{r['max_abs_err']:.3g}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "dense_phases.json"),
              "w") as f:
        json.dump({"card": smi, "seconds": seconds, "phases": out,
                   "rows": rows}, f, indent=1, default=str)
    cs.log(f"OK dense phases {sorted(only)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
