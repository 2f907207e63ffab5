"""Run the Mamba2/Zamba2 phases of ``chip_smoke.py`` alone on the card.

Builds the kernels, holds flash, paged and ``ssd_intra`` against their
plain versions at every phase-2 case (Zamba2's shapes among them), then
runs phases 3o (Zamba2-1.2B served), 6f (Mamba2-780M trained) and 6g
(Zamba2-1.2B trained), each with its gates, and times ``ssd_intra``, flash
and paged at the shapes of 3o beside their bounds, plain versions and
SDPA.  ``--only`` picks phases (``3o,6f,6g``; the timing rows need 3o).
Every number goes to ``chiprun_out/hybrid_phases.json`` with the card's
name and power limit.

Run on the card, from the repository root:
    python3 scripts/torch_hybrid_phases.py [--only 3o,6f]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="3o,6f,6g")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("torch_hybrid_phases: no CUDA device is available",
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
    _, _, ssd_errs = timed("phase 2 (flash, paged, ssd_intra)",
                           lambda: (cs.check_flash(gen), cs.check_paged(gen),
                                    cs.check_ssd(gen)))
    out, rows = {}, {}
    if "3o" in only:
        out["3o"] = timed("3o", cs.zamba2_path)
    for ph, arch in (("6f", "mamba2-780m"), ("6g", "zamba2-1.2b")):
        if ph in only:
            out[ph] = timed(ph, cs.ssm_train_path, arch)
    if "3o" in only:
        zb = out["3o"]
        zc = zb["cfg"]
        t0 = time.perf_counter()
        rows = {
            "ssd_intra 3o": dict(cs.ssd_row(gen, zc, 1024),
                                 max_abs_err=ssd_errs["zamba2"]),
            "flash_attention 3o": cs.flash_row(gen, 1, zc.n_heads, 1024,
                                               zc.head_dim),
            "paged_decode_attention 3o": cs.paged_row(
                gen, *zb["ring0"], "phase 3o's ring", G=zc.q_per_kv,
                window=zc.sliding_window)}
        seconds["rows"] = time.perf_counter() - t0
        zb.pop("ring0")
        zb["cfg"] = zc.name
    for name, r in out.items():
        cs.log(f"{name}: {r}")
    for name, r in rows.items():
        cs.log(f"{name} [{r['shape']}]: kernel {r['kernel']}, plain "
               f"{r['plain']}, library {r['library']}, bound "
               f"{r['bound_ms']:.6f} ms ({r['bound_by']}), max abs err "
               f"{r['max_abs_err']:.3g}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "hybrid_phases.json"),
              "w") as f:
        json.dump({"card": smi, "seconds": seconds, "phases": out,
                   "rows": rows}, f, indent=1, default=str)
    cs.log(f"OK hybrid phases {sorted(only)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
