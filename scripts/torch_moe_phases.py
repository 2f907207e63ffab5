"""Run the MoE phases of ``chip_smoke.py`` alone on the card.

Builds the kernels, holds flash and paged against their plain versions at
every phase-2 case (the MoE LMs' MHA 16/16 at hd 128 among them) and
``apply_moe`` in bf16 against fp32 at Qwen2-MoE's widths, then runs phases
3p (OLMoE-1B-7B served) and 3q (Qwen2-MoE-A2.7B served), each with its
gates, and times flash and paged at their shapes beside their bounds,
plain versions and SDPA.  ``--only`` picks phases (``3p,3q``; the timing
rows need 3q).  Every number goes to ``chiprun_out/moe_phases.json`` with
the card's name and power limit.

Run on the card, from the repository root:
    python3 scripts/torch_moe_phases.py [--only 3p]
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
    ap.add_argument("--only", default="3p,3q")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_phases: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    seconds = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        cs.log(f"== {name} took {seconds[name]:.1f}s")
        return out
    timed("build", build.library)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    moe_check = timed("phase 2 (flash, paged, apply_moe)",
                      lambda: (cs.check_flash(gen), cs.check_paged(gen),
                               cs.check_moe(gen))[2])
    out, rows = {}, {}
    for ph, arch, cut in (("3p", "olmoe-1b-7b", None),
                          ("3q", "qwen2-moe-a2.7b", cs.MOE_FP32_LAYERS)):
        if ph in only:
            t0 = time.perf_counter()
            out[ph] = timed(ph, cs.moe_path, arch, ph, fp32_layers=cut)
            cs.log_moe(out[ph], ph, smi, t0)
    if "3q" in only:
        q = out["3q"]
        rows = timed("rows", cs.moe_rows, gen, q["cfg"], q["layer0"])
    for r in out.values():
        r.pop("layer0")
        r["cfg"] = r["cfg"].name
    for name, r in rows.items():
        cs.log(f"{name} [{r['shape']}]: kernel {r['kernel']}, plain "
               f"{r['plain']}, library {r['library']}, bound "
               f"{r['bound_ms']:.6f} ms ({r['bound_by']}), max abs err "
               f"{r['max_abs_err']:.3g}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "moe_phases.json"),
              "w") as f:
        json.dump({"card": smi, "seconds": seconds, "moe_check": moe_check,
                   "phases": out, "rows": rows}, f, indent=1, default=str)
    cs.log(f"OK MoE phases {sorted(only)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
