"""Run chosen phases of ``chip_smoke.py`` alone on the card.

Builds the kernels and holds flash and paged against their plain versions
at every phase-2 case (``ssd_intra`` too when 3b, 3o or 3t runs), then runs the chosen phases, each with its gates, and
times the kernels at a group's shapes once every phase of that group has
run (``ROWS``: beside their bounds, plain versions and SDPA).  Phase 2's
``apply_moe`` check (with its dispatch check) runs with 3p, 3q or 6h.
Every number goes to ``chiprun_out/phases.json`` with the card's name and
power limit.

Phases (``PHASES``): 3b Mamba2-780M served (with its profiled window's
idle share), 3k TinyLlama-1.1B served, 3l H2O-Danube-1.8B past its
window, 3m Delphi-100M served, 3n the generic-LM artifact, 6e Delphi-100M
trained at S 1,024, 3o Zamba2-1.2B served, 3t the Mamba2 and Zamba2
artifact, 6f Mamba2-780M and 6g Zamba2-1.2B trained, 3p OLMoE-1B-7B and
3q Qwen2-MoE-A2.7B served, 3r InternVL2-26B and 3s SeamlessM4T-large-v2
through the model-level path, 3u the reference engine beside the batched
one, 6h Qwen2-MoE-A2.7B trained at 2 layers under both MoE dispatches with
remat off and on, 6i the launch layer (a process group of one, the 1 x 1
``DeviceMesh``, parameters as DTensors) in a subprocess.

``--root DIR`` takes ``chip_smoke.py`` and the port from another checkout
(a parent commit unpacked under the repository), so that two versions are
compared in turns inside one call; ``--out`` names the JSON file.

Run on the card, from the repository root:
    python3 scripts/torch_phases.py --only 3r,3s
    python3 scripts/torch_phases.py --only 3b,3o --root _parent \
        --out chiprun_out/phases_parent.json
"""
import argparse
import importlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

cs = None    # the chip_smoke module of --root, imported by main()


def _lm_artifact():
    with tempfile.TemporaryDirectory() as tmp:
        return cs.lm_artifact_path(tmp)


def _mamba():
    """3b, and the idle share of its first prompts as chip_smoke profiles
    them."""
    m = cs.mamba_path()
    eng = m["engine"]
    prof = cs.window_profile(
        lambda: cs.mamba_serve(m["params"], m["cfg"],
                               m["prompts"][:cs.PROFILE_REQUESTS],
                               cs.PROFILE_MAX_NEW)[2])
    return {"tokens": m["tokens"], "seconds": m["seconds"],
            "tokens_per_s": m["tokens"] / m["seconds"], "ticks": eng.ticks,
            "host_syncs": eng.host_syncs, "launches": m["launches"],
            "profile": prof}


def _log_mamba(res, phase, smi, t_start):
    p = res["profile"]
    cs.log(f"  {res['tokens']} tokens, {res['ticks']} ticks in "
           f"{res['seconds']:.3f}s: {res['tokens_per_s']:.1f} tokens/s; "
           f"launches {res['launches']}; the first {cs.PROFILE_REQUESTS} "
           f"prompts x {cs.PROFILE_MAX_NEW} tokens under the profiler: "
           f"device busy {p['device_busy_s']:.4f}s of {p['wall_s']:.3f}s "
           f"wall, idle share {p['idle_share']}, {p['launches']} device "
           f"activities ({smi})")


def _log_zamba2(res, phase, smi, t_start):
    r, p = res["run"], res["profile"]
    cs.log(f"  {r['tokens']} tokens, {r['ticks']} ticks in "
           f"{r['seconds']:.3f}s: {r['tokens_per_s']:.1f} tokens/s; "
           f"launches {r['launches']}; under the profiler: device busy "
           f"{p['device_busy_s']:.4f}s of {p['wall_s']:.3f}s wall, idle "
           f"share {p['idle_share']}, {p['launches']} device activities "
           f"({smi})")


PHASES = {
    "3b": _mamba,
    "3k": lambda: cs.tinyllama_path(),
    "3l": lambda: cs.danube_path(),
    "3m": lambda: cs.delphi100m_path(),
    "3n": _lm_artifact,
    "6e": lambda: {"grads": cs.long_grads_path(),
                   "train": cs.long_train_path()},
    "3o": lambda: cs.zamba2_path(),
    "3t": lambda: cs.ssm_artifact_phase(),
    "6f": lambda: cs.ssm_train_path("mamba2-780m"),
    "6g": lambda: cs.ssm_train_path("zamba2-1.2b"),
    "3p": lambda: cs.moe_path("olmoe-1b-7b", "3p"),
    "3q": lambda: cs.moe_path("qwen2-moe-a2.7b", "3q",
                              fp32_layers=cs.MOE_FP32_LAYERS),
    "3r": lambda: cs.zoo_path("internvl2-26b", "3r",
                              fp32_layers=cs.MOE_FP32_LAYERS),
    "3s": lambda: cs.zoo_path("seamless-m4t-large-v2", "3s"),
    "3u": lambda: cs.reference_engine_path(),
    "6h": lambda: cs.moe_train_path(),
    "6i": lambda: cs.launch_check(),
}
# phases whose results are printed by a logger (chip_smoke's own where it
# has one)
LOGGERS = {"3b": _log_mamba, "3o": _log_zamba2,
           "3p": lambda *a: cs.log_moe(*a), "3q": lambda *a: cs.log_moe(*a),
           "3r": lambda *a: cs.log_zoo(*a), "3s": lambda *a: cs.log_zoo(*a),
           "3t": lambda *a: cs.log_ssm_artifact_phase(*a)}


def _zamba2_rows(gen, out, ssd_errs):
    rows = cs.zamba2_rows(gen, out["3o"])
    rows["ssd_intra 3o"]["max_abs_err"] = ssd_errs["zamba2"]
    return rows


# (phases a group of timing rows needs, its rows from (gen, results,
# ssd_intra's phase-2 errors))
ROWS = (
    (("3k", "3l"), lambda gen, out, _: cs.dense_rows(gen, out["3k"],
                                                     out["3l"])),
    (("3o",), _zamba2_rows),
    (("3q",), lambda gen, out, _: cs.moe_rows(gen, out["3q"]["cfg"],
                                              out["3q"]["layer0"])),
    (("3r", "3s"), lambda gen, out, _: cs.zoo_rows(gen, out["3r"],
                                                   out["3s"])),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", required=True,
                    help="comma-separated phases: " + ",".join(PHASES))
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose chip_smoke.py and port to run")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "phases.json"))
    ap.add_argument("--rows", action=argparse.BooleanOptionalAction,
                    default=True, help="time the kernels at the phases' "
                    "shapes (ROWS)")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    unknown = sorted(set(only) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    global cs
    sys.path.insert(0, os.path.abspath(args.root))
    cs = importlib.import_module("chip_smoke")
    import torch
    if not torch.cuda.is_available():
        print("torch_phases: no CUDA device is available", file=sys.stderr)
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
        res = fn(*a)
        seconds[name] = time.perf_counter() - t0
        cs.log(f"== {name} took {seconds[name]:.1f}s")
        return res
    timed("build", build.library)
    gen = torch.Generator(device=cs.DEVICE)
    gen.manual_seed(cs.SEED)
    checks = {"flash": cs.check_flash, "paged": cs.check_paged}
    if {"3b", "3o", "3t"} & set(only):
        checks["ssd_intra"] = cs.check_ssd
    if {"3p", "3q", "6h"} & set(only):
        checks["apply_moe"] = cs.check_moe
    phase2 = timed(f"phase 2 ({', '.join(checks)})",
                   lambda: {k: fn(gen) for k, fn in checks.items()})
    out, rows = {}, {}
    for ph in only:
        t0 = time.perf_counter()
        out[ph] = timed(ph, PHASES[ph])
        if ph in LOGGERS:
            LOGGERS[ph](out[ph], ph, smi, t0)
    for needs, fn in ROWS:
        if args.rows and set(needs) <= set(only):
            rows.update(timed(f"rows {'+'.join(needs)}", fn, gen, out,
                              phase2.get("ssd_intra")))
    for r in out.values():
        r.pop("layer0", None)
        r.pop("ring0", None)
        if "cfg" in r:
            r["cfg"] = r["cfg"].name
    for name, r in rows.items():
        cs.log(f"{name} [{r['shape']}]: kernel {r['kernel']}, plain "
               f"{r['plain']}, library {r.get('library')}, bound "
               f"{r['bound_ms']:.6f} ms ({r['bound_by']}), max abs err "
               f"{r['max_abs_err']:.3g}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "seconds": seconds, "phase2": phase2,
                   "phases": out, "rows": rows}, f, indent=1, default=str)
    cs.log(f"OK phases {only} of {cs.ROOT} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
