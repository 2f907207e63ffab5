#!/usr/bin/env python3
"""The ``tte_sample`` kernel's plans on one card, and its load order in SASS.

    python3 scripts/torch_tte_sweep.py [--out FILE]

Times the kernel (``src/repro_torch/kernels/csrc/tte_sample.cu``) under
forced plans, at the Delphi path's tick (16 x 1289 fp32, L2-warm) and at
the zoo's largest vocabulary (16 x 256,206, with a cold L2 and warm): every
cluster size 1, 2, 4 and 8 (blocks per row; 1 to 8 at the large
vocabulary), 4 and 8 elements a thread per round.  Each plan is printed with
how many of its clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``); the plan the kernel picks by itself at
B 16 is marked.  Device time per call comes from ``torch.profiler`` as
``chip_smoke.py`` measures it (``device_ms``; ``cold_device_ms`` after a
128 MB write and after a 128 MB read, the kernel's activity alone).

Then it disassembles the built library (``cuobjdump -sass``) and prints, for
each instance of the kernel, where its global loads (LDG) stand against its
first exp (MUFU.EX2): whether every load of a round is issued before the
round's first expf.  Prints a table and one JSON line; with ``--out`` the
JSON also goes to FILE (the SASS listing of the kernel beside it).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

CLUSTERS = (1, 2, 4, 8)
PER_THREAD = (4, 8)


def sass_load_order(lib: str) -> tuple:
    """(summary per kernel instance, SASS text of the tte instances)."""
    from repro_torch.kernels import build
    exe = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    rows, text = [], []
    for fn in re.split(r"\n\s+Function : ", out)[1:]:
        name = fn.split("\n", 1)[0].strip()
        m = re.search(r"tte_sample_kernelILi(\d)ELb(\d)ELb(\d)E", name)
        if not m:
            continue
        text.append(f"Function : {name}\n{fn}")
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         fn)
        ldg = [i for i, op in enumerate(ops) if op.startswith("LDG")]
        ex2 = [i for i, op in enumerate(ops) if op.startswith("MUFU.EX2")]
        first_ex2 = ex2[0] if ex2 else None
        rows.append({
            "instance": f"R={m.group(1)} VEC={m.group(2) == '1'} "
                        f"CLUSTER={m.group(3) == '1'}",
            "instructions": len(ops), "ldg": ldg, "first_ex2": first_ex2,
            "ldg_before_first_ex2": sum(1 for i in ldg
                                        if first_ex2 is None or i < first_ex2),
            "ex2": len(ex2)})
    return rows, "\n".join(text)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import tte_sample as tk
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    lib = str(build.build())
    build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    card = cs.nvidia_smi()
    print(f"card: {card}")
    rows = []
    for V in (1289, 256206):
        lg = torch.randn((16, V), generator=gen, device="cuda") * 3 - 8
        u = torch.rand((16, V), generator=gen, device="cuda")
        auto = tk.plan(16, V)
        for C in (CLUSTERS if V < 8192 else range(1, 9)):
            for pt in PER_THREAD:
                p = tk.plan(16, V, cluster=C, per_thread=pt)

                def fn():
                    return tk.tte_sample_cuda(lg, u, cluster=C, per_thread=pt)
                cold = V > 1289
                row = {"V": V, **p, "auto": p == auto,
                       "warm_ms": cs.device_ms(fn),
                       "cold_ms": (cs.cold_device_ms(fn, "tte_sample")
                                   if cold else None),
                       "cold_read_ms": (cs.cold_device_ms(
                           fn, "tte_sample", flush="read") if cold else None)}
                rows.append(row)
                txt = ("" if not cold else
                       f"  cold {row['cold_ms'] * 1e3:8.3f} us (read flush "
                       f"{row['cold_read_ms'] * 1e3:8.3f} us)")
                print(f"V={V:6d} cluster {C} per_thread {pt} threads "
                      f"{p['threads']:4d} resident clusters "
                      f"{p['resident_clusters']:4d}: warm "
                      f"{row['warm_ms'] * 1e3:8.3f} us{txt}"
                      f"{'  <- picked' if row['auto'] else ''}", flush=True)
    sass, text = sass_load_order(lib)
    print("SASS: global loads (LDG, instruction index) against the first "
          "MUFU.EX2 (expf)")
    for r in sass:
        print(f"  {r['instance']:32s} {r['instructions']:5d} instructions, "
              f"{len(r['ldg'])} LDG, {r['ldg_before_first_ex2']} before the "
              f"first EX2 (at {r['first_ex2']}); LDG at {r['ldg']}")
    record = {"card": card, "plans": rows, "sass": sass}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        with open(os.path.splitext(args.out)[0] + "_sass.txt", "w") as f:
            f.write(text)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
