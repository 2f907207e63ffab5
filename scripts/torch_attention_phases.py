#!/usr/bin/env python3
"""Where the time goes inside the two attention kernels, phase by phase.

    python3 scripts/torch_attention_phases.py [--out FILE]

Needs a CUDA card and ``nvcc``.  Copies ``src/repro_torch`` into the
git-ignored build directory (``src/repro_torch/kernels/_build/phases``),
inserts timestamps into that copy of ``csrc/paged_attention.cu`` and
``csrc/flash_attention.cu`` at the phase boundaries named below (each probe
reads a value of the phase before it, so the phase has finished), builds
the copy and runs each kernel at the shapes of
``scripts/torch_attention_ab.py``.  One thread per block records
``clock64()`` at each boundary (warp 0 of the paged kernel; the last warp of
a flash block, which owns the rows nearest the diagonal and so the most
keys) and ``%globaltimer`` at its start and end.  Prints, per shape, each
phase's median and largest SM cycles over the blocks, the median block's
time and the span from the first block's start to the last block's end (ns),
and one JSON line; with ``--out`` the JSON also goes to FILE.

The probes cost a few instructions each; the spans are a little longer than
the uninstrumented kernels' (compare with the A/B script's device times).
The anchors are lines of the kernels' sources: after an edit there, update
``PAGED_PROBES``/``FLASH_PROBES``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "src", "repro_torch", "kernels", "_build", "phases")
SLOTS = 16                                    # probes per block

HEADER = """
__device__ long long g_phase_{tag}[8192 * {slots}];
__device__ __forceinline__ long long phase_ns() {{
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
extern "C" int phase_read_{tag}(long long* dst, int n) {{
  return (int)cudaMemcpyFromSymbol(dst, g_phase_{tag}, n * sizeof(long long));
}}
"""

# (anchor, insert before (False) or after (True), value recorded); the
# first and last are globaltimer, the others clock64() plus a term that is
# 0 but reads the phase's result, so the probe waits for it
PAGED_PROBES = [
    ("                        int window, float scale, int words) {", True,
     "phase_ns()"),
    ("                        int window, float scale, int words) {", True,
     "clock64()"),
    ("      ok[t] = p >= 0 && p <= stp && p > stp - W && (window <= 0 || "
     "p > stp - window);\n    }", True, "clock64() + (ok[0] && stp == -7)"),
    ("        mx = fmaxf(mx, s[t]);\n      }", True,
     "clock64() + (mx == 12345.f)"),
    ("  // merge the lane groups of a warp", False,
     "clock64() + (acc[0][0] == 12345.f)"),
    ("  __syncthreads();\n\n  // merge the warps", False,
     "clock64() + (l[0] == 12345.f)"),
    ("  // merge the warps: one output element per thread\n", True,
     "clock64()"),
]
PAGED_END = ("BF16 ? REPRO_BF16 : REPRO_F32);\n  }\n", True)
PAGED_PHASES = ["step, table, pos", "K rows + scores",
                "V rows + online softmax", "warp merge", "barrier",
                "cross-warp merge + store"]

FLASH_PROBES = [
    ("  const int nw = blockDim.x >> 5;", False, "phase_ns()"),
    ("  const int nw = blockDim.x >> 5;", False, "clock64()"),
    ("  // K's columns past hd", False, "clock64()"),
    ("  float acc[ND][4];", False, "clock64() + (qa[0][0] == 12345u)"),
    ("    cp_async_wait_all();\n    __syncthreads();\n", True, "clock64()"),
    ("  // row sums over the quad", False,
     "clock64() + (acc[0][0] == 12345.f)"),
]
FLASH_END = ("__float2bfloat16_rn(acc[nd][e] * l[e >> 1]);\n    }\n", True)
FLASH_PHASES = ["first staging issued", "masks, Q read",
                "K/V landed + barrier", "products + softmax", "epilogue"]


def instrument(src: str, tag: str, index: str, thread: str, probes, end,
               anchor_header: str) -> str:
    """Insert the probes into one kernel source."""
    slot = f"g_phase_{tag}[({index}) * {SLOTS} + %d]"
    stmt = "\n  if (" + thread + ") " + slot + " = %s;\n"
    src = src.replace(anchor_header, HEADER.format(tag=tag, slots=SLOTS)
                      + anchor_header, 1)
    for n, (anchor, after, value) in enumerate(probes):
        if anchor not in src:
            raise RuntimeError(f"probe anchor not found: {anchor!r}")
        i = src.index(anchor) + (len(anchor) if after else 0)
        if after:   # several probes after one anchor keep their order
            while src.startswith("\n  if (" + thread, i):
                i = src.index(";\n", i) + 2
        src = src[:i] + stmt % (n, value) + src[i:]
    anchor, _ = end
    i = src.rindex(anchor) + len(anchor)
    n = len(probes)
    return (src[:i] + stmt % (n, "clock64()") + stmt % (n + 1, "phase_ns()")
            + src[i:])


def make_copy() -> str:
    shutil.rmtree(COPY, ignore_errors=True)
    pkg = os.path.join(COPY, "src", "repro_torch")
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(pkg, "kernels", "csrc")
    for name, tag, index, thread, probes, end, header in (
            ("paged_attention.cu", "p", "blockIdx.y * gridDim.x + blockIdx.x",
             "threadIdx.x == 0", PAGED_PROBES, PAGED_END,
             "constexpr int PD_THREADS"),
            ("flash_attention.cu", "f",
             "(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x",
             "threadIdx.x == blockDim.x - 32", FLASH_PROBES, FLASH_END,
             "constexpr int FM_MAX_WARPS")):
        path = os.path.join(csrc, name)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(instrument(text, tag, index, thread, probes, end, header))
    return os.path.join(COPY, "src")


def run(copy_src: str) -> dict:
    """Run in a process that imports the instrumented copy."""
    import ctypes

    import numpy as np
    import torch
    sys.path.insert(0, copy_src)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_attention as pk
    if not build.__file__.startswith(copy_src):
        raise RuntimeError(f"imported {build.__file__}, not the copy")
    lib = build.library()
    buf = np.zeros(8192 * SLOTS, np.int64)

    def phases(fn, nblocks, names, tag):
        reader = getattr(lib, f"phase_read_{tag}")
        reader.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        if reader(buf.ctypes.data, nblocks * SLOTS) != 0:
            raise RuntimeError("reading the probes failed")
        a = buf[:nblocks * SLOTS].reshape(nblocks, SLOTS)
        t0, t1 = a[:, 0], a[:, len(names) + 2]
        out = {"span_ns": int(t1.max() - t0.min()),
               "block_ns_median": float(np.median(t1 - t0))}
        for i, name in enumerate(names):
            d = a[:, i + 2] - a[:, i + 1]
            out[name] = {"median_cycles": float(np.median(d)),
                         "max_cycles": float(d.max())}
        return out

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16 = torch.bfloat16
    res = {}
    B, Hkv, hd, W = 16, 12, 10, 256
    k, v = (torch.randn((B, Hkv, W, hd), generator=gen, device="cuda"
                        ).to(bf16) for _ in range(2))
    q = torch.randn((B, Hkv, 1, hd), generator=gen, device="cuda").to(bf16)
    table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    j = torch.arange(W, device="cuda")
    for note, step in (("ring 576 valid", 5 + 4 * torch.arange(B)),
                       ("full ring", W + 44 + 37 * torch.arange(B))):
        step = step.to(device="cuda", dtype=torch.int32)
        pos = step[:, None] - torch.remainder(step[:, None] - j, W)
        pos = torch.where(pos >= 0, pos, -1).to(torch.int32)
        res[f"paged {note}"] = phases(
            lambda: pk.paged_decode_attention_cuda(q, k, v, table, pos, step),
            B * Hkv, PAGED_PHASES, "p")
    for B, S in ((16, 32), (4, 256)):
        qq, kk, vv = (torch.randn((B, S, 12, 10), generator=gen,
                                  device="cuda").to(bf16).transpose(1, 2)
                      for _ in range(3))
        res[f"flash B={B} S={S}"] = phases(
            lambda: fk.flash_attention_cuda(qq, kk, vv, causal=True),
            B * 12 * -(-S // 64), FLASH_PHASES, "f")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON here")
    ap.add_argument("--run", help=argparse.SUPPRESS)   # worker: the copy
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run(args.run)), flush=True)
        return 0
    copy_src = make_copy()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--run",
                          copy_src], capture_output=True, text=True,
                         check=False)
    if out.returncode != 0:
        print(out.stdout + out.stderr, file=sys.stderr)
        return out.returncode
    res = json.loads(out.stdout.strip().splitlines()[-1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(f"card: {card}")
    for shape, r in res.items():
        print(f"{shape}: span {r['span_ns']} ns, median block "
              f"{r['block_ns_median']:.0f} ns")
        for name, v in r.items():
            if isinstance(v, dict):
                print(f"  {name:28s} {v['median_cycles']:8.0f} cycles "
                      f"(largest {v['max_cycles']:.0f})")
    record = {"card": card, "phases": res}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
