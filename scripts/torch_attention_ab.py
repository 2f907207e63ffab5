#!/usr/bin/env python3
"""Two trees' attention and sampler kernels on one card, in turns.

    python3 scripts/torch_attention_ab.py --other DIR [--out FILE]

``DIR`` is another checkout of the repository (for example the parent
commit unpacked by ``git archive`` into a git-ignored directory).  The
script runs one worker process per turn, in the order other, this, this,
other; each builds its tree's kernels from that tree's sources and times
``flash_attention``, ``paged_decode_attention`` and ``tte_sample`` on the
same seeded inputs:

- flash: B 16, H 12, S 32, hd 10, causal, bf16 (the Delphi path's main
  prefill bucket) and B 4, S 256 (the longest bucket at max_context 256);
- paged: the ring viewed as a pool (B 16, Hkv 12, G 1, hd 10, W 256, bf16)
  with 576 valid tokens (slot b holds positions 0 .. 5 + 4b, about as many
  as the Delphi path's ring holds), and full (every slot 256 valid tokens);
- tte: 16 x 1289 fp32 (the Delphi path's tick, L2-warm) and 16 x 256,206
  (the zoo's largest vocabulary), warm and with a cold L2 (the kernel's
  device time alone, each call after a 128 MB write, or a 128 MB read that
  leaves no dirty lines to write back: ``chip_smoke``'s ``cold_device_ms``);
- the launch floor: PyTorch's one-element ``zero_()``.

Device time per call comes from ``torch.profiler`` and per-call time from
CUDA events, both as ``chip_smoke.py`` measures them; the host's time per
call (``host_ms``: the wrapper's Python and the launch, on the host clock
over 2,000 calls with no synchronise inside) is timed beside them.  Each
worker also hashes the flash kernel's outputs (index masks, no positions)
on seeded inputs at ``chip_smoke.py``'s FLASH_CASES, and the script says
whether the two trees' outputs are equal bit for bit.  Prints one table
and one JSON line; with ``--out`` the JSON also goes to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_ms(fn, iters: int = 2000) -> float:
    """Host wall time per call of ``fn`` over ``iters`` calls, the device
    synchronised before and not inside: what the caller's thread pays."""
    import time

    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def timed(cs, fn) -> dict:
    return dict(cs.measure(fn), host_ms=host_ms(fn))


def worker(tree: str) -> dict:
    """Time the kernels of ``tree``'s package (imported from tree/src)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                  # measurement helpers only
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import tte_sample as tk
    if not repro_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {}
    bf16 = torch.bfloat16
    for B, S in ((16, 32), (4, 256)):
        q, k, v = (torch.randn((B, S, 12, 10), generator=gen, device="cuda"
                               ).to(bf16).transpose(1, 2) for _ in range(3))
        res[f"flash B={B} S={S}"] = timed(
            cs, lambda: fk.flash_attention_cuda(q, k, v, causal=True))
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
        res[f"paged {note}"] = timed(cs, lambda: pk.paged_decode_attention_cuda(
            q, k, v, table, pos, step))
    for V in (1289, 256206):
        lg = torch.randn((16, V), generator=gen, device="cuda") * 3 - 8
        u = torch.rand((16, V), generator=gen, device="cuda")
        res[f"tte V={V}"] = timed(cs, lambda: tk.tte_sample_cuda(lg, u))
        for flush in ("write", "read") if V > 1289 else ():
            res[f"tte V={V} cold, {flush}"] = {
                "device_ms": cs.cold_device_ms(
                    lambda: tk.tte_sample_cuda(lg, u), "tte_sample",
                    flush=flush),
                "call_ms": None, "host_ms": None}
    z = torch.zeros(1, device="cuda")
    res["launch floor"] = timed(cs, lambda: z.zero_())
    return {"tree": os.path.abspath(tree), "card": cs.nvidia_smi(),
            "times": res, "flash_digests": flash_digests(cs, fk)}


def flash_digests(cs, fk) -> list:
    """sha256 of the flash kernel's output bytes at each of FLASH_CASES,
    on inputs drawn from a generator seeded per case."""
    import hashlib

    import torch
    out = []
    for i, (B, Hq, Hkv, S, hd, window, causal, dt, _note) in enumerate(
            cs.FLASH_CASES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1000 + i)
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, S, h, hd), generator=gen, device="cuda"
                               ).to(dtype).transpose(1, 2)
                   for h in (Hq, Hkv, Hkv))
        o = fk.flash_attention_cuda(q, k, v, causal=causal, window=window)
        raw = o.contiguous().view(torch.int16 if dt == "bfloat16"
                                  else torch.int32)
        out.append(hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other",
                    help="the other tree, timed in turns with this one")
    ap.add_argument("--tree", help=argparse.SUPPRESS)   # worker mode
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(worker(args.tree)), flush=True)
        return 0
    if not args.other:
        ap.error("--other DIR is required")
    runs = []
    for label, tree in (("other", args.other), ("this", ROOT),
                        ("this", ROOT), ("other", args.other)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree], capture_output=True, text=True,
                             check=False)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["label"] = label
        runs.append(rec)
    print(f"card: {runs[0]['card']}")
    print(f"{'kernel':24s}" + "".join(
        f"{r['label'] + ' device/call/host (ms)':>40s}" for r in runs))
    for name in runs[0]["times"]:
        cells = []
        for r in runs:
            m = r["times"][name]
            cells.append(" / ".join(
                "not measured" if m[key] is None else f"{m[key]:.5f}"
                for key in ("device_ms", "call_ms", "host_ms")))
        print(f"{name:24s}" + "".join(f"{c:>40s}" for c in cells))
    equal = all(r["flash_digests"] == runs[0]["flash_digests"] for r in runs)
    print(f"flash outputs at {len(runs[0]['flash_digests'])} cases bit-equal "
          f"across the trees: {equal}")
    record = {"runs": runs, "flash_bit_equal": equal}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
