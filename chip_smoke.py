#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
runs these phases; any failure exits non-zero:

1. environment: the card, its power limit, torch and CUDA versions, the
   kernel build (seconds and each kernel's registers and spills);
2. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at edge shapes, with the tolerance stated per case
   (``tte_sample`` also on ties across the blocks of a row's cluster, a
   +inf row, row-strided views and logits aligned otherwise than the
   uniforms, each in one launch; ``flash_attention`` also with position
   masks in fp32 and bf16 against ``suffix_prefill_attention_ref`` at
   ``tests/test_kernels.py``'s suffix cases and Delphi-2M's chunk, the
   padded rows exact zeros, and its index route bit-equal to the position
   route at a head chunk);
3. the Delphi path at full width: Delphi-2M (12 layers, d_model 120) from
   ``init_params(seed)`` in bf16, served by the ring-cache ``BatchedEngine``
   through ``repro_torch.launch.serve`` (32 synthetic patient prompts, 16
   slots, ``max_new`` 48).  Every request must finish, the engine must make
   exactly one device->host copy per tick and per admission batch, and each
   of the path's three kernels must have launched on it (launch counts are
   zeroed just before it and read just after it);
3b. the Mamba2 path at full width: Mamba2-780M (48 layers, d_model 1536,
   V 50280) from ``init_params(seed)`` in bf16 on ``BatchedEngine(slots=8)``
   with generator uniforms, 16 requests of seeded random token ids (prompts
   of 96-1024 tokens), ``max_new`` 32.  Every request must get its 32
   tokens, one host copy per tick and per admission, every prefill shape
   ``(1, S)``, and ``ssd_intra`` must launch once per layer per admission
   (counts zeroed just before, read just after);
3c. the paged Delphi path at full width: the same model, prompts and seed
   served through ``repro_torch.launch.serve --cache paged`` (16 slots,
   ``max_context`` 256, 16-token blocks, the dense-equivalent pool of 257
   blocks).  Every request must finish, one host copy per tick and per
   admission batch, ``paged_decode_attention`` 12 launches a tick, flash
   and ``tte_sample`` launched, the pool drained to no used block; the
   trajectories must equal phase 3's bit for bit (the same generator
   draws through the same arithmetic);
3d. futures at full width: a prefix-cached paged engine (16 slots)
   ``sample_futures`` 16 futures of each of 4 synthetic patients
   (``max_new`` 48, generator uniforms), each patient twice; the second
   time the parent admits by reference with no prefill.  Forks, copies on
   write, shared blocks and prefix hits are printed; no block or refcount
   may be left after ``drop_prefix_cache()``;
3e. mixed long/short traffic at full width (``benchmarks/run.py``'s
   ``bench_chunked_prefill``): Delphi-2M bf16 on a paged engine (12 slots,
   ``max_context`` 256, 192 blocks), 6 short requests (6-event prompts, 48
   new events) and 6 long ones (200-event prompts, 4 new), one long every 8
   steps from step 3; monolithic and chunked prefill (64 tokens a step) in
   turns, twice each.  Events/s and the short requests' p50/p95 per-event
   latency per run; every request finishes, the pool drains, host copies =
   ticks + admission batches; the chunked run launches the position-masked
   flash 12 times a chunk;
3f. partial-hit suffix prefill: a prefix-cached chunked engine serves a
   200-event prompt, then a 240-event prompt extending it, which must
   prefill only its suffix (``suffix_tokens_saved`` = the 192 matched
   tokens);
3g. HTTP serving at full width: Delphi-2M bf16 on ``EngineBackend`` (phase
   3d's knobs: 16 slots, ``max_context`` 256, paged, prefix cache) behind
   ``InferenceServer``, the engine on its background loop.  Phase 3's 32
   prompts over ``/v1/generate`` from 8 concurrent ``RemoteBackend``
   clients with generator uniforms (48 new events), 8 ``/v1/stream``
   calls, phase 3d's 4 patients x 16 futures over ``/v1/futures`` and 4
   ``/v1/risk`` calls.  Every request answered with no error, host copies
   = ticks + admission batches, the three Delphi kernels launched on the
   HTTP run; events/s in turns (HTTP, in-process background twice, HTTP),
   the SSE time to first event (p50, p95) and the device idle share of one
   HTTP run; the streams' time to first event also against a server with
   the stdlib's listen backlog of 5 (the JAX package's), in turns.  On a
   fresh server and a fresh twin engine, one request at a
   time under injected uniforms: ``/v1/generate`` == the twin's generate
   bit for bit, ``/v1/stream`` == it, ``/v1/futures`` ==
   ``ring_reference_futures``; ``/v1/risk`` == ``core/risk.py`` on the
   card's logits.  Then the server's CLI boots as a subprocess (fp32 on
   the card), answers ``/v1/healthz`` and a generate, and exits 0 on
   SIGINT;
3h. the router on one card: ``RouterServer`` over 2 in-process paged
   replicas; each of phase 3d's patients asked for futures twice, the
   second visit routed by affinity to the replica holding its prefix
   (whose prefix hits rise); one replica drained under 16 concurrent
   requests, every one answered; on a fresh router and a fresh direct
   server, router ``/v1/generate`` == the direct server's bit for bit;
4. end-to-end parity in fp32: the same weights and injected uniforms through
   the engine on the card (kernels) and on the CPU (plain versions), for
   Delphi-2M and for Mamba2-780M at full width cut to 4 layers; the card's
   trajectories are held step by step against the CPU model
   (``repro_torch.core.parity``).  Then, on the card alone with injected
   uniforms, in fp32 and in bf16: ring == paged bit for bit (tokens and
   fp32 ages, an over-width prompt included), and ``sample_futures`` on
   the ring, the paged and the prefix-cached paged engine == the port's
   ``ring_reference_futures`` bit for bit; the paged engine == the port's
   ``chunked_reference_trajectory`` bit for bit unchunked (an unbounded
   budget), chunked at one block and at 64 tokens, on a partial prefix hit
   (``matched_tokens``), futures forked from a parent prefilled in one
   chunk == the unchunked fork's and from one prefilled in 7 chunks == the
   oracle per future; ``monte_carlo_risk`` over phase 3d's futures equals the
   host aggregation exactly, and analytic risk on the card the CPU's;
5. times at the main paths' shapes: each kernel, its plain version, one
   PyTorch library call where one computes the same function (a yardstick
   the port never calls), and the bound from bytes and operations (for
   ``ssd_intra`` at a 1024- and a 128-token prompt, both terms printed;
   ``flash_attention`` also at B 4, S 256, ``paged_decode_attention``
   also on a full ring and on the paged pool (the ring's tokens in 16-token
   blocks scattered over 257, unused table columns -1), ``tte_sample``
   also at V 256,206 with a cold L2: the kernel's device time alone after
   a 128 MB write and after a 128 MB
   read, warm beside them), beside the launch floor (a one-element
   ``zero_()``, the least a launch costs on the device);
   device time per call from ``torch.profiler`` and per-call time from CUDA
   events (the ``kernels`` line's ``ms`` is the device time); then each path
   once more under the profiler (device busy time, idle share, top kernels,
   and the Mamba2 path's ``ssd_intra`` total), the paged, futures and both
   mixed-traffic paths included; ``flash_attention`` also with position
   masks at phase 3e's chunk (64 queries over 128 + 64 keys), its library
   call SDPA with the boolean mask built from the positions.

The ``kernels`` line holds the four kernels and, as a fifth row, the flash
kernel's position-masked route with its launches on the chunked drive of
phase 3e.  The last lines are the ``kernels`` JSON line, the card's name
and power limit (``nvidia-smi``), and the result line ``{"ok": true,
"device": ...}``.  A copy of all numbers goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rates of the H100 SXM
              "float32": 495e12,   # (TF32 for fp32 inputs)
              # fp32 on the CUDA cores (NVIDIA's data sheet)
              "float32_simt": 67e12,
              # fp32-accurate products on the tensor cores: three TF32
              # passes (hi*hi + hi*lo + lo*hi) per product
              "float32_3xtf32": 495e12 / 3}
SEED = 0
DEVICE = "cuda"

REPLACES = {
    "tte_sample": "src/repro/kernels/tte_sample.py:64",
    "flash_attention": "src/repro/kernels/flash_attention.py:86",
    "paged_decode_attention": "src/repro/kernels/paged_attention.py:82",
    "ssd_intra": "src/repro/kernels/ssd_scan.py:50",
}
SOURCES = {
    "tte_sample": "src/repro_torch/kernels/csrc/tte_sample.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_decode_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "ssd_intra": "src/repro_torch/kernels/csrc/ssd_intra.cu",
}
DELPHI_KERNELS = ("tte_sample", "flash_attention", "paged_decode_attention")
MAMBA_SLOTS, MAMBA_REQUESTS, MAMBA_MAX_NEW = 8, 16, 32


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def _tol(dtype) -> float:
    import torch
    return 2e-5 if dtype == torch.float32 else 2e-2


def check_tte(gen) -> float:
    """Events equal except at near-ties (best and second-best t within
    1e-6 relative); t_min within 1e-6 relative.  The ties cases must give
    the lowest index: equal t everywhere, -0 (u = 1) from index 7 on, and
    across the blocks of a row's cluster (V 256,206: -0 from an index j in
    the third of eight ranks, +0 (l = 200) after it; +0 at j against -0
    in the first rank); a +inf row (l = -100) gives event 0, t_min inf.
    Row-strided views and logits aligned otherwise than the uniforms go
    through the same kernel.  Returns the largest relative t_min error at
    the main path's shape."""
    import torch
    from repro_torch.core.sampler import sample_waiting_times
    from repro_torch.kernels import ref
    from repro_torch.kernels import tte_sample as k
    dev = DEVICE
    Vl = 256206
    j = int(Vl * 2.5 / 8)
    main_err = 0.0
    for B, V, kind in [(16, 1289, "main"), (3, Vl, "large V"),
                       (2, 100, "ragged V"), (1, 5, "tiny V"),
                       (4, 1289, "ties"), (5, Vl, "ties across ranks"),
                       (2, 1289, "+inf row"), (6, 1289, "strided rows"),
                       (6, Vl, "strided rows"), (6, 1289, "misaligned u"),
                       (6, Vl, "misaligned u")]:
        logits = torch.randn((B, V + 37), generator=gen, device=dev) * 3 - 4
        u = torch.rand((B, V + 37), generator=gen, device=dev)
        if kind == "strided rows":       # big[:, :V] of (B, V + 37)
            logits, u = logits[:, :V], u[:, :V]
        elif kind == "misaligned u":     # 4-byte words, not 16-byte slots
            logits, u = logits[:, 1:V + 1], u[:, :V]
        else:
            logits = logits[:, :V].contiguous()
            u = u[:, :V].contiguous()
        want = None
        if kind == "ties":      # every t equal: the lowest index must win
            logits = torch.zeros_like(logits)
            u = torch.full_like(u, 0.3)
            u[1, 7:] = 1.0        # t = -0 from index 7 on
            want = [0, 7, 0, 0]
        elif kind == "ties across ranks":
            logits = torch.zeros_like(logits)
            u = torch.full_like(u, 0.3)
            u[1, j:] = 1.0
            u[2, j:j + 5000] = 1.0
            logits[2, j + 5000:] = 200.0
            logits[3] = -100.0
            logits[4, j] = 200.0
            u[4, j + 9] = 1.0
            u[4, j - 70000] = 1.0
            want = [0, j, j, 0, j - 70000]
        elif kind == "+inf row":
            logits = torch.full_like(logits, -100.0)
            u = u.clamp(1e-3, 0.999)
            want = [0, 0]
        n0 = k.launches
        e1, t1 = k.tte_sample_cuda(logits, u)
        e2, t2 = ref.tte_sample_ref(logits, u)
        torch.cuda.synchronize()
        if k.launches != n0 + 1:
            raise AssertionError(f"tte_sample {kind}: {k.launches - n0} "
                                 f"launches for one call")
        t_all = sample_waiting_times(logits, u)
        bad = (e1 != e2).nonzero().flatten().tolist()
        for b in bad:
            g1 = float(t_all[b, e1[b].long()])
            g2 = float(t_all[b, e2[b].long()])
            if abs(g1 - g2) > 1e-6 * abs(g2):
                raise AssertionError(
                    f"tte_sample {kind} row {b}: event {int(e1[b])} vs "
                    f"{int(e2[b])}, t {g1} vs {g2}")
        if want is not None and e1.tolist() != want:
            raise AssertionError(f"tte_sample {kind}: {e1.tolist()}, "
                                 f"want {want}")
        if kind == "+inf row" and not bool(torch.isinf(t1).all()):
            raise AssertionError(f"tte_sample +inf row: t_min {t1.tolist()}")
        fin = torch.isfinite(t2)
        if not bool((torch.isfinite(t1) == fin).all()):
            raise AssertionError(f"tte_sample {kind}: t_min {t1.tolist()} vs"
                                 f" {t2.tolist()}")
        rel = float(((t1 - t2)[fin].abs()
                     / t2[fin].abs().clamp_min(1e-30)).max()) \
            if bool(fin.any()) else 0.0
        if rel > 1e-6:
            raise AssertionError(f"tte_sample {kind}: t_min rel err {rel}")
        if kind == "main":
            main_err = rel
        log(f"  tte_sample B={B} V={V} ({kind}, plan "
            f"{k.plan(B, V)}): events differ at {len(bad)} near-ties, t_min "
            f"rel err {rel:.3g} (tol 1e-6)")
    return main_err


FLASH_CASES = [
    # (B, Hq, Hkv, S, hd, window, causal, dtype name, note)
    (16, 12, 12, 8, 10, None, True, "bfloat16", "main S=8"),
    (16, 12, 12, 16, 10, None, True, "bfloat16", "main S=16"),
    (16, 12, 12, 32, 10, None, True, "bfloat16", "main S=32"),
    (16, 12, 12, 64, 10, None, True, "bfloat16", "main S=64"),
    (4, 12, 12, 256, 10, None, True, "bfloat16", "main S=256"),
    (16, 12, 12, 64, 10, None, True, "float32", "fp32 S=64"),
    (2, 12, 12, 256, 10, 100, True, "float32", "window"),
    (2, 12, 12, 200, 10, None, True, "float32", "ragged S"),
    (2, 4, 2, 256, 64, None, True, "float32", "GQA hd=64"),
    (1, 2, 2, 384, 64, 100, True, "float32", "window hd=64"),
    (2, 8, 2, 77, 64, 16, True, "bfloat16", "ragged window GQA bf16"),
    (1, 2, 2, 130, 128, None, True, "float32", "hd=128 ragged"),
    (1, 2, 2, 128, 64, None, False, "float32", "bidirectional"),
    (2, 12, 12, 256, 10, 100, True, "bfloat16", "window bf16"),
    (2, 12, 12, 40, 10, None, False, "bfloat16", "bidirectional bf16"),
    (2, 4, 4, 96, 32, None, True, "bfloat16", "hd=32 bf16"),
    (2, 4, 2, 70, 40, None, True, "bfloat16", "hd=40 bf16 (padded to 64)"),
    (2, 4, 2, 50, 12, None, True, "bfloat16", "hd=12 bf16 (8-byte staging)"),
    (2, 4, 2, 50, 9, None, True, "bfloat16", "odd hd=9 bf16 (by element)"),
    (2, 4, 2, 256, 64, None, True, "bfloat16", "GQA hd=64 bf16"),
    (1, 2, 2, 384, 64, 100, True, "bfloat16", "window hd=64 bf16"),
    (1, 2, 2, 130, 128, None, True, "bfloat16", "hd=128 ragged bf16"),
    (1, 2, 2, 128, 64, None, False, "bfloat16", "bidirectional hd=64 bf16"),
]


def check_flash(gen) -> float:
    """fp32 atol 2e-5, bf16 atol 2e-2 against the plain version in fp32 on
    the same (rounded) inputs.  q/k/v are transposed views of (B, S, H, hd)
    tensors, as the model passes them.  Returns the largest error over the
    bf16 cases at the main path's widths."""
    import torch
    from repro_torch.kernels import flash_attention as k
    from repro_torch.kernels import ref
    main_err = 0.0
    for B, Hq, Hkv, S, hd, window, causal, dt, note in FLASH_CASES:
        dtype = getattr(torch, dt)

        def rnd(h):
            return torch.randn((B, S, h, hd), generator=gen, device=DEVICE
                               ).to(dtype).transpose(1, 2)
        q, kk, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
        out = k.flash_attention_cuda(q, kk, v, causal=causal, window=window)
        r = ref.flash_attention_ref(q.float(), kk.float(), v.float(),
                                    causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - r).abs().max())
        tol = _tol(dtype)
        if not err <= tol:
            raise AssertionError(f"flash_attention {note}: err {err} > {tol}")
        if note.startswith("main"):
            main_err = max(main_err, err)
        log(f"  flash_attention {note} (B={B} Hq={Hq} Hkv={Hkv} S={S} "
            f"hd={hd} window={window} causal={causal} {dt}): max abs err "
            f"{err:.3g} (tol {tol})")
    return main_err


SUFFIX_CASES = [
    # (B, Sc, C, Hkv, G, hd, window, note): tests/test_kernels.py's
    # SUFFIX_CASES, then Delphi-2M's chunk of phase 3e
    (1, 16, 0, 1, 1, 32, None, "chunk at the prompt head"),
    (2, 16, 32, 2, 2, 32, None, "GQA mid-prompt chunk"),
    (1, 8, 24, 1, 4, 64, None, "strong GQA"),
    (2, 16, 16, 2, 1, 16, 12, "sliding window"),
    (1, 16, 32, 2, 2, 32, None, "GQA hd=32"),
    (1, 64, 128, 12, 1, 10, None, "main: Delphi-2M chunk, 64 over 128"),
]


def check_flash_positions(gen) -> float:
    """The position-masked routes (``ops.suffix_prefill_attention``: the
    context and the chunk concatenated, the flash kernel with q_pos/k_pos)
    in fp32 and bf16 against ``suffix_prefill_attention_ref`` in fp32 on
    the same (rounded) inputs, fp32 atol 2e-5, bf16 atol 2e-2: context
    padded with trash positions (-1) and the chunk's padded tail (-1),
    whose rows must come out as exact zeros.  Then the index route against
    the position route at a head chunk with no context (Delphi's heads, the
    main path's buckets): bit for bit on the valid rows.  Returns the
    largest error at Delphi-2M's chunk in bf16."""
    import torch
    from repro_torch.kernels import ops, ref
    main_err = 0.0
    for B, Sc, C, Hkv, G, hd, window, note in SUFFIX_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=DEVICE
                                   ).to(dtype)
            q = rnd(B, Sc, Hkv * G, hd)
            k, v = rnd(B, Sc, Hkv, hd), rnd(B, Sc, Hkv, hd)
            ck, cv = rnd(B, C, Hkv, hd), rnd(B, C, Hkv, hd)
            n_ctx, n_q = max(C - 3, 0), Sc - 2
            cpos = torch.full((B, C), -1, dtype=torch.int32, device=DEVICE)
            cpos[:, :n_ctx] = torch.arange(n_ctx, device=DEVICE)
            qpos = torch.full((B, Sc), -1, dtype=torch.int32, device=DEVICE)
            qpos[:, :n_q] = n_ctx + torch.arange(n_q, device=DEVICE)
            out = ops.suffix_prefill_attention(q, k, v, ck, cv, qpos, cpos,
                                               window=window, q_per_kv=G)
            r = ref.suffix_prefill_attention_ref(
                q.float(), k.float(), v.float(), ck.float(), cv.float(),
                qpos, cpos, window=window)
            torch.cuda.synchronize()
            err = float((out[:, :n_q].float() - r[:, :n_q]).abs().max())
            tol = _tol(dtype)
            if not err <= tol:
                raise AssertionError(f"flash_attention positions {note}: err "
                                     f"{err} > {tol}")
            if bool(out[:, n_q:].any()):
                raise AssertionError(f"flash_attention positions {note}: a "
                                     f"padded row is not zeros")
            if note.startswith("main") and dtype == torch.bfloat16:
                main_err = err
            log(f"  flash_attention positions {note} (B={B} Sc={Sc} C={C} "
                f"Hkv={Hkv} G={G} hd={hd} window={window} "
                f"{str(dtype)[6:]}): max abs err {err:.3g} (tol {tol}); "
                f"{Sc - n_q} padded rows exact zeros")
    for dtype in (torch.float32, torch.bfloat16):
        for S, n in ((8, 5), (16, 16), (32, 21), (64, 64), (256, 200)):
            q, k, v = (torch.randn((1, S, 12, 10), generator=gen,
                                   device=DEVICE).to(dtype) for _ in range(3))
            pos = torch.full((1, S), -1, dtype=torch.int32, device=DEVICE)
            pos[:, :n] = torch.arange(n, device=DEVICE)
            empty = q.new_zeros((1, 0, 12, 10))
            by_pos = ops.suffix_prefill_attention(q, k, v, empty, empty, pos,
                                                  pos[:, :0])
            by_index = ops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2)).transpose(1, 2)
            if not torch.equal(by_pos[:, :n], by_index[:, :n]):
                raise AssertionError(f"flash_attention: the position route "
                                     f"differs from the index route at S={S} "
                                     f"{dtype}")
    log("  flash_attention: index route == position route bit for bit at a "
        "head chunk (Hkv 12, hd 10, S 8/16/32/64/256, fp32 and bf16)")
    return main_err


def ring_inputs(gen, B, Hkv, G, hd, W, dtype, steps, padded=True):
    """A ring cache as the engine holds it, viewed as a pool of one block
    per slot: slot b has written positions 0..steps[b] at ring slot p % W;
    with ``padded`` slot 0 also has two prompt positions masked (pos -1, as
    after a right-padded prefill)."""
    import torch
    k = torch.randn((B, Hkv, W, hd), generator=gen, device=DEVICE).to(dtype)
    v = torch.randn((B, Hkv, W, hd), generator=gen, device=DEVICE).to(dtype)
    q = torch.randn((B, Hkv * G, hd), generator=gen, device=DEVICE).to(dtype)
    pos = torch.full((B, W), -1, dtype=torch.int32)
    for b, s in enumerate(steps):
        for p in range(max(0, s - W + 1), s + 1):
            pos[b, p % W] = p
    if padded:
        pos[0, 1:3] = -1
    table = torch.arange(B, dtype=torch.int32)[:, None]
    step = torch.tensor(steps, dtype=torch.int32)
    return q, k, v, table.to(DEVICE), pos.to(DEVICE), step.to(DEVICE)


def paged_inputs(gen, B, Hkv, G, hd, bs, nbs, dtype, *, wrap=False,
                 empty_slot=False):
    """A true paged pool: each slot's blocks are scattered over the pool in
    random order, unallocated table entries are -1, and with ``wrap`` the
    positions have wrapped past the ring width, with every other one left
    stale (evicted: at or below step - W)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,),
                                                  generator=gen,
                                                  device=DEVICE)))
    W = nbs * bs
    NB = 1 + B * nbs
    perm = rng.permutation(np.arange(1, NB))
    table = np.full((B, nbs), -1, np.int32)
    pos = np.full((NB, bs), -1, np.int32)
    step = np.zeros((B,), np.int32)
    nxt = 0
    for b in range(B):
        if empty_slot and b == B - 1:
            break
        n_tok = int(rng.integers(1, W))
        off = W if wrap else 0
        step[b] = n_tok - 1 + off
        for jb in range(-(-n_tok // bs)):
            blk = int(perm[nxt])
            nxt += 1
            table[b, jb] = blk
            for o in range(bs):
                p = jb * bs + o
                if p < n_tok:
                    pos[blk, o] = p + off
                    if wrap and o % 2 == 0:
                        pos[blk, o] -= W
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, hd))).to(dtype)
    k = torch.from_numpy(rng.standard_normal((NB, Hkv, bs, hd))).to(dtype)
    v = torch.from_numpy(rng.standard_normal((NB, Hkv, bs, hd))).to(dtype)
    return tuple(t.to(DEVICE) for t in (
        q, k, v, torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(step)))


def check_paged(gen) -> float:
    """fp32 atol 2e-5, bf16 atol 2e-2 against the plain version in fp32 on
    the same (rounded) inputs.  Returns the largest error of the ring-as-
    pool cases at the main path's widths (bf16)."""
    import torch
    from repro_torch.kernels import ops, ref
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("main: ring as pool, bs=256", ring_inputs(
            gen, 16, 12, 1, 10, 256, bf16,
            [40, 300, 255, 256, 1000, 3, 0, 511] + [20 + 9 * i for i in range(8)]),
         None),
        ("ring as pool fp32", ring_inputs(
            gen, 16, 12, 1, 10, 256, f32, [17 * i + 5 for i in range(16)]),
         None),
        ("ring, every step below 128", ring_inputs(
            gen, 16, 12, 1, 10, 256, bf16, [8 * i + 3 for i in range(16)]),
         None),
        ("ring full, every step >= 255", ring_inputs(
            gen, 16, 12, 1, 10, 256, bf16, [255 + 37 * i for i in range(16)],
            padded=False), None),
        ("paged bs=4 G=4 hd=64", paged_inputs(gen, 3, 2, 4, 64, 4, 8, f32),
         None),
        ("paged bs=16 wrapped stale G=2 window", paged_inputs(
            gen, 4, 2, 2, 32, 16, 4, f32, wrap=True), 20),
        ("paged bs=16 wrapped bf16 G=4 window", paged_inputs(
            gen, 4, 2, 4, 16, 16, 4, bf16, wrap=True), 20),
        ("paged bs=16 wrapped bf16 G=8 hd=128", paged_inputs(
            gen, 2, 2, 8, 128, 16, 4, bf16, wrap=True), None),
        ("paged bs=16 odd hd=9 bf16", paged_inputs(
            gen, 2, 2, 2, 9, 16, 2, bf16), None),
        ("paged bs=4 empty slot", paged_inputs(
            gen, 3, 2, 2, 16, 4, 4, f32, empty_slot=True), None),
    ]
    main_err = 0.0
    for note, (q, k, v, table, pos, step), window in cases:
        B, Hq, hd = q.shape
        Hkv = k.shape[1]
        out = ops.paged_decode_attention(q, k, v, table, pos, step,
                                         window=window)
        r = ref.paged_decode_attention_ref(
            q.float().reshape(B, Hkv, Hq // Hkv, hd), k.float(), v.float(),
            table, pos, step, window=window).reshape(B, Hq, hd)
        torch.cuda.synchronize()
        err = float((out.float() - r).abs().max())
        tol = _tol(q.dtype)
        if not err <= tol:
            raise AssertionError(f"paged_decode_attention {note}: err {err}"
                                 f" > {tol}")
        if "empty" in note and float(out[-1].abs().max()) != 0.0:
            raise AssertionError("paged_decode_attention: an empty slot "
                                 "must give zeros")
        if note.startswith("main"):
            main_err = err
        log(f"  paged_decode_attention {note} (B={B} Hkv={Hkv} "
            f"G={Hq // Hkv} hd={hd} bs={k.shape[2]} nbs={table.shape[1]} "
            f"{str(q.dtype)[6:]}): max abs err {err:.3g} (tol {tol})")
    return main_err


SSD_CASES = [
    # (b, C, Q, H, P, N, xdt dtype, B/C dtype, B/C shared by the heads,
    #  largest decrement of cum per step, note)
    (1, 1, 16, 1, 8, 8, "float32", "float32", False, 0.2, "Q16 P8 N8"),
    (4, 3, 32, 1, 16, 32, "float32", "float32", False, 0.2, "Q32 P16 N32"),
    (2, 2, 128, 1, 64, 128, "float32", "float32", False, 0.2,
     "production tile"),
    (2, 2, 64, 1, 32, 64, "bfloat16", "bfloat16", False, 0.2, "bf16 Q64"),
    (2, 3, 32, 16, 32, 16, "float32", "float32", True, 0.2, "reduced mamba2"),
    (1, 8, 128, 48, 64, 128, "float32", "bfloat16", True, 0.2,
     "main: 1024-token prompt"),
    (1, 1, 128, 48, 64, 128, "float32", "bfloat16", True, 0.2,
     "one-chunk prompt (128 tokens)"),
    (2, 2, 128, 4, 64, 128, "float32", "bfloat16", False, 0.2,
     "bf16 B/C per head"),
    (1, 2, 128, 8, 64, 128, "float32", "bfloat16", True, 2.0,
     "steep decay (L underflows to 0)"),
    (2, 2, 128, 8, 64, 128, "float32", "float32", True, 0.2,
     "fp32 B/C shared by the heads"),
]


def check_ssd(gen) -> float:
    """atol 1e-4 (tests/test_kernels.py's SSD tolerance) against the plain
    version in fp32 on the same (rounded) inputs, drawn as test_kernels.py
    draws them (N(0, 1) tiles, cum of U(0, 0.2) decrements; U(0, 2.0) in
    the steep case, where L underflows to 0 and no NaN may appear).
    Returns the error at the main path's tile (48 heads sharing bf16 B/C by
    a 0 stride, fp32 xdt, as the model passes them)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as k
    main_err = 0.0
    for b, C, Q, H, P, N, dx, dbc, shared, step, note in SSD_CASES:
        def rnd(*shape, dt):
            return torch.randn(shape, generator=gen, device=DEVICE
                               ).to(getattr(torch, dt))
        hb = 1 if shared else H
        xdt = rnd(b, C, Q, H, P, dt=dx)
        Bm = rnd(b, C, Q, hb, N, dt=dbc).expand(b, C, Q, H, N)
        Cm = rnd(b, C, Q, hb, N, dt=dbc).expand(b, C, Q, H, N)
        cum = -torch.cumsum(step * torch.rand((b, C, Q, H), generator=gen,
                                              device=DEVICE), dim=2)
        y, st = k.ssd_intra_cuda(xdt, Bm, Cm, cum)
        yr, sr = ref.ssd_intra_ref(xdt.transpose(2, 3), Bm.transpose(2, 3),
                                   Cm.transpose(2, 3), cum.transpose(2, 3))
        torch.cuda.synchronize()
        err = max(float((y - yr.transpose(2, 3)).abs().max()),
                  float((st - sr).abs().max()))
        if not (err <= 1e-4 and bool(y.isfinite().all())
                and bool(st.isfinite().all())):
            raise AssertionError(f"ssd_intra {note}: err {err} > 1e-4")
        if note.startswith("main"):
            main_err = err
        log(f"  ssd_intra {note} (b={b} C={C} Q={Q} H={H} P={P} N={N} xdt "
            f"{dx}, B/C {dbc}{', shared' if shared else ''}, cum steps "
            f"<= {step}): max abs err "
            f"{err:.3g} (tol 1e-4)")
    return main_err


# ---------------------------------------------------------------------------
# phase 3 / 4: the serving paths
# ---------------------------------------------------------------------------
def serve_args(requests: int, max_new: int, cache: str = "ring"):
    from repro_torch.launch import serve as launch
    return launch.parse_args(["--arch", "delphi-2m", "--requests",
                              str(requests), "--slots", "16", "--max-new",
                              str(max_new), "--seed", str(SEED),
                              "--cache", cache, "--device", DEVICE])


def main_path(cache: str = "ring") -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    cfg_v = 1289
    # first use of cuBLAS and the allocator, through the same entry point
    launch.serve(serve_args(4, 4, cache))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = launch.serve(serve_args(32, 48, cache))
    counts = ops.launch_counts()
    eng, done = out["engine"], out["done"]
    if len(done) != 32 or not all(r.done and r.error is None for r in done):
        raise AssertionError(f"{len(done)} of 32 requests completed")
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    for name in DELPHI_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the Delphi path")
    for r in done:
        toks = np.asarray(r.out_tokens)
        ages = np.asarray(r.out_ages, np.float64)
        if len(toks) > 48 or (len(toks) and (toks.min() < 0
                                             or toks.max() >= cfg_v)):
            raise AssertionError(f"bad tokens {toks}")
        if not (np.isfinite(ages).all() and (ages <= 85.0).all()
                and (np.diff(ages) >= 0).all()):
            raise AssertionError(f"bad ages {ages}")
    if cache == "paged":
        if counts["paged_decode_attention"] != 12 * eng.ticks:
            raise AssertionError(
                f"paged_decode_attention launched "
                f"{counts['paged_decode_attention']} times in {eng.ticks} "
                f"ticks (12 a tick)")
        if eng.allocator.used or eng.pool._refs or eng.preemptions:
            raise AssertionError(f"pool not drained: {eng.pool_stats()}")
    return {"engine": eng, "done": done, "seconds": out["seconds"],
            "events": out["events"], "launches": counts}


FUTURES_PATIENTS, FUTURES_N, FUTURES_MAX_NEW = 4, 16, 48


def futures_patients():
    """The first halves of 4 synthetic patient histories (seeded)."""
    from repro_torch.data import SimulatorConfig, generate_dataset
    trajs, _ = generate_dataset(SimulatorConfig(
        n_train=FUTURES_PATIENTS, n_val=1, seed=SEED + 23))
    return [(t[:max(len(t) // 2, 1)], a[:max(len(t) // 2, 1)])
            for t, a in trajs]


def futures_run(params, cfg, patients):
    """16 futures of each patient, each patient twice, on one
    prefix-cached paged engine with generator uniforms; returns (engine,
    children by call, seconds ending in a device synchronise)."""
    import torch
    from repro_torch.serve import BatchedEngine
    eng = BatchedEngine(params, cfg, slots=16, max_context=cfg.max_seq_len,
                        cache="paged", block_size=16, prefix_cache=True,
                        seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = [eng.sample_futures(t, a, n=FUTURES_N, max_new=FUTURES_MAX_NEW)
             for _ in range(2) for t, a in patients]
    torch.cuda.synchronize()
    return eng, calls, time.perf_counter() - t0


def futures_path() -> dict:
    """Phase 3d: futures at full width (counts zeroed just before the run
    and read just after)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    cfg = get_config("delphi-2m")
    params = init_params(cfg, seed=SEED, device=DEVICE)
    patients = futures_patients()
    ops.reset_launch_counts()
    eng, calls, sec = futures_run(params, cfg, patients)
    counts = ops.launch_counts()
    kids = [k for c in calls for k in c]
    if len(kids) != 2 * FUTURES_PATIENTS * FUTURES_N or not all(
            k.done and k.error is None for k in kids):
        raise AssertionError("a future did not finish")
    for k in kids:
        ages = np.asarray(k.out_ages, np.float64)
        if not (len(k.out_tokens) <= FUTURES_MAX_NEW
                and np.isfinite(ages).all() and (np.diff(ages) >= 0).all()):
            raise AssertionError(f"bad future {k.out_tokens} {k.out_ages}")
    st = eng.pool_stats()
    pfx = st["prefix_cache"]
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    if (st["forks"] != 2 * FUTURES_PATIENTS or pfx["hits"] != FUTURES_PATIENTS
            or len(eng.prefill_shapes) > FUTURES_PATIENTS
            or counts["flash_attention"] != 12 * FUTURES_PATIENTS
            or counts["paged_decode_attention"] != 12 * eng.ticks
            or counts["tte_sample"] == 0):
        raise AssertionError(f"futures path: {st}, launches {counts}, "
                             f"prefill shapes {eng.prefill_shapes}")
    bs = eng.block_size
    unshared = FUTURES_N * sum(-(-len(t) // bs) for t, _ in patients)
    events = sum(len(k.out_tokens) for k in kids)
    freed = eng.drop_prefix_cache()
    if eng.allocator.used or eng.pool._refs or (eng._table != -1).any():
        raise AssertionError(f"leaked blocks after drop_prefix_cache: "
                             f"{eng.allocator.used} used, refs "
                             f"{eng.pool._refs}")
    return {"engine": eng, "seconds": sec, "events": events,
            "launches": counts, "stats": st, "unshared_blocks": unshared,
            "index_blocks_freed": freed, "params": params, "cfg": cfg,
            "patients": patients, "calls": calls,
            "prompt_lengths": [len(t) for t, _ in patients]}


# phase 3e: mixed long/short traffic (benchmarks/run.py's
# bench_chunked_prefill at Delphi-2M's full width and max_seq_len)
MIXED_SLOTS, MIXED_SHORT, MIXED_LONG = 12, 6, 6
MIXED_S_LONG, MIXED_CHUNK, MIXED_BLOCKS = 200, 64, 192


def mixed_requests():
    """6 short requests (6-event prompts, 48 new events), then 6 long ones
    (200-event prompts, 4 new events), generator-sampled."""
    import numpy as np
    from repro_torch.serve import Request
    shorts = [Request(tokens=((np.arange(3, 9) + 7 * i) % 90).astype(np.int32),
                      ages=np.linspace(0.0, 30.0, 6).astype(np.float32),
                      max_new=48) for i in range(MIXED_SHORT)]
    longs = [Request(
        tokens=((np.arange(3, 3 + MIXED_S_LONG) + 11 * i) % 90).astype(
            np.int32),
        ages=np.linspace(0.0, 60.0, MIXED_S_LONG).astype(np.float32),
        max_new=4) for i in range(MIXED_LONG)]
    return shorts, longs


def mixed_engine(params, cfg, chunk):
    from repro_torch.serve import BatchedEngine
    return BatchedEngine(params, cfg, slots=MIXED_SLOTS,
                         max_context=cfg.max_seq_len, cache="paged",
                         block_size=16, blocks=MIXED_BLOCKS,
                         prefill_chunk_tokens=chunk, seed=SEED,
                         device=DEVICE)


def mixed_drive(eng) -> dict:
    """The short requests first; one long request arrives every 8 steps
    from step 3 while they decode.  Each short request's per-event latency
    is the host time between the steps that gave it events, over the events
    given.  Every request must finish, the pool must drain, and the step's
    host copies must be one per tick and per admission batch."""
    import numpy as np
    import torch
    shorts, longs = mixed_requests()
    syncs0, ticks0, adm0 = eng.host_syncs, eng.ticks, eng.admit_batches
    chunks0 = eng.prefill_chunks
    for r in shorts:
        eng.submit(r)
    pending = list(longs)
    lat, seen = [], [0] * len(shorts)
    torch.cuda.synchronize()
    now = time.perf_counter()
    last = [now] * len(shorts)
    step, t0 = 0, now
    while not all(r.done for r in shorts + longs):
        if pending and step % 8 == 3:
            eng.submit(pending.pop(0))
        eng.step()
        step += 1
        now = time.perf_counter()
        for i, r in enumerate(shorts):
            k = len(r.out_tokens)
            if k > seen[i]:
                lat.extend([(now - last[i]) / (k - seen[i])] * (k - seen[i]))
                seen[i], last[i] = k, now
        if step > 5000:
            raise AssertionError("mixed traffic did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.error is None for r in shorts + longs):
        raise AssertionError("a mixed-traffic request failed")
    if eng.allocator.used or eng.pool._refs or eng._prefills:
        raise AssertionError(f"mixed traffic: pool not drained "
                             f"{eng.pool_stats()}")
    ticks, adm = eng.ticks - ticks0, eng.admit_batches - adm0
    if eng.host_syncs - syncs0 != ticks + adm:
        raise AssertionError(f"mixed traffic: host_syncs "
                             f"{eng.host_syncs - syncs0} != ticks {ticks} + "
                             f"admission batches {adm}")
    lat = np.asarray(lat)
    events = sum(len(r.out_tokens) for r in shorts + longs)
    return {"wall_s": wall, "events": events, "events_per_s": events / wall,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "short_events": int(lat.size), "steps": step, "ticks": ticks,
            "admit_batches": adm, "host_syncs": ticks + adm,
            "chunks": eng.prefill_chunks - chunks0}


def mixed_path() -> dict:
    """Phase 3e: monolithic and chunked prefill (64 tokens a step) on one
    model, a warm-up drive each, then timed drives in turns (monolithic,
    chunked, chunked, monolithic).  Launch counts are zeroed just before
    the first timed chunked drive and read just after it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    cfg = get_config("delphi-2m")
    params = init_params(cfg, seed=SEED, device=DEVICE)
    engs = {"monolithic": mixed_engine(params, cfg, None),
            "chunked": mixed_engine(params, cfg, MIXED_CHUNK)}
    for eng in engs.values():
        mixed_drive(eng)                        # first use of these shapes
    runs, counts = [], None
    for mode in ("monolithic", "chunked", "chunked", "monolithic"):
        torch.cuda.synchronize()
        first_chunked = mode == "chunked" and counts is None
        if first_chunked:
            ops.reset_launch_counts()
        r = mixed_drive(engs[mode])
        if first_chunked:
            counts = dict(ops.launch_counts(),
                          flash_positions=fk.position_launches)
            if (counts["flash_positions"] != 12 * r["chunks"]
                    or counts["flash_attention"] != counts["flash_positions"]
                    or counts["paged_decode_attention"] != 12 * r["ticks"]
                    or counts["tte_sample"] == 0):
                raise AssertionError(f"chunked drive: launches {counts}, "
                                     f"{r['chunks']} chunks, {r['ticks']} "
                                     f"ticks")
        runs.append((mode, r))
    ceng = engs["chunked"]
    st = ceng.pool_stats()
    if st["chunked_prefills"] != 3 * (MIXED_SHORT + MIXED_LONG):
        raise AssertionError(f"chunked prefills {st['chunked_prefills']}")
    return {"runs": runs, "launches": counts, "stats": st,
            "chunk_shapes": sorted(ceng.prefill_shapes),
            "monolithic_shapes": sorted(engs["monolithic"].prefill_shapes),
            "engines": engs}


def suffix_path(params, cfg) -> dict:
    """Phase 3f: a prefix-cached chunked engine (64 tokens a step) serves a
    200-event prompt, then a 240-event prompt that extends it: the second
    shares the first's 12 full blocks by reference and prefills only its
    48-token suffix, in one chunk."""
    import numpy as np
    from repro_torch.serve import BatchedEngine, Request
    rng = np.random.default_rng(SEED + 31)
    toks = rng.integers(3, cfg.vocab_size, 240).astype(np.int32)
    ages = np.sort(rng.uniform(20, 70, 240)).astype(np.float32)
    eng = BatchedEngine(params, cfg, slots=MIXED_SLOTS,
                        max_context=cfg.max_seq_len, cache="paged",
                        block_size=16, prefix_cache=True,
                        prefill_chunk_tokens=MIXED_CHUNK, seed=SEED,
                        device=DEVICE)
    first = Request(tokens=toks[:200], ages=ages[:200], max_new=8)
    eng.submit(first)
    eng.run()
    chunks0 = eng.prefill_chunks
    second = Request(tokens=toks, ages=ages, max_new=8)
    eng.submit(second)
    eng.run()
    st = eng.pool_stats()
    matched = (200 // 16) * 16
    if not (first.done and second.done and first.error is None
            and second.error is None):
        raise AssertionError("phase 3f: a request failed")
    if (st["suffix_tokens_saved"] != matched
            or st["prefix_cache"]["partial_hits"] != 1
            or eng.prefill_chunks - chunks0 != 1
            or eng.host_syncs != eng.ticks + eng.admit_batches):
        raise AssertionError(f"phase 3f: {st}")
    eng.drop_prefix_cache()
    if eng.allocator.used or eng.pool._refs:
        raise AssertionError("phase 3f: leaked blocks")
    return {"stats": st, "matched": matched,
            "suffix_chunks": eng.prefill_chunks - chunks0,
            "shapes": sorted(eng.prefill_shapes)}


def parity() -> dict:
    """fp32 engine on the card (kernels) and on the CPU (plain versions)
    with the same weights and uniforms."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import parity as par
    from repro_torch.data import SimulatorConfig, generate_dataset
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedEngine, Request
    cfg = get_config("delphi-2m").replace(dtype="float32")
    n_req, max_new, W = 24, 48, cfg.max_seq_len
    trajs, _ = generate_dataset(SimulatorConfig(n_train=n_req, n_val=1,
                                                seed=SEED + 17))
    rng = np.random.default_rng(SEED + 1)
    prompts = [(t[:max(len(t) // 2, 1)], a[:max(len(t) // 2, 1)])
               for t, a in trajs]
    us = [rng.random((max_new, cfg.vocab_size), dtype=np.float32)
          for _ in prompts]
    runs, params = {}, {}
    for dev in (DEVICE, "cpu"):
        params[dev] = init_params(cfg, seed=SEED + 1, device=dev)
        eng = BatchedEngine(params[dev], cfg, slots=16, max_context=W,
                            device=dev)
        reqs = [Request(tokens=t, ages=a, max_new=max_new, uniforms=u)
                for (t, a), u in zip(prompts, us)]
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run()
        runs[dev] = [(r.out_tokens, r.out_ages) for r in reqs]
        if eng.host_syncs != eng.ticks + eng.admit_batches:
            raise AssertionError(f"{dev}: host_syncs {eng.host_syncs}")
        log(f"  {dev}: {sum(len(t) for t, _ in runs[dev])} events, "
            f"{eng.ticks} ticks in {time.perf_counter() - t0:.2f}s")
    # tolerance: the card and the CPU differ in fp32 summation order and in
    # sin/cos of the ~1e4-1e5 rad age-encoding angles; 1e-3 relative on a
    # waiting time is ~3x the port-vs-JAX disagreement measured on the CPU
    held = par.check_trajectories(
        prompts, runs[DEVICE], us, par.port_logits_fn(params["cpu"], cfg),
        margin_tol=1e-3, age_rtol=1e-3, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=W)
    free = par.compare_runs(runs["cpu"], runs[DEVICE], age_rtol=0.25)
    log(f"  card trajectories held step by step against the CPU model: "
        f"{held['steps']} steps, {len(held['near_ties'])} near-ties, largest "
        f"age-increment rel err {held['max_age_rel_err']:.3g} (tol 1e-3)")
    log(f"  free-running card vs CPU: {free['compared']} events equal before"
        f" the first divergence; divergences at {free['divergences']}")
    return {"held": held, "free": free}


def paged_parity() -> dict:
    """On the card with injected uniforms, full-width Delphi-2M in fp32 and
    in bf16: the ring and the paged engine (16-token blocks) give the same
    tokens and fp32 ages bit for bit over phase 4's prompts plus one
    over-width prompt (300 events > max_context 256); and sample_futures
    (16 futures, 48 events) on the ring, the paged and the prefix-cached
    paged engine (twice) equals the port's ring_reference_futures bit for
    bit."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import SimulatorConfig, generate_dataset
    from repro_torch.models import init_params
    from repro_torch.serve import (BatchedEngine, Request,
                                   ring_reference_futures)
    base = get_config("delphi-2m")
    W, V, max_new = base.max_seq_len, base.vocab_size, 48
    trajs, _ = generate_dataset(SimulatorConfig(n_train=24, n_val=1,
                                                seed=SEED + 17))
    prompts = [(t[:max(len(t) // 2, 1)], a[:max(len(t) // 2, 1)])
               for t, a in trajs]
    rng = np.random.default_rng(SEED + 7)
    prompts.append((rng.integers(3, V, 300).astype(np.int32),
                    np.sort(rng.uniform(20, 70, 300)).astype(np.float32)))
    us = [rng.random((max_new, V), dtype=np.float32) for _ in prompts]
    fut_u = rng.random((FUTURES_N, max_new, V), dtype=np.float32)
    ftoks, fages = prompts[0]
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dt)
        params = init_params(cfg, seed=SEED + 1, device=DEVICE)
        runs = {}
        for kind in ("ring", "paged"):
            eng = BatchedEngine(params, cfg, slots=16, max_context=W,
                                cache=kind, device=DEVICE)
            reqs = [Request(tokens=t, ages=a, max_new=max_new, uniforms=u)
                    for (t, a), u in zip(prompts, us)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            if not all(r.done and r.error is None for r in reqs):
                raise AssertionError(f"{dt} {kind}: a request failed")
            runs[kind] = [(r.out_tokens, r.out_ages) for r in reqs]
        if runs["ring"] != runs["paged"]:
            bad = [i for i, (x, y) in enumerate(zip(runs["ring"],
                                                    runs["paged"])) if x != y]
            raise AssertionError(f"{dt}: ring != paged at requests {bad}")
        if eng.allocator.used:
            raise AssertionError(f"{dt}: {eng.allocator.used} blocks leaked")
        ora = ring_reference_futures(params, cfg, ftoks, fages, n=FUTURES_N,
                                     max_new=max_new, uniforms=fut_u,
                                     slots=16, max_context=W, device=DEVICE)
        for kind, kw, rounds in (
                ("ring", {}, 1), ("paged", {"cache": "paged"}, 1),
                ("prefix-cached paged", {"cache": "paged",
                                         "prefix_cache": True}, 2)):
            eng = BatchedEngine(params, cfg, slots=16, max_context=W,
                                device=DEVICE, **kw)
            for rnd in range(rounds):
                kids = eng.sample_futures(ftoks, fages, n=FUTURES_N,
                                          max_new=max_new, uniforms=fut_u)
                got = [(k.out_tokens, k.out_ages) for k in kids]
                if got != ora:
                    raise AssertionError(f"{dt} {kind} round {rnd}: fork "
                                         f"!= ring_reference_futures")
            if eng.paged:
                eng.drop_prefix_cache()
                if eng.allocator.used or eng.pool._refs:
                    raise AssertionError(f"{dt} {kind}: leaked blocks")
        ev = sum(len(t) for t, _ in runs["ring"])
        fev = sum(len(t) for t, _ in ora)
        log(f"  {dt}: ring == paged bit for bit ({len(prompts)} requests, "
            f"{ev} events, one prompt of 300 > {W}); fork == "
            f"ring_reference_futures bit for bit on ring, paged, "
            f"prefix-cached paged x2 ({FUTURES_N} futures, {fev} events)")
        out[dt] = {"requests": len(prompts), "events": ev,
                   "futures_events": fev}
    return out


def chunked_parity() -> dict:
    """On the card with injected uniforms, full-width Delphi-2M in fp32 and
    in bf16, each request alone on a fresh paged engine (16-token blocks,
    max_context 256) and held bit for bit against the port's
    ``chunked_reference_trajectory``: the unchunked engine against the
    oracle at an unbounded budget (the engine == straight-line oracle gate
    of the paged engine), the chunked engine at one block and at 64 tokens
    against the oracle at that budget, a partial prefix hit (a 160-event
    registrant, then its 200-event extension) against the oracle with
    ``matched_tokens``; ``sample_futures`` from a parent prefilled in one
    chunk against the unchunked engine's, and from one prefilled in 7
    chunks against the oracle on each future's uniforms (a multi-chunk
    prefill is not bit-equal to the monolithic one: its softmax runs over
    other key widths)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import (BatchedEngine, Request,
                                   chunked_reference_trajectory)
    base = get_config("delphi-2m")
    W, V, max_new = base.max_seq_len, base.vocab_size, 24
    rng = np.random.default_rng(SEED + 29)
    prompts = [(rng.integers(3, V, S).astype(np.int32),
                np.sort(rng.uniform(20, 70, S)).astype(np.float32))
               for S in (5, 21, 100, 200)]
    us = [rng.random((max_new, V), dtype=np.float32) for _ in prompts]
    fut_u = rng.random((4, max_new, V), dtype=np.float32)
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dt)
        params = init_params(cfg, seed=SEED + 1, device=DEVICE)

        def engine(**kw):
            return BatchedEngine(params, cfg, slots=4, max_context=W,
                                 cache="paged", block_size=16, device=DEVICE,
                                 **kw)

        def serve(eng, toks, ages, u):
            r = Request(tokens=toks, ages=ages, max_new=max_new, uniforms=u)
            eng.submit(r)
            eng.run()
            leaked = eng.prefix is None and eng.allocator.used
            if r.error is not None or leaked:
                raise AssertionError(f"{dt}: a request failed or leaked")
            return (r.out_tokens, r.out_ages)

        def oracle(toks, ages, u, chunk, matched=0):
            return chunked_reference_trajectory(
                params, cfg, toks, ages, max_new=max_new, uniforms=u,
                chunk_tokens=chunk, matched_tokens=matched, slots=4,
                max_context=W, block_size=16, device=DEVICE)
        checks = 0
        for (toks, ages), u in zip(prompts, us):
            S = len(toks)
            if serve(engine(), toks, ages, u) != oracle(toks, ages, u, W):
                raise AssertionError(f"{dt} S={S}: the paged engine != "
                                     f"chunked_reference_trajectory")
            for budget in (16, 64):
                got = serve(engine(prefill_chunk_tokens=budget), toks, ages,
                            u)
                if got != oracle(toks, ages, u, budget):
                    raise AssertionError(f"{dt} S={S}: the chunked engine "
                                         f"({budget}) != the oracle")
            checks += 3
        toks, ages = prompts[-1]
        eng = engine(prefix_cache=True, prefill_chunk_tokens=64)
        serve(eng, toks[:160], ages[:160], us[0])
        got = serve(eng, toks, ages, us[-1])
        if eng.pool_stats()["suffix_tokens_saved"] != 160 or \
                got != oracle(toks, ages, us[-1], 64, matched=160):
            raise AssertionError(f"{dt}: the partial hit != the oracle with "
                                 f"matched_tokens=160 "
                                 f"({eng.pool_stats()['suffix_tokens_saved']}"
                                 f" tokens saved)")
        def futures(ftoks, fages, **kw):
            feng = engine(**kw)
            kids = feng.sample_futures(ftoks, fages, n=4, max_new=max_new,
                                       uniforms=fut_u)
            if feng.allocator.used or feng.pool_stats()["chunked_prefills"] \
                    != (1 if kw else 0):
                raise AssertionError(f"{dt}: fork: {feng.pool_stats()}")
            return [(k.out_tokens, k.out_ages) for k in kids]
        # a parent prefilled in one chunk (64 >= 21 events): the unchunked
        # fork's bits; one prefilled in 7 chunks (16 a step, 100 events):
        # each future == the oracle on its uniforms
        ftoks, fages = prompts[1]
        if futures(ftoks, fages, prefill_chunk_tokens=64) != \
                futures(ftoks, fages):
            raise AssertionError(f"{dt}: the fork from a one-chunk parent "
                                 f"!= the unchunked fork")
        ftoks, fages = prompts[2]
        want = [oracle(ftoks, fages, fut_u[j], 16) for j in range(4)]
        if futures(ftoks, fages, prefill_chunk_tokens=16) != want:
            raise AssertionError(f"{dt}: the fork from a 7-chunk parent != "
                                 f"the oracle per future")
        log(f"  {dt}: unchunked paged == chunked_reference_trajectory "
            f"(unbounded budget) and chunked (16, 64) == the oracle, bit for "
            f"bit, at prompts of {[len(t) for t, _ in prompts]} events; "
            f"partial hit (160 of 200 matched) == the oracle; 4 futures "
            f"forked from a parent prefilled in one chunk == the unchunked "
            f"fork, and from one prefilled in 7 chunks == the oracle per "
            f"future")
        out[dt] = {"checks": checks + 3, "prompt_lengths":
                   [len(t) for t, _ in prompts]}
    return out


def risk_checks(fut: dict) -> dict:
    """Risk on the card: ``monte_carlo_risk`` over phase 3d's first 16
    futures (patient 0) equals the host-side ``futures_risk_items`` and
    ``futures_chapter_risk`` on the same futures exactly; analytic
    next-event risk from the card's logits on the 4 patients' histories,
    on the card and on the CPU, within 1e-6 (fp32 logsumexp, softmax and
    exp in two libraries; the port-vs-JAX difference on the CPU was below
    2.4e-7)."""
    import numpy as np
    import torch
    from repro_torch.core import risk
    from repro_torch.models import forward
    params, cfg = fut["params"], fut["cfg"]
    V = cfg.vocab_size
    toks, ages = fut["patients"][0]
    kids = fut["calls"][0]
    futs = [(k.out_tokens, k.out_ages) for k in kids]
    packed = risk.pack_futures_trajectories(toks, ages, futs,
                                            max_new=FUTURES_MAX_NEW,
                                            device=DEVICE)
    mc = risk.monte_carlo_risk(
        params, cfg, torch.as_tensor(toks, device=DEVICE),
        torch.as_tensor(np.asarray(ages, np.float32), device=DEVICE),
        horizon=5.0, chapter_of=risk.disease_chapter_map(V, DEVICE),
        trajectories=packed)
    age0 = float(np.float32(ages[-1]))
    items = dict(risk.futures_risk_items(futs, age0, 5.0, V, top=V))
    want = np.asarray([items[i] for i in range(V)], np.float32)
    chap = risk.futures_chapter_risk(futs, age0, 5.0, V).astype(np.float32)
    if not (np.array_equal(mc["code_risk"].cpu().numpy(), want)
            and np.array_equal(mc["chapter_risk"].cpu().numpy(), chap)):
        raise AssertionError("monte_carlo_risk on the card != the host "
                             "aggregation of the same futures")
    lgs = []
    for t, a in fut["patients"]:
        o = forward(params, cfg, {
            "tokens": torch.as_tensor(t[None], device=DEVICE),
            "ages": torch.as_tensor(np.asarray(a, np.float32)[None],
                                    device=DEVICE)}, mode="prefill")
        lgs.append(o["logits"][:, 0].float())
    lg = torch.cat(lgs)
    card = risk.analytic_next_event_risk(lg, 5.0)
    cpu = risk.analytic_next_event_risk(lg.cpu(), 5.0)
    err = float((card.cpu() - cpu).abs().max())
    if not (err <= 1e-6 and bool(torch.isfinite(card).all())):
        raise AssertionError(f"analytic risk card vs CPU: err {err} > 1e-6")
    top = mc["code_risk"].argsort(descending=True)[:3].tolist()
    log(f"  monte_carlo_risk over phase 3d's 16 futures of patient 0 == the "
        f"host aggregation (codes and chapters, exactly); death risk "
        f"{float(mc['death_risk']):.4f}, top codes {top}; analytic risk "
        f"card vs CPU on {lg.shape[0]} patients: max abs err {err:.3g} "
        f"(tol 1e-6)")
    return {"death_risk": float(mc["death_risk"]), "analytic_err": err}


def mamba_config():
    from repro_torch.configs import get_config
    return get_config("mamba2-780m")


def mamba_prompts(vocab: int):
    """16 prompts of seeded random token ids, 96 to 1024 tokens (1024 is a
    multiple of the 128-token chunk; the others are not), in seeded order."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    lens = np.linspace(96, 1024, MAMBA_REQUESTS).astype(int)
    rng.shuffle(lens)
    return [rng.integers(0, vocab, int(S)).astype(np.int32) for S in lens]


def mamba_serve(params, cfg, prompts, max_new: int):
    """Serve ``prompts`` with generator uniforms; returns (engine, requests,
    seconds of ``run()`` ending in a device synchronise)."""
    import torch
    from repro_torch.serve import BatchedEngine, Request
    eng = BatchedEngine(params, cfg, slots=MAMBA_SLOTS,
                        max_context=cfg.max_seq_len, seed=SEED, device=DEVICE)
    reqs = [Request(tokens=t, max_new=max_new) for t in prompts]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def mamba_path() -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    cfg = mamba_config()
    params = init_params(cfg, seed=SEED, device=DEVICE)
    prompts = mamba_prompts(cfg.vocab_size)
    # first use of cuBLAS and the allocator at these shapes, same entry point
    mamba_serve(params, cfg, prompts[:2], 2)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng, reqs, sec = mamba_serve(params, cfg, prompts, MAMBA_MAX_NEW)
    counts = ops.launch_counts()
    if not all(r.done and r.error is None for r in reqs):
        raise AssertionError("a Mamba2 request did not finish")
    for r in reqs:
        toks = r.out_tokens
        if len(toks) != MAMBA_MAX_NEW or r.out_ages or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"bad Mamba2 output {toks} {r.out_ages}")
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    want_shapes = {(1, len(t)) for t in prompts}
    if eng.prefill_shapes != want_shapes:
        raise AssertionError(f"prefill shapes {sorted(eng.prefill_shapes)}")
    if counts["ssd_intra"] != cfg.n_layers * eng.admit_batches \
            or eng.admit_batches != len(prompts):
        raise AssertionError(f"ssd_intra launched {counts['ssd_intra']} "
                             f"times for {eng.admit_batches} admissions")
    return {"engine": eng, "seconds": sec, "tokens": len(reqs) * MAMBA_MAX_NEW,
            "launches": counts, "params": params, "cfg": cfg,
            "prompts": prompts}


def mamba_parity() -> dict:
    """fp32 Mamba2-780M at full width, cut to 4 layers: the engine on the
    card (kernels) and on the CPU (plain versions) with the same weights
    and injected uniforms; the card's tokens held step by step against the
    CPU model's Gumbel scores."""
    import numpy as np
    from repro_torch.core import parity as par
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedEngine, Request
    cfg = mamba_config().replace(n_layers=4, dtype="float32")
    max_new, V = 16, cfg.vocab_size
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, V, S).astype(np.int32)
               for S in (100, 237, 384, 520)]
    us = [rng.random((max_new, V), dtype=np.float32) for _ in prompts]
    runs, params = {}, {}
    for dev in (DEVICE, "cpu"):
        params[dev] = init_params(cfg, seed=SEED + 1, device=dev)
        eng = BatchedEngine(params[dev], cfg, slots=4,
                            max_context=cfg.max_seq_len, device=dev)
        reqs = [Request(tokens=t, max_new=max_new, uniforms=u)
                for t, u in zip(prompts, us)]
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run()
        runs[dev] = [r.out_tokens for r in reqs]
        if eng.host_syncs != eng.ticks + eng.admit_batches or any(
                len(t) != max_new for t in runs[dev]):
            raise AssertionError(f"{dev}: host_syncs {eng.host_syncs}, "
                                 f"lengths {[len(t) for t in runs[dev]]}")
        log(f"  mamba2 {dev}: {sum(len(t) for t in runs[dev])} tokens, "
            f"{eng.ticks} ticks in {time.perf_counter() - t0:.2f}s")
    # tolerance: the card and the CPU sum fp32 products in other orders
    # (cuBLAS, the SSD kernel); logits of this model are O(1), and their
    # card-vs-CPU differences are ~1e-5, so a score gap under 1e-3 is a tie
    held = par.check_lm_trajectories(
        prompts, runs[DEVICE], us, par.port_logits_fn(params["cpu"], cfg),
        margin_tol=1e-3)
    free = par.compare_runs([(t, []) for t in runs["cpu"]],
                            [(t, []) for t in runs[DEVICE]], age_rtol=0.0)
    log(f"  mamba2 card tokens held step by step against the CPU model: "
        f"{held['steps']} steps, {len(held['near_ties'])} near-ties "
        f"(score margin 1e-3)")
    log(f"  mamba2 free-running card vs CPU: {free['compared']} tokens equal"
        f" before the first divergence; divergences at {free['divergences']}")
    return {"held": held, "free": free}


# ---------------------------------------------------------------------------
# phase 3g / 3h: the serving surface on the card (HTTP server, router)
# ---------------------------------------------------------------------------
HTTP_CLIENTS, HTTP_REQUESTS, HTTP_MAX_NEW = 8, 32, 48
HTTP_STREAMS, HTTP_RISKS, HTTP_EXACT = 8, 4, 4
HTTP_KNOBS = dict(slots=16, max_context=256, cache="paged", prefix_cache=True)


def http_prompts():
    """Phase 3's 32 prompts: the first halves of the same synthetic
    patients (``repro_torch.launch.serve``), as JSON-ready lists."""
    from repro_torch.data import SimulatorConfig, generate_dataset
    trajs, _ = generate_dataset(SimulatorConfig(
        n_train=HTTP_REQUESTS, n_val=1, seed=SEED + 17))
    out = []
    for t, a in trajs:
        half = max(len(t) // 2, 1)
        out.append(([int(x) for x in t[:half]],
                    [float(x) for x in a[:half]]))
    return out


def serving_backend(params, cfg):
    """Phase 3d's knobs: a prefix-cached paged engine, 16 slots."""
    from repro_torch.api.client import EngineBackend
    return EngineBackend.create(params, cfg, seed=SEED, device=DEVICE,
                                **HTTP_KNOBS)


def check_result(r, cfg, max_new: int) -> None:
    import numpy as np
    toks = np.asarray(r.tokens)
    ages = np.asarray(r.ages, np.float64)
    if len(toks) > max_new or len(ages) != len(toks) or (
            len(toks) and (toks.min() < 0 or toks.max() >= cfg.vocab_size)):
        raise AssertionError(f"bad result {r.tokens} {r.ages}")
    if not (np.isfinite(ages).all() and (np.diff(ages) >= 0).all()):
        raise AssertionError(f"bad ages {r.ages}")


def concurrent(make_client, jobs, fn, threads: int = HTTP_CLIENTS):
    """``fn(client, job)`` over ``jobs`` from ``threads`` threads, each
    with its own client from ``make_client()``, job i on thread i % threads.
    Returns (results in job order, wall seconds ending in a device
    synchronise); any error is raised."""
    import threading
    import torch
    results = [None] * len(jobs)
    errors = []

    def worker(k):
        try:
            client = make_client()
            for i in range(k, len(jobs), threads):
                results[i] = fn(client, jobs[i])
        except Exception as e:                  # noqa: BLE001
            errors.append(e)
    ts = [threading.Thread(target=worker, args=(k,)) for k in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in ts) or any(r is None for r in results):
        raise AssertionError("a request was not answered")
    return results, wall


def generate_traffic(make_client, prompts, cfg) -> dict:
    """Phase 3's 32 prompts with generator uniforms, 48 new events each,
    from 8 concurrent clients."""
    from repro_torch.api import GenerateRequest

    def gen(client, p):
        return client.generate(GenerateRequest(tokens=p[0], ages=p[1],
                                               max_new=HTTP_MAX_NEW))
    results, wall = concurrent(make_client, prompts, gen)
    for r in results:
        check_result(r, cfg, HTTP_MAX_NEW)
    events = sum(len(r.tokens) for r in results)
    return {"wall_s": wall, "events": events, "events_per_s": events / wall}


def stream_traffic(url, prompts, cfg) -> dict:
    """``/v1/stream`` for 8 prompts from 8 concurrent clients: each
    stream's time from its POST to its first event."""
    from repro_torch.api import GenerateRequest, RemoteBackend

    def stream(client, p):
        t0 = time.perf_counter()
        it = client.stream(GenerateRequest(tokens=p[0], ages=p[1],
                                           max_new=HTTP_MAX_NEW))
        first = next(it, None)
        ttfe = time.perf_counter() - t0
        evs = ([first] if first is not None else []) + list(it)
        return ttfe, evs
    out, wall = concurrent(lambda: RemoteBackend(url), prompts, stream)
    for _, evs in out:
        if [e.index for e in evs] != list(range(len(evs))) or any(
                e.age is None or not 0 <= e.token < cfg.vocab_size
                for e in evs):
            raise AssertionError("bad stream")
    return {"ttfe_s": [t for t, _ in out],
            "events": sum(len(e) for _, e in out), "wall_s": wall}


def pct(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q))


def http_exact(params, cfg, prompts, patients) -> dict:
    """On a fresh server and a fresh twin engine with the same knobs, one
    request at a time under injected uniforms: ``/v1/generate`` == the
    twin's generate bit for bit (tokens and ages), ``/v1/stream`` == that
    generate, and ``/v1/futures`` == ``ring_reference_futures``."""
    import numpy as np
    from repro_torch.api import Client, FuturesRequest
    from repro_torch.serve import ring_reference_futures
    from repro_torch.serve.server import InferenceServer
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 41)
    server = InferenceServer(serving_backend(params, cfg), port=0).start()
    try:
        remote = Client.connect(server.address)
        twin = Client.from_engine(serving_backend(params, cfg).engine)
        events = 0
        for t, a in prompts[:HTTP_EXACT]:
            u = rng.random((HTTP_MAX_NEW, V), dtype=np.float32)
            r = remote.generate(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                                uniforms=u)
            w = twin.generate(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                              uniforms=u)
            if not r.tokens or (r.tokens, r.ages) != (w.tokens, w.ages):
                raise AssertionError(f"/v1/generate {r.tokens} != the twin "
                                     f"engine's {w.tokens}")
            evs = list(remote.stream(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                                     uniforms=u))
            if [(e.token, e.age) for e in evs] != list(zip(r.tokens,
                                                           r.ages)):
                raise AssertionError("/v1/stream != /v1/generate")
            events += len(r.tokens)
        t, a = patients[0]
        fu = rng.random((FUTURES_N, 16, V), dtype=np.float32)
        fr = remote.sample_futures(FuturesRequest(
            tokens=[int(x) for x in t], ages=[float(x) for x in a],
            n_futures=FUTURES_N, max_new=16, uniforms=fu))
        ora = ring_reference_futures(params, cfg, t, a, n=FUTURES_N,
                                     max_new=16, uniforms=fu,
                                     slots=HTTP_KNOBS["slots"],
                                     max_context=HTTP_KNOBS["max_context"],
                                     device=DEVICE)
        if [(x.tokens, x.ages) for x in fr.trajectories] != \
                [(list(k), [float(y) for y in g]) for k, g in ora]:
            raise AssertionError("/v1/futures != ring_reference_futures")
    finally:
        server.stop()
    return {"generate_events": events,
            "futures_events": sum(len(x.tokens) for x in fr.trajectories)}


def http_risk(url, params, cfg, prompts) -> float:
    """``/v1/risk`` for 4 prompts against ``core/risk.py`` on logits that
    the card computes here: each item's risk within 1e-5 relative, and the
    items the top ones (up to ties within that tolerance).  Returns the
    largest relative difference."""
    import numpy as np
    import torch
    from repro_torch.api import Client
    from repro_torch.core.risk import analytic_next_event_risk_np
    from repro_torch.models import cast_params, forward
    remote = Client.connect(url)
    wp = cast_params(params, cfg)
    worst = 0.0
    for t, a in prompts[:HTTP_RISKS]:
        rep = remote.risk(t, a, horizon=5.0, top=10)
        S = max(cfg.max_seq_len, len(t))
        tok = np.zeros((1, S), np.int32)
        tok[0, :len(t)] = t
        age = np.full((1, S), a[-1], np.float32)
        age[0, :len(a)] = a
        with torch.no_grad():
            lg = forward(wp, cfg, {
                "tokens": torch.from_numpy(tok).to(DEVICE),
                "ages": torch.from_numpy(age).to(DEVICE)},
                mode="train")["logits"][0, len(t) - 1]
        want = analytic_next_event_risk_np(lg.float().cpu().numpy(), 5.0)
        got = np.asarray([i.risk for i in rep.items])
        ids = [i.token for i in rep.items]
        rel = np.abs(got - want[ids]) / np.maximum(want[ids], 1e-30)
        kth = np.sort(want)[::-1][len(ids) - 1]
        if len(ids) != 10 or rel.max() > 1e-5 or \
                want[ids].min() < kth * (1 - 1e-5):
            raise AssertionError(f"/v1/risk != core/risk.py: {rel.max()}")
        worst = max(worst, float(rel.max()))
    return worst


def cli_boot() -> dict:
    """``python -m repro_torch.serve.server --config delphi-2m --port 0
    --device cuda`` as a subprocess (the CLI's fp32 route): its address
    line, ``/v1/healthz``, one ``/v1/generate``, SIGINT, exit code 0."""
    import queue
    import signal
    import threading
    from urllib.request import urlopen
    from repro_torch.api import Client
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.server", "--config",
         "delphi-2m", "--port", "0", "--device", DEVICE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        url, seen = None, []
        deadline = time.monotonic() + 180
        while url is None and time.monotonic() < deadline:
            try:
                ln = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                break
            seen.append(ln.rstrip())
            if " backend on http://" in ln:
                url = ln.split(" backend on ")[1].split()[0]
        if url is None:
            raise AssertionError("the server CLI printed no address: "
                                 + " | ".join(seen))
        boot = time.perf_counter() - t0
        with urlopen(url + "/v1/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not health["engine"]["running"]:
            raise AssertionError(f"healthz: {health}")
        res = Client.connect(url).generate(tokens=[3, 10, 20],
                                           ages=[0.0, 15.0, 28.0],
                                           max_new=8)
        if res.backend != "remote[engine]":
            raise AssertionError(f"CLI generate: {res}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"the server CLI exited {rc} on SIGINT")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=10)
        proc.stdout.close()
    return {"boot_s": boot, "lines": seen[:2], "events": len(res.tokens),
            "exit_code": rc}


def http_path(params, cfg, patients) -> dict:
    """Phase 3g: Delphi-2M behind ``InferenceServer`` on the card."""
    import torch
    from repro_torch.api import FuturesRequest, RemoteBackend
    from repro_torch.kernels import ops
    from repro_torch.serve import server as server_mod
    from repro_torch.serve.server import InferenceServer
    prompts = http_prompts()
    backend = serving_backend(params, cfg)
    server = InferenceServer(backend, port=0).start()
    inproc = serving_backend(params, cfg)
    inproc.engine.start()
    # the same traffic's streams against a server with the stdlib's listen
    # backlog of 5 (the JAX package's server), over the in-process engine
    port_backlog = server_mod._TrackingHTTPServer.request_queue_size
    server_mod._TrackingHTTPServer.request_queue_size = 5
    try:
        backlog5 = InferenceServer(inproc, port=0).start()
    finally:
        server_mod._TrackingHTTPServer.request_queue_size = port_backlog
    eng = backend.engine
    try:
        url = server.address
        # first use of every shape, on both engines
        generate_traffic(lambda: RemoteBackend(url), prompts[:8], cfg)
        generate_traffic(lambda: inproc, prompts[:8], cfg)
        t0, s0, a0 = eng.ticks, eng.host_syncs, eng.admit_batches
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        first = generate_traffic(lambda: RemoteBackend(url), prompts, cfg)
        counts = ops.launch_counts()
        for name in DELPHI_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"{name} never launched over HTTP")
        turns = [("http", first["events_per_s"])]
        for mode in ("inprocess", "inprocess", "http"):
            mk = ((lambda: RemoteBackend(url)) if mode == "http"
                  else (lambda: inproc))
            turns.append((mode, generate_traffic(mk, prompts,
                                                 cfg)["events_per_s"]))
        ttfe = {port_backlog: [], 5: []}
        for backlog in (5, port_backlog, port_backlog, 5):
            at = url if backlog == port_backlog else backlog5.address
            ttfe[backlog] += stream_traffic(at, prompts[:HTTP_STREAMS],
                                            cfg)["ttfe_s"]
        futs = []
        remote = RemoteBackend(url)
        for t, a in patients:
            fr = remote.sample_futures(FuturesRequest(
                tokens=[int(x) for x in t], ages=[float(x) for x in a],
                n_futures=FUTURES_N, max_new=FUTURES_MAX_NEW))
            for r in fr.trajectories:
                check_result(r, cfg, FUTURES_MAX_NEW)
            futs.append(sum(len(r.tokens) for r in fr.trajectories))
        risk_err = http_risk(url, params, cfg, prompts)
        prof = path_profile(
            lambda: generate_traffic(lambda: RemoteBackend(url), prompts,
                                     cfg)["wall_s"], first["wall_s"])
        health = remote.healthz()
        remote.close()
    finally:
        server.stop()
        backlog5.stop()
        inproc.engine.stop()
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    if any(r is not None for r in eng.slot_req) or eng.pending:
        raise AssertionError("the server's engine did not drain")
    eng.drop_prefix_cache()
    if eng.allocator.used or eng.pool._refs:
        raise AssertionError("the server's engine leaked blocks")
    exact = http_exact(params, cfg, prompts, patients)
    cli = cli_boot()
    return {"events": first["events"], "wall_s": first["wall_s"],
            "events_per_s": first["events_per_s"],
            "ticks": eng.ticks - t0, "host_syncs": eng.host_syncs - s0,
            "admit_batches": eng.admit_batches - a0,
            "launches": counts, "turns": turns,
            "http_over_inprocess": (
                sum(r for m, r in turns if m == "http")
                / sum(r for m, r in turns if m == "inprocess")),
            "sse_ttfe_p50_ms": 1e3 * pct(ttfe[port_backlog], 50),
            "sse_ttfe_p95_ms": 1e3 * pct(ttfe[port_backlog], 95),
            "sse_streams": len(ttfe[port_backlog]),
            "sse_backlog": port_backlog,
            "sse_ttfe_backlog5_p50_ms": 1e3 * pct(ttfe[5], 50),
            "sse_ttfe_backlog5_p95_ms": 1e3 * pct(ttfe[5], 95),
            "sse_ttfe_s": {str(k): v for k, v in ttfe.items()},
            "futures_events": futs, "risk_max_rel_err": risk_err,
            "profile": prof, "exact": exact, "cli": cli,
            "healthz_engine": health["engine"]}


def router_path(params, cfg, patients) -> dict:
    """Phase 3h: ``RouterServer`` over 2 in-process paged replicas on the
    card (the reference's ``--replica-mode inprocess``)."""
    import threading
    from repro_torch.api import Client, GenerateRequest, RemoteBackend
    from repro_torch.serve.router import ReplicaSupervisor, RouterServer
    from repro_torch.serve.server import InferenceServer
    import numpy as np
    prompts = http_prompts()
    V = cfg.vocab_size

    def replicas():
        return ReplicaSupervisor.in_process(
            lambda i: serving_backend(params, cfg), 2, probe_interval=0.2)
    # affinity: each patient's futures twice
    sup = replicas()
    router = RouterServer(sup, port=0).start()
    t0 = time.perf_counter()
    try:
        remote = Client.connect(router.address)
        visits = []
        for rnd in range(2):
            a0 = router.scheduler.stats()["affinity_routed"]
            hits0 = {r.name: r.server.backend.engine.prefix.hits
                     for r in sup.replicas}
            names = []
            for t, a in patients:
                fr = remote.sample_futures(
                    tokens=[int(x) for x in t], ages=[float(x) for x in a],
                    n_futures=FUTURES_N, max_new=FUTURES_MAX_NEW)
                for r in fr.trajectories:
                    check_result(r, cfg, FUTURES_MAX_NEW)
                names.append(fr.backend.split("router[")[1].split(":")[0])
            hits = {r.name: r.server.backend.engine.prefix.hits - hits0[
                r.name] for r in sup.replicas}
            visits.append({"replicas": names, "prefix_hits": hits,
                           "affinity_routed": router.scheduler.stats()[
                               "affinity_routed"] - a0})
        first, second = visits
        if second["replicas"] != first["replicas"] or \
                second["affinity_routed"] != len(patients):
            raise AssertionError(f"second visits not routed by affinity: "
                                 f"{visits}")
        for name in set(first["replicas"]):
            if second["prefix_hits"][name] != first["replicas"].count(name):
                raise AssertionError(f"the holder's prefix hits did not "
                                     f"rise: {visits}")
        # drain one replica under load: every request is answered
        out, errs = {}, []

        def client(k):
            try:
                rb = RemoteBackend(router.address)
                for i in range(k, 16, 8):
                    t, a = prompts[i]
                    out[i] = rb.generate(GenerateRequest(
                        tokens=t, ages=a, max_new=HTTP_MAX_NEW))
            except Exception as e:              # noqa: BLE001
                errs.append(e)
        ts = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        time.sleep(0.05)
        drained = router.drain_replica("r0", timeout=120.0)
        for t in ts:
            t.join(timeout=300)
        if errs or len(out) != 16 or not drained:
            raise AssertionError(f"drain: {len(out)} of 16 answered, "
                                 f"drained {drained}, errors {errs[:1]}")
        for r in out.values():
            check_result(r, cfg, HTTP_MAX_NEW)
        after = [remote.generate(tokens=t, ages=a, max_new=8).backend
                 for t, a in prompts[16:20]]
        if not all("router[r1:" in b for b in after):
            raise AssertionError(f"after the drain: {after}")
        sched = router.scheduler.stats()
    finally:
        router.stop()
    wall = time.perf_counter() - t0
    # router == a direct server, one request at a time, both fresh
    sup = replicas()
    router = RouterServer(sup, port=0).start()
    direct = InferenceServer(serving_backend(params, cfg), port=0).start()
    try:
        rng = np.random.default_rng(SEED + 43)
        via_r, via_d = Client.connect(router.address), Client.connect(
            direct.address)
        for t, a in prompts[:HTTP_EXACT]:
            u = rng.random((HTTP_MAX_NEW, V), dtype=np.float32)
            x = via_r.generate(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                               uniforms=u)
            y = via_d.generate(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                               uniforms=u)
            if not x.tokens or (x.tokens, x.ages) != (y.tokens, y.ages):
                raise AssertionError(f"router {x.tokens} != direct "
                                     f"{y.tokens}")
    finally:
        router.stop()
        direct.stop()
    return {"visits": visits, "scheduler": sched, "drained": drained,
            "wall_s": wall, "exact_prompts": HTTP_EXACT}


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------
def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Per-call time by CUDA events around a warmed run of ``iters`` calls:
    what a caller pays, host overhead included when launches are
    host-bound."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_kernels(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` and return {device activity
    (kernel, copy, set) name: (count, device ms)}; empty if the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = (e.count, us / 1e3)
    return out


def device_ms(fn, iters: int = 50, warmup: int = 10):
    """Device time per call of ``fn`` (all its kernels, summed), from the
    profiler; None where the profiler sees no device activity."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()
    total = sum(ms for _, ms in device_kernels(run).values())
    return total / iters if total > 0 else None


def measure(fn) -> dict:
    return {"device_ms": device_ms(fn), "call_ms": cuda_ms(fn)}


def cold_device_ms(fn, kernel: str, iters: int = 20, warmup: int = 3,
                   flush_mb: int = 128, flush: str = "write"):
    """Device time per launch of the kernels whose name holds ``kernel``,
    each call of ``fn`` made after a pass over ``flush_mb`` MB (more than
    twice the 50 MB L2), so that its inputs come from device memory.  Only
    that kernel's activity is counted, not the flush; None where the
    profiler sees none.  ``flush="write"`` fills the buffer, which leaves
    the L2 full of dirty lines: the kernel's reads then also pay for their
    write-back.  ``flush="read"`` sums it, which leaves clean lines."""
    import torch
    buf = torch.ones(flush_mb << 18, dtype=torch.float32, device=DEVICE)
    sweep = (lambda: buf.fill_(1.0)) if flush == "write" else buf.sum

    def run(n):
        for _ in range(n):
            sweep()
            fn()
    run(warmup)
    acts = [v for name, v in device_kernels(lambda: run(iters)).items()
            if kernel in name]
    n = sum(c for c, _ in acts)
    return sum(ms for _, ms in acts) / n if n else None


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def tte_row(gen, B: int, V: int, cold: bool = False) -> dict:
    """``tte_sample`` on (B, V) fp32 logits and uniforms against its plain
    version; the bound counts each input read once and (event, t_min)
    written once, and exp, log and a multiply an element on the CUDA
    cores.  With ``cold`` the kernel's device time is taken after an L2
    flush that writes 128 MB (``cold_device_ms``), and beside it after one
    that reads 128 MB, and warm."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import tte_sample as tk
    lg = torch.randn((B, V), generator=gen, device=DEVICE) * 3 - 8
    u = torch.rand((B, V), generator=gen, device=DEVICE)
    b_ms, b_by = bound(2 * B * V * 4 + B * 8, 3 * B * V, "float32_simt")

    def fn():
        return tk.tte_sample_cuda(lg, u)
    row = {"shape": f"B={B} V={V} fp32" + (", L2 cold" if cold else ""),
           "plan": tk.plan(B, V), "kernel": measure(fn),
           "plain": measure(lambda: ref.tte_sample_ref(lg, u)),
           "library": None, "bound_ms": b_ms, "bound_by": b_by}
    if cold:
        row["kernel warm"] = row["kernel"]
        row["kernel"] = {"device_ms": cold_device_ms(fn, "tte_sample"),
                         "call_ms": None}
        row["kernel cold, read flush"] = {
            "device_ms": cold_device_ms(fn, "tte_sample", flush="read"),
            "call_ms": None}
    return row


def flash_row(gen, nb: int, H: int, sb: int, hd: int) -> dict:
    """``flash_attention`` at one prefill bucket: (nb, H, sb, hd) bf16,
    causal, against its plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    q, k, v = (torch.randn((nb, H, sb, hd), generator=gen, device=DEVICE
                           ).to(torch.bfloat16) for _ in range(3))
    nbytes = 4 * nb * H * sb * hd * 2
    flops = 4 * nb * H * hd * sb * (sb + 1) / 2
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    return {
        "shape": f"B={nb} H={H} S={sb} hd={hd} causal bf16",
        "kernel": measure(lambda: fk.flash_attention_cuda(q, k, v,
                                                          causal=True)),
        "plain": measure(lambda: ref.flash_attention_ref(q, k, v,
                                                         causal=True)),
        "library": measure(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": b_ms, "bound_by": b_by}


def flash_pos_row(gen, B: int = 1, Sc: int = 64, C: int = 128, H: int = 12,
                  hd: int = 10) -> dict:
    """``flash_attention`` with position masks at phase 3e's chunk: B 1, 64
    queries at positions 128..191 over 128 context keys and the chunk's 64
    (192 keys), 12 heads, hd 10, bf16, on the concatenated K/V that
    ``ops.suffix_prefill_attention`` hands the kernel.  The bound counts
    q, k, v and the output once, both position arrays, and the products of
    the valid (query, key) pairs only (each query sees the context and the
    chunk up to itself).  The plain version is
    ``ref.flash_attention_ref`` with the positions; the library call builds
    the boolean mask from the positions and runs SDPA with it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    T = C + Sc
    q = torch.randn((B, Sc, H, hd), generator=gen, device=DEVICE
                    ).to(torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, T, H, hd), generator=gen, device=DEVICE
                        ).to(torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    kpos = torch.arange(T, dtype=torch.int32, device=DEVICE)[None].expand(
        B, T).contiguous()
    qpos = kpos[:, C:].contiguous()
    pairs = B * sum(C + i + 1 for i in range(Sc))
    nbytes = 2 * (2 * B * H * Sc * hd + 2 * B * H * T * hd) + 4 * B * (Sc + T)
    b_ms, b_by = bound(nbytes, 4 * H * hd * pairs, "bfloat16")

    def library():
        m = (kpos[:, None, :] <= qpos[:, :, None]) & (kpos[:, None, :] >= 0)
        return F.scaled_dot_product_attention(q, k, v,
                                              attn_mask=m[:, None])
    out = fk.flash_attention_cuda(q, k, v, q_pos=qpos, k_pos=kpos)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   q_pos=qpos, k_pos=kpos)
    torch.cuda.synchronize()
    err = float((out.float() - want).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"flash_attention positions row: err {err}")
    return {
        "shape": f"B={B} H={H} Sc={Sc} keys={C}+{Sc} hd={hd} bf16, by "
                 f"position, {pairs} valid pairs a head",
        "kernel": measure(lambda: fk.flash_attention_cuda(
            q, k, v, q_pos=qpos, k_pos=kpos)),
        "plain": measure(lambda: ref.flash_attention_ref(
            q, k, v, q_pos=qpos, k_pos=kpos)),
        "library": measure(library), "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err}


def paged_row(gen, kl, vl, pos, step, note: str) -> dict:
    """``paged_decode_attention`` on one layer's ring viewed as a pool of
    one block per slot, against its plain version and SDPA with a mask.
    The bound counts the K/V rows of the valid tokens only."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ref
    Bs, Hkv, W, hd = kl.shape
    table = torch.arange(Bs, dtype=torch.int32, device=DEVICE)[:, None]
    q4 = torch.randn((Bs, Hkv, 1, hd), generator=gen, device=DEVICE
                     ).to(kl.dtype)
    valid = (pos >= 0) & (pos <= step[:, None]) & (pos > step[:, None] - W)
    n_valid = int(valid.sum())
    nbytes = (q4.numel() * 2 * 2 + 2 * n_valid * Hkv * hd * 2 + pos.numel() * 4
              + Bs * 8)
    flops = 4 * n_valid * Hkv * hd
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    mask = valid[:, None, None, :]
    return {
        "shape": f"B={Bs} Hkv={Hkv} G=1 hd={hd} bs=W={W} nbs=1 bf16, "
                 f"{n_valid} valid tokens ({note})",
        "kernel": measure(lambda: pk.paged_decode_attention_cuda(
            q4, kl, vl, table, pos, step)),
        "plain": measure(lambda: ref.paged_decode_attention_ref(
            q4, kl, vl, table, pos, step)),
        "library": measure(lambda: F.scaled_dot_product_attention(
            q4, kl, vl, attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": b_by}


def paged_pool_row(gen, eng) -> dict:
    """``paged_decode_attention`` at the paged Delphi path's pool: the
    tokens of layer 0 of the ring run's cache (phase 3, whose tokens the
    paged run of phase 3c reproduces) laid out in 16-token blocks scattered
    at random over a 257-block pool, table columns of blocks with no valid
    token -1, and the trash block 0 holding positions that no table points
    at.  Held against the plain version and, bit for bit, against the
    kernel on the ring.  The bound counts q in and out, the valid tokens'
    K/V rows, the table, the allocated blocks' positions and the steps.
    The library call is the pool gathered through the table and SDPA with
    the mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ref
    lc = eng.cache["self"]
    kl, vl, rpos = lc.k[0], lc.v[0], lc.pos[0]
    step = eng._state["step"]
    B, Hkv, W, hd = kl.shape
    bs = 16
    nbs, NB = W // bs, 1 + B * (W // bs)
    valid = (rpos >= 0) & (rpos <= step[:, None]) & (rpos > step[:, None] - W)
    used = valid.reshape(B, nbs, bs).any(-1)
    perm = (torch.randperm(NB - 1, generator=gen, device=DEVICE) + 1
            ).reshape(B, nbs).to(torch.int32)
    table = torch.where(used, perm, torch.full_like(perm, -1))
    kp = torch.randn((NB, Hkv, bs, hd), generator=gen, device=DEVICE
                     ).to(kl.dtype)
    vp = torch.randn_like(kp)
    pp = torch.full((NB, bs), -1, dtype=torch.int32, device=DEVICE)
    ids = table[used].long()
    kp[ids] = kl.reshape(B, Hkv, nbs, bs, hd).permute(0, 2, 1, 3, 4)[used]
    vp[ids] = vl.reshape(B, Hkv, nbs, bs, hd).permute(0, 2, 1, 3, 4)[used]
    pp[ids] = rpos.reshape(B, nbs, bs)[used]
    pp[0] = step[0] - torch.arange(bs, dtype=torch.int32, device=DEVICE)
    q4 = torch.randn((B, Hkv, 1, hd), generator=gen, device=DEVICE
                     ).to(kl.dtype)
    n_valid, n_alloc = int(valid.sum()), int(used.sum())
    nbytes = (q4.numel() * 2 * 2 + 2 * n_valid * Hkv * hd * 2
              + table.numel() * 4 + n_alloc * bs * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4 * n_valid * Hkv * hd, "bfloat16")
    out = pk.paged_decode_attention_cuda(q4, kp, vp, table, pp, step)
    ring = pk.paged_decode_attention_cuda(
        q4, kl, vl, torch.arange(B, dtype=torch.int32, device=DEVICE)[:, None],
        rpos, step)
    want = ref.paged_decode_attention_ref(q4, kp, vp, table, pp, step)
    torch.cuda.synchronize()
    err = float((out.float() - want).abs().max())
    if not (err <= 2e-2 and torch.equal(out, ring)):
        raise AssertionError(f"paged pool: err {err} (tol 2e-2), equal to "
                             f"the ring's: {torch.equal(out, ring)}")

    def library():
        safe = table.clamp(min=0).long()
        kk = kp[safe].permute(0, 2, 1, 3, 4).reshape(B, Hkv, W, hd)
        vv = vp[safe].permute(0, 2, 1, 3, 4).reshape(B, Hkv, W, hd)
        p = torch.where(table[:, :, None] >= 0, pp[safe], -1).reshape(B, W)
        m = (p >= 0) & (p <= step[:, None]) & (p > step[:, None] - W)
        return F.scaled_dot_product_attention(q4, kk, vv,
                                              attn_mask=m[:, None, None, :])
    return {
        "shape": f"B={B} Hkv={Hkv} G=1 hd={hd} bs={bs} nbs={nbs} NB={NB} "
                 f"bf16, {n_valid} valid tokens in {n_alloc} blocks (the "
                 f"run's tokens, paged)",
        "kernel": measure(lambda: pk.paged_decode_attention_cuda(
            q4, kp, vp, table, pp, step)),
        "plain": measure(lambda: ref.paged_decode_attention_ref(
            q4, kp, vp, table, pp, step)),
        "library": measure(library), "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err}


def times(main: dict, mamba: dict, gen) -> dict:
    """Kernel, plain version and library call at the main paths' shapes:
    device time per call (profiler) and per-call time (CUDA events).  The
    first four keys are the ``kernels`` line's rows; ``launch floor`` is
    PyTorch's smallest kernel (a one-element ``zero_()``) timed the same
    way, the least a launch costs, below which no bound can be seen."""
    import torch
    eng = main["engine"]
    res = {}

    # tte_sample: one tick's sampling, (slots, V) fp32, L2-warm as on the
    # path (the head's logits were just written)
    B, V = eng.slots, eng.cfg.vocab_size
    res["tte_sample"] = tte_row(gen, B, V)

    # flash_attention: the largest prefill bucket the main path ran
    nb, sb = max(eng.prefill_shapes, key=lambda s: s[0] * s[1] * s[1])
    H, hd = eng.cfg.n_heads, eng.cfg.head_dim
    res["flash_attention"] = flash_row(gen, nb, H, sb, hd)

    # paged_decode_attention: one layer of one tick on the main path's ring
    # (layer 0's K/V and positions as the run left them)
    lc = eng.cache["self"]
    kl, vl, pos = lc.k[0], lc.v[0], lc.pos[0]
    step = eng._state["step"]
    res["paged_decode_attention"] = paged_row(gen, kl, vl, pos, step,
                                              "the run's ring")
    # the same tokens in the paged path's pool (phase 3c)
    res["paged_decode_attention paged pool"] = paged_pool_row(gen, eng)

    # ssd_intra: one layer's call at a 1024-token prompt (the main row) and
    # at a one-chunk prompt
    for key, S in (("ssd_intra", 1024), ("ssd_intra S=128", 128)):
        res[key] = ssd_row(gen, mamba["cfg"], S)

    # the longest prefill bucket the engine admits at max_context 256
    res["flash_attention S=256"] = flash_row(gen, 4, H, eng.max_context, hd)
    # the position-masked route at phase 3e's chunk
    res["flash_attention positions"] = flash_pos_row(gen, H=H, hd=hd)
    # a full ring: every slot holds W valid positions (a long history
    # decoding near max_context), on the same K/V
    W = kl.shape[2]
    full_step = (W + 44 + 37 * torch.arange(kl.shape[0], device=DEVICE)
                 ).to(torch.int32)
    j = torch.arange(W, device=DEVICE)
    full_pos = (full_step[:, None] - torch.remainder(
        full_step[:, None] - j[None, :], W)).to(torch.int32)
    res["paged_decode_attention full ring"] = paged_row(
        gen, kl, vl, full_pos, full_step, "full ring")

    # the zoo's largest vocabulary (seamless, 256,206 tokens) at the same
    # slots: device time with a cold L2, kernel only; warm beside it
    res["tte_sample V=256206"] = tte_row(gen, B, 256206, cold=True)

    z = torch.zeros(1, device=DEVICE)
    res["launch floor"] = {"shape": "one-element zero_()",
                           "kernel": measure(lambda: z.zero_())}
    return res


def ssd_bound(xdt, Bm, cum) -> dict:
    """Bound of one ``ssd_intra`` call from what its inputs need: each input
    read once (B and C once per batch row where their head stride is 0),
    y and the states written once; C.B^T and G.xdt over their causal
    triangle only (L is 0 above the diagonal), C.B^T once per (batch row,
    chunk) where the heads share B/C, the state product in full.  The
    operations term is at the fp32-accurate tensor-core rate (three TF32
    passes); the fp32 CUDA-core term is returned beside it."""
    b, c, Q, H, P = xdt.shape
    N = Bm.shape[-1]
    hb = 1 if Bm.stride(3) == 0 else H
    nbytes = (2 * xdt.numel() * xdt.element_size()          # xdt in, y out
              + 2 * b * c * Q * hb * N * Bm.element_size()  # B, C
              + cum.numel() * 4 + b * c * H * N * P * 4)      # cum, states
    flops = b * c * (hb * Q * (Q + 1) * N
                     + H * (Q * (Q + 1) * P + 2 * Q * N * P))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32_3xtf32"] * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": t_bytes,
            "ops_ms": t_ops,
            "ops_simt_ms": flops / PEAK_FLOPS["float32_simt"] * 1e3,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ssd_row(gen, mc, S: int) -> dict:
    """``ssd_intra`` at an S-token prompt in the model's layout: fp32 xdt;
    bf16 B and C sliced out of xBC and broadcast over the heads by a 0
    stride."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk
    Q, H, P, N, di = (mc.ssm_chunk, mc.ssm_n_heads, mc.ssm_head_dim,
                      mc.ssm_state, mc.d_inner)
    c = S // Q
    xBC = torch.randn((1, S, di + 2 * N), generator=gen, device=DEVICE
                      ).to(torch.bfloat16)
    Bm = xBC[..., di:di + N].reshape(1, c, Q, 1, N).expand(1, c, Q, H, N)
    Cm = xBC[..., di + N:].reshape(1, c, Q, 1, N).expand(1, c, Q, H, N)
    xdt = torch.randn((1, c, Q, H, P), generator=gen, device=DEVICE)
    cum = -torch.cumsum(0.05 * torch.rand((1, c, Q, H), generator=gen,
                                          device=DEVICE), dim=2)
    bd = ssd_bound(xdt, Bm, cum)
    return {
        "shape": f"S={S}: b=1 C={c} Q={Q} H={H} P={P} N={N}, xdt fp32, "
                 f"B/C bf16 shared by the heads",
        "kernel": measure(lambda: sk.ssd_intra_cuda(xdt, Bm, Cm, cum)),
        "plain": measure(lambda: ref.ssd_intra_ref(
            xdt.transpose(2, 3), Bm[:, :, :, :1].transpose(2, 3),
            Cm[:, :, :, :1].transpose(2, 3), cum.transpose(2, 3))),
        "library": None, "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"], "bound_terms": bd}


def path_profile(run, wall: float) -> dict:
    """A path once more, the same requests and seed, under the profiler
    (``run()`` returns the wall seconds of its engine run): the device's
    busy time against ``wall`` (the same run without the profiler, whose
    host-side tracing slows the launches), and the kernels that take the
    device time."""
    box = {}

    def go():
        box["seconds"] = run()
    kernels = device_kernels(go)
    busy = sum(ms for _, ms in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    ssd = [v for name, v in kernels.items() if "ssd_intra" in name]
    return {"wall_s": wall, "profiled_wall_s": box["seconds"],
            "device_busy_s": busy,
            "ssd_intra": {"launches": sum(n for n, _ in ssd),
                          "ms": sum(ms for _, ms in ssd)},
            "idle_share": (1.0 - busy / wall) if busy else None,
            "launches": sum(n for n, _ in kernels.values()),
            "top": [{"kernel": name[:80], "launches": n, "ms": ms}
                    for name, (n, ms) in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    smi = nvidia_smi()
    log("== phase 1: environment")
    log(f"  card: {smi}; {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    log(f"  kernels built in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {build.last_build.get('seconds', 0.0):.1f}s)")
    for line in str(build.last_build.get("log", "")).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("    " + line.strip())

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    log("== phase 2: kernels against their plain versions on the card")
    errs = {"tte_sample": check_tte(gen), "flash_attention": check_flash(gen),
            "flash_attention positions": check_flash_positions(gen),
            "paged_decode_attention": check_paged(gen),
            "ssd_intra": check_ssd(gen)}

    log("== phase 3: Delphi path (Delphi-2M bf16, ring BatchedEngine, 16 "
        "slots)")
    main_res = main_path()
    eng, sec = main_res["engine"], main_res["seconds"]
    log(f"  {len(main_res['done'])} requests, {main_res['events']} events, "
        f"{eng.ticks} ticks, {eng.admit_batches} admission batches in "
        f"{sec:.3f}s: {main_res['events'] / sec:.1f} events/s, "
        f"{eng.ticks / sec:.1f} ticks/s; host_syncs {eng.host_syncs}; "
        f"prefill shapes {sorted(eng.prefill_shapes)}; launches "
        f"{main_res['launches']}")

    log("== phase 3c: paged Delphi path (Delphi-2M bf16, paged "
        "BatchedEngine, 16 slots, 16-token blocks, 257 blocks)")
    paged = main_path("paged")
    peng, psec = paged["engine"], paged["seconds"]
    if [(r.out_tokens, r.out_ages) for r in paged["done"]] != \
            [(r.out_tokens, r.out_ages) for r in main_res["done"]]:
        raise AssertionError("the paged path's trajectories differ from the "
                             "ring path's")
    pst = peng.pool_stats()
    log(f"  {len(paged['done'])} requests, {paged['events']} events, "
        f"{peng.ticks} ticks, {peng.admit_batches} admission batches in "
        f"{psec:.3f}s: {paged['events'] / psec:.1f} events/s, "
        f"{peng.ticks / psec:.1f} ticks/s (ring, phase 3: "
        f"{main_res['events'] / sec:.1f} events/s, {eng.ticks / sec:.1f} "
        f"ticks/s); host_syncs {peng.host_syncs}; paged_decode_attention "
        f"{paged['launches']['paged_decode_attention'] / peng.ticks:.1f} "
        f"launches a tick; blocks_peak_used {pst['blocks_peak_used']} of "
        f"{pst['blocks'] - 1}; cache_bytes {pst['cache_bytes']} (ring "
        f"{eng.cache_bytes}); trajectories equal phase 3's; launches "
        f"{paged['launches']}")
    # wall time varies with the host: ring and paged in turns, one call
    from repro_torch.launch import serve as launch
    turns = []
    for cache in ("ring", "paged", "paged", "ring"):
        o = launch.serve(serve_args(32, 48, cache))
        turns.append((cache, o["events"] / o["seconds"]))
    log("  in turns, events/s: " + ", ".join(f"{c} {r:.1f}"
                                             for c, r in turns))

    log("== phase 3d: futures (Delphi-2M bf16, prefix-cached paged "
        f"BatchedEngine, 16 slots): {FUTURES_PATIENTS} patients x "
        f"{FUTURES_N} futures x {FUTURES_MAX_NEW} events, each patient twice")
    fut = futures_path()
    feng, fsec, fst = fut["engine"], fut["seconds"], fut["stats"]
    log(f"  {len(fut['prompt_lengths'])} patients (prompts "
        f"{fut['prompt_lengths']} events), {fut['events']} future events, "
        f"{feng.ticks} ticks, {feng.admit_batches} admission batches in "
        f"{fsec:.3f}s: {fut['events'] / fsec:.1f} events/s, "
        f"{feng.ticks / fsec:.1f} ticks/s; host_syncs {feng.host_syncs}; "
        f"forks {fst['forks']}, cow_copies {fst['cow_copies']}, "
        f"shared_blocks_peak {fst['shared_blocks_peak']}, blocks_peak_used "
        f"{fst['blocks_peak_used']} (64 unshared admissions: "
        f"{fut['unshared_blocks']} blocks for their prompts alone); prefix "
        f"hits {fst['prefix_cache']['hits']} of 8 parents, prefill shapes "
        f"{sorted(feng.prefill_shapes)}; launches {fut['launches']}; no "
        f"block or refcount left after drop_prefix_cache()")

    log(f"== phase 3e: mixed long/short traffic (Delphi-2M bf16, paged "
        f"BatchedEngine, {MIXED_SLOTS} slots, max_context 256, 16-token "
        f"blocks, {MIXED_BLOCKS} blocks): {MIXED_SHORT} short requests "
        f"(6-event prompts, 48 new) and {MIXED_LONG} long ones "
        f"({MIXED_S_LONG}-event prompts, 4 new), one long every 8 steps from "
        f"step 3; monolithic and chunked ({MIXED_CHUNK} tokens a step) in "
        f"turns")
    mixed = mixed_path()
    for mode, r in mixed["runs"]:
        log(f"  {mode}: {r['events']} events in {r['wall_s']:.3f}s: "
            f"{r['events_per_s']:.1f} events/s; short requests' per-event "
            f"latency p50 {r['p50_ms']:.3f} ms, p95 {r['p95_ms']:.3f} ms "
            f"({r['short_events']} events); {r['ticks']} ticks, "
            f"{r['admit_batches']} admission batches, host_syncs "
            f"{r['host_syncs']} (= ticks + admission batches); chunks "
            f"{r['chunks']}; pool drained")
    mst = mixed["stats"]
    log(f"  chunked engine over its 3 drives: chunked_prefills "
        f"{mst['chunked_prefills']}, prefill_chunks {mst['prefill_chunks']}, "
        f"chunk shapes (kind, context blocks, width) "
        f"{mixed['chunk_shapes']}; monolithic prefill shapes "
        f"{mixed['monolithic_shapes']}; launches of the first timed chunked "
        f"drive {mixed['launches']}")

    log("== phase 3f: partial-hit suffix prefill (prefix-cached chunked "
        "engine): a 200-event prompt, then a 240-event prompt extending it")
    sfx = suffix_path(fut["params"], fut["cfg"])
    log(f"  suffix_tokens_saved {sfx['stats']['suffix_tokens_saved']} (the "
        f"matched block-aligned prefix: {sfx['matched']}), the suffix in "
        f"{sfx['suffix_chunks']} chunk; prefix partial hits "
        f"{sfx['stats']['prefix_cache']['partial_hits']}; shapes "
        f"{sfx['shapes']}; no block left after drop_prefix_cache()")

    log("== phase 3g: HTTP serving (Delphi-2M bf16, EngineBackend on its "
        "background loop behind InferenceServer: 16 slots, paged, prefix "
        f"cache): {HTTP_REQUESTS} prompts x {HTTP_MAX_NEW} events from "
        f"{HTTP_CLIENTS} clients, {HTTP_STREAMS} streams, futures, risk")
    t3g = time.perf_counter()
    http = http_path(fut["params"], fut["cfg"], fut["patients"])
    hp = http["profile"]
    log(f"  /v1/generate: {http['events']} events in {http['wall_s']:.3f}s:"
        f" {http['events_per_s']:.1f} events/s; {http['ticks']} ticks, "
        f"{http['admit_batches']} admission batches, host_syncs "
        f"{http['host_syncs']}; launches {http['launches']}")
    log("  in turns, events/s: " + ", ".join(
        f"{m} {r:.1f}" for m, r in http["turns"])
        + f"; HTTP / in-process {http['http_over_inprocess']:.3f}")
    log(f"  SSE time to first event over {http['sse_streams']} streams "
        f"(listen backlog {http['sse_backlog']}): p50 "
        f"{http['sse_ttfe_p50_ms']:.2f} ms, p95 "
        f"{http['sse_ttfe_p95_ms']:.2f} ms; with the stdlib's backlog of 5, "
        f"in turns (5, {http['sse_backlog']}, {http['sse_backlog']}, 5): p50 "
        f"{http['sse_ttfe_backlog5_p50_ms']:.2f} ms, p95 "
        f"{http['sse_ttfe_backlog5_p95_ms']:.2f} ms; futures events "
        f"{http['futures_events']}; /v1/risk == core/risk.py (max rel err "
        f"{http['risk_max_rel_err']:.3g})")
    log(f"  one HTTP run under the profiler: device busy "
        f"{hp['device_busy_s']:.4f}s of {hp['wall_s']:.3f}s wall, idle share"
        f" {'not measured' if hp['idle_share'] is None else format(hp['idle_share'], '.3f')}")
    log(f"  fresh server == twin engine bit for bit on {HTTP_EXACT} "
        f"prompts ({http['exact']['generate_events']} events), stream == "
        f"generate, futures == ring_reference_futures "
        f"({http['exact']['futures_events']} events); CLI booted in "
        f"{http['cli']['boot_s']:.1f}s, exit {http['cli']['exit_code']} on "
        f"SIGINT ({http['cli']['lines'][0]})")
    log(f"  phase 3g took {time.perf_counter() - t3g:.1f}s")
    log("== phase 3h: the router on one card (RouterServer over 2 "
        "in-process paged replicas)")
    t3h = time.perf_counter()
    rtr = router_path(fut["params"], fut["cfg"], fut["patients"])
    log(f"  futures visits: first {rtr['visits'][0]}, second "
        f"{rtr['visits'][1]}; scheduler {rtr['scheduler']}; drained r0 "
        f"under load with every request answered; router == direct bit "
        f"for bit on {rtr['exact_prompts']} prompts")
    log(f"  phase 3h took {time.perf_counter() - t3h:.1f}s")

    log("== phase 3b: Mamba2 path (Mamba2-780M bf16, BatchedEngine, 8 "
        "slots)")
    mamba = mamba_path()
    meng, msec = mamba["engine"], mamba["seconds"]
    log(f"  {MAMBA_REQUESTS} requests, {mamba['tokens']} tokens, "
        f"{meng.ticks} ticks, {meng.admit_batches} admissions in {msec:.3f}s"
        f": {mamba['tokens'] / msec:.1f} tokens/s, {meng.ticks / msec:.1f} "
        f"ticks/s; host_syncs {meng.host_syncs}; prefill shapes "
        f"{sorted(meng.prefill_shapes)}; launches {mamba['launches']}")

    log("== phase 4: end-to-end parity, fp32, card vs CPU")
    par = parity()
    mpar = mamba_parity()
    log("== phase 4 (paged): ring == paged and fork == oracle on the card, "
        "injected uniforms")
    ppar = paged_parity()
    log("== phase 4 (chunked): the paged engine == chunked_reference_"
        "trajectory on the card, injected uniforms")
    cpar = chunked_parity()
    log("== phase 4 (risk): risk on the card")
    rsk = risk_checks(fut)

    log("== phase 5: times at the main paths' shapes")
    tm = times(main_res, mamba, gen)

    def fmt(m):
        if m is None:
            return "n/a"
        dev = ("not measured" if m["device_ms"] is None
               else f"{m['device_ms']:.5f} ms")
        if m["call_ms"] is None:
            return f"device {dev}"
        return f"device {dev} / per call {m['call_ms']:.5f} ms"
    floor = tm.pop("launch floor")["kernel"]
    floor_ms = floor["device_ms"]
    log(f"  launch floor [one-element zero_()]: {fmt(floor)}")
    floor_txt = ("not measured" if floor_ms is None
                 else f"{floor_ms:.6f} ms")
    for name, t in tm.items():
        warm = (f" (after a read flush: {fmt(t['kernel cold, read flush'])};"
                f" warm: {fmt(t['kernel warm'])})" if "kernel warm" in t
                else "")
        plan = f" {t['plan']}" if "plan" in t else ""
        log(f"  {name} [{t['shape']}]{plan}: kernel {fmt(t['kernel'])}{warm};"
            f" plain {fmt(t['plain'])}; library {fmt(t['library'])}; bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}), launch floor "
            f"{floor_txt}")
        if "bound_terms" in t:
            bt = t["bound_terms"]
            log(f"    bound terms: {bt['bytes'] / 1e6:.3f} MB -> "
                f"{bt['bytes_ms']:.6f} ms at 3.35 TB/s; {bt['flops'] / 1e9:.4f}"
                f" GFLOP -> {bt['ops_ms']:.6f} ms at 165 TFLOP/s (3xTF32), "
                f"{bt['ops_simt_ms']:.6f} ms at 67 TFLOP/s (fp32 CUDA cores)")
    prof = path_profile(
        lambda: launch.serve(serve_args(32, 48))["seconds"], sec)
    pprof = path_profile(
        lambda: launch.serve(serve_args(32, 48, "paged"))["seconds"], psec)
    fprof = path_profile(
        lambda: futures_run(fut["params"], fut["cfg"], fut["patients"])[2],
        fsec)
    mprof = path_profile(
        lambda: mamba_serve(mamba["params"], mamba["cfg"], mamba["prompts"],
                            MAMBA_MAX_NEW)[2], msec)
    xwall = {m: r["wall_s"] for m, r in mixed["runs"]}
    xprof = {m: path_profile(
        lambda m=m: mixed_drive(mixed["engines"][m])["wall_s"], xwall[m])
        for m in ("monolithic", "chunked")}
    for name, p, ph in (("Delphi", prof, "3"), ("paged Delphi", pprof, "3c"),
                        ("futures", fprof, "3d"),
                        ("mixed monolithic", xprof["monolithic"], "3e"),
                        ("mixed chunked", xprof["chunked"], "3e"),
                        ("Mamba2", mprof, "3b")):
        idle = ("not measured" if p["idle_share"] is None
                else f"{p['idle_share']:.3f}")
        log(f"  {name} path: device busy {p['device_busy_s']:.4f}s of "
            f"{p['wall_s']:.3f}s wall (phase {ph}), idle share {idle}; "
            f"{p['launches']} device activities ({p['profiled_wall_s']:.3f}"
            f"s wall under the profiler); top by device time:")
        for t in p["top"]:
            log(f"    {t['ms']:9.3f} ms  {t['launches']:6d}x  {t['kernel']}")
    log(f"  Mamba2 path: ssd_intra kernels {mprof['ssd_intra']['ms']:.3f} ms "
        f"of device time over {mprof['ssd_intra']['launches']} launches")

    def ms(m):
        """Device time where the profiler saw it, else the per-call time."""
        if m is None:
            return None
        return m["device_ms"] if m["device_ms"] is not None else m["call_ms"]
    # each kernel's launches come from the run of its own path: this
    # slice's paged Delphi path (phase 3c) for the Delphi kernels, with the
    # paged kernel timed at the paged pool; the Mamba2 path for ssd_intra
    rows = dict(tm)
    rows["paged_decode_attention"] = tm["paged_decode_attention paged pool"]
    errs["paged_decode_attention"] = rows["paged_decode_attention"][
        "max_abs_err"]
    launches = {name: (mamba["launches"][name] if name == "ssd_intra"
                       else paged["launches"][name]) for name in REPLACES}
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "path": "3b" if name == "ssd_intra" else "3c",
        "max_abs_err": errs[name], "ms": ms(rows[name]["kernel"]),
        "plain_ms": ms(rows[name]["plain"]),
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": ms(rows[name]["library"]),
        "call_ms": rows[name]["kernel"]["call_ms"]} for name in REPLACES]
    # the flash kernel's position-masked route, on the chunked path (3e)
    prow = rows["flash_attention positions"]
    kernels.append({
        "name": "flash_attention positions", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"],
        "launches": mixed["launches"]["flash_positions"], "path": "3e",
        "max_abs_err": errs["flash_attention positions"],
        "ms": ms(prow["kernel"]), "plain_ms": ms(prow["plain"]),
        "bound_ms": prow["bound_ms"], "bound_by": prow["bound_by"],
        "library_ms": ms(prow["library"]),
        "call_ms": prow["kernel"]["call_ms"]})
    record = {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_seconds": build.last_build.get("seconds"),
        "kernel_errors": errs, "times": tm, "launch_floor": floor,
        "kernels": kernels,
        "main_path_profile": prof, "mamba_path_profile": mprof,
        "paged_path_profile": pprof, "futures_path_profile": fprof,
        "paged_path": {"requests": len(paged["done"]),
                       "events": paged["events"], "seconds": psec,
                       "ticks": peng.ticks,
                       "admit_batches": peng.admit_batches,
                       "host_syncs": peng.host_syncs,
                       "prefill_shapes": sorted(peng.prefill_shapes),
                       "launches": paged["launches"], "pool": pst,
                       "ring_cache_bytes": eng.cache_bytes,
                       "events_per_s_in_turns": turns},
        "futures_path": {"events": fut["events"], "seconds": fsec,
                         "ticks": feng.ticks,
                         "admit_batches": feng.admit_batches,
                         "host_syncs": feng.host_syncs,
                         "prompt_lengths": fut["prompt_lengths"],
                         "prefill_shapes": sorted(feng.prefill_shapes),
                         "launches": fut["launches"], "pool": fst,
                         "unshared_prompt_blocks": fut["unshared_blocks"],
                         "index_blocks_freed": fut["index_blocks_freed"]},
        "paged_parity": ppar, "chunked_parity": cpar, "risk": rsk,
        "mixed_path": {"runs": mixed["runs"], "launches": mixed["launches"],
                       "pool": mst, "chunk_shapes": mixed["chunk_shapes"],
                       "monolithic_shapes": mixed["monolithic_shapes"],
                       "profiles": xprof},
        "suffix_path": {"pool": sfx["stats"], "matched": sfx["matched"],
                        "suffix_chunks": sfx["suffix_chunks"]},
        "http_path": http, "router_path": rtr,
        "main_path": {"requests": len(main_res["done"]),
                      "events": main_res["events"], "seconds": sec,
                      "ticks": eng.ticks, "admit_batches": eng.admit_batches,
                      "host_syncs": eng.host_syncs,
                      "prefill_shapes": sorted(eng.prefill_shapes),
                      "launches": main_res["launches"]},
        "mamba_path": {"requests": MAMBA_REQUESTS, "tokens": mamba["tokens"],
                       "seconds": msec, "ticks": meng.ticks,
                       "admit_batches": meng.admit_batches,
                       "host_syncs": meng.host_syncs,
                       "prefill_shapes": sorted(meng.prefill_shapes),
                       "launches": mamba["launches"]},
        "mamba_parity": {"steps": mpar["held"]["steps"],
                         "near_ties": len(mpar["held"]["near_ties"]),
                         "free_compared": mpar["free"]["compared"],
                         "divergences": mpar["free"]["divergences"]},
        "parity": {"steps": par["held"]["steps"],
                   "near_ties": len(par["held"]["near_ties"]),
                   "max_age_rel_err": par["held"]["max_age_rel_err"],
                   "free_compared": par["free"]["compared"],
                   "divergences": par["free"]["divergences"]}}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
