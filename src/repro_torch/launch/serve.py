"""Serving launcher of the port: batched generation through the engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch delphi-2m \
        [--requests 16] [--slots 8] [--max-new 48] [--cache ring|paged] \
        [--prefill-chunk-tokens N] [--ckpt DIR] [--device cuda] \
        [--replicas N]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m ...
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        [--max-context 4096] ...
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        [--max-context 1024] ...

The command line of ``repro.launch.serve``, plus ``--device``, ``--cache``,
``--prefill-chunk-tokens`` and ``--max-context``.  The prompts are the
first halves of synthetic patient histories for Delphi, Mamba2 and
Zamba2 (which read their event ids as tokens and ignore the ages, as the
JAX launcher serves every architecture), and seeded random token ids of
16-128 tokens for a generic dense LM (TinyLlama, H2O-Danube, Qwen2.5,
DeepSeek: their vocabularies are not the event vocabulary).  The engine's
``max_context`` is ``--max-context``, by default ``cfg.max_seq_len``
(32,768 for the generic LMs: pass a smaller one to keep the ring small;
Zamba2's 1,048,576 costs nothing, its rings are the window's 4,096
wide).  On ``cuda`` activations run in ``cfg.dtype`` (bf16); on the CPU
in fp32.  Parameters stay fp32 and come from ``--ckpt`` (a JAX
``params.npz`` checkpoint) or from ``init_params(seed)``.  ``--cache
paged`` serves from a pool of 16-token blocks with the ring's bytes (an
attention model only), and
``--prefill-chunk-tokens N`` prefills its prompts in chunks of at most N
tokens a step between decode ticks (a multiple of the block size; refused
without ``--cache paged``).  ``--replicas N`` shards the requests over N
engines on the one device through the HTTP router's
``PrefixAffinityScheduler`` (shared history prefixes land on the engine
whose pool holds them), and the engines tick on concurrent background
threads, all launching on the device's default stream.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, HYBRID, SSM, get_config
from repro_torch.data import SimulatorConfig, generate_dataset
from repro_torch.data import vocab as V
from repro_torch.models import init_params, load_checkpoint
from repro_torch.serve import BatchedEngine, Request


class _EngineShard:
    """Just enough of ``ReplicaHandle``'s surface (``name``, ``inflight``,
    ``free_blocks``) for the affinity scheduler to rank local engines."""

    def __init__(self, name: str, engine: BatchedEngine):
        self.name = name
        self.engine = engine
        self.requests: list = []

    @property
    def inflight(self) -> int:
        return len(self.requests)

    def free_blocks(self):
        return self.engine.pool_stats().get("blocks_free")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="delphi-2m", choices=ALL_ARCHS)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="shard requests across N engines via the router's "
                         "prefix-affinity scheduler")
    ap.add_argument("--cache", choices=("ring", "paged"), default="ring")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    metavar="N",
                    help="--cache paged: prefill in N-token chunks "
                         "interleaved with decode ticks (multiple of the "
                         "16-token block size)")
    ap.add_argument("--max-context", type=int, default=None,
                    help="each slot's context (default: the config's "
                         "max_seq_len)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.prefill_chunk_tokens is not None and args.cache != "paged":
        ap.error("--prefill-chunk-tokens requires --cache paged")
    return args


def lm_prompts(n: int, vocab: int, seed: int, lo: int = 16,
               hi: int = 128) -> List[np.ndarray]:
    """``n`` prompts of seeded random token ids, ``lo``-``hi`` tokens."""
    rng = np.random.default_rng(seed + 17)
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(S)).astype(np.int32) for S in lens]


def serve(args: argparse.Namespace) -> Dict[str, Any]:
    """Build the engine, serve synthetic patient prompts, and return the
    engine, the finished requests, the wall time and the emitted events
    (tokens for a generic LM)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if device.type == "cpu":
        cfg = cfg.replace(dtype="float32")
    if args.ckpt:
        params = load_checkpoint(args.ckpt, cfg, device)
    else:
        params = init_params(cfg, args.seed, device)
    max_context = getattr(args, "max_context", None) or cfg.max_seq_len
    shards = [_EngineShard(f"r{i}", BatchedEngine(
        params, cfg, slots=args.slots, max_context=max_context,
        seed=args.seed + i, cache=args.cache,
        prefill_chunk_tokens=args.prefill_chunk_tokens, device=device))
        for i in range(args.replicas)]
    if cfg.arch_type in (SSM, HYBRID) or cfg.age_encoding:
        # the first half of fresh synthetic patients (known history)
        trajs, _ = generate_dataset(SimulatorConfig(
            n_train=args.requests, n_val=1, seed=args.seed + 17))
        prompts = [(tok[:max(len(tok) // 2, 1)], age[:max(len(tok) // 2, 1)])
                   for tok, age in trajs]
    else:
        prompts = [(t, None) for t in lm_prompts(
            args.requests, cfg.vocab_size, args.seed,
            hi=min(128, max_context))]
    sched = None
    if args.replicas > 1:
        from repro_torch.serve.router import PrefixAffinityScheduler
        sched = PrefixAffinityScheduler(block_size=16)
    for tok, age in prompts:
        req = Request(tokens=tok, ages=age, max_new=args.max_new)
        shard = (shards[0] if sched is None else
                 sched.route(req.tokens, req.ages, shards)[0])
        shard.requests.append(req)
    t0 = time.perf_counter()
    for shard in shards:
        for req in shard.requests:
            shard.engine.submit(req)
    if sched is None:
        done = shards[0].engine.run()
    else:
        done = _run_background(shards)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return {"engine": shards[0].engine, "engines": [s.engine for s in shards],
            "done": done, "seconds": seconds,
            "events": sum(len(r.out_tokens) for r in done),
            "routing": None if sched is None else sched.stats(),
            "shards": {s.name: len(s.requests) for s in shards}}


def _run_background(shards: List[_EngineShard],
                    timeout: float = 600.0) -> List[Request]:
    """Tick every engine on its own background thread and wait on the
    requests' completion hooks; a request that fails raises here."""
    import threading
    reqs = [r for s in shards for r in s.requests]
    left = threading.Semaphore(0)
    for r in reqs:
        r.on_done = lambda _r: left.release()
    for shard in shards:
        shard.engine.start(retain_completed=True)
    try:
        deadline = time.monotonic() + timeout
        for _ in reqs:
            if not left.acquire(timeout=max(deadline - time.monotonic(),
                                            0.0)):
                raise TimeoutError(f"requests unfinished after {timeout}s")
    finally:
        for shard in shards:
            shard.engine.stop()
    errors = [r.error for r in reqs if r.error is not None]
    if errors:
        raise errors[0]
    return [r for s in shards for r in s.engine.completed]


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    out = serve(args)
    dt, n = out["seconds"], out["events"]
    eng = out["engine"]
    unit = "events" if eng.is_delphi else "tokens"
    if out["routing"] is not None:
        counts = ", ".join(f"{k}={v}" for k, v in out["shards"].items())
        print(f"sharded {len(out['done'])} requests over "
              f"{len(out['engines'])} engines ({counts}; affinity rate "
              f"{out['routing']['affinity_rate']:.2f})")
    print(f"served {len(out['done'])} requests, {n} {unit} in {dt:.2f}s "
          f"({n / dt:.1f} {unit}/s, "
          f"{sum(e.ticks for e in out['engines']) / dt:.1f} ticks/s) on "
          f"{eng.device}")
    if out["done"]:
        r = out["done"][0]
        if eng.is_delphi:
            names = [V.code_name(t) for t in r.out_tokens[:8]]
            print("sample trajectory:",
                  list(zip(names, [round(a, 1) for a in r.out_ages[:8]])))
        else:
            print("sample tokens:", r.out_tokens[:8])
    return out


if __name__ == "__main__":
    main()
