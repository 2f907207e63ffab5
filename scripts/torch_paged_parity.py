"""Paged KV-cache engine == ring engine, and no block leaks, on the port.

The twin of ``scripts/paged_parity.py`` on ``repro_torch``, on ``--device``
(the card unless ``--device cpu``), reduced Delphi-2M in fp32.  Five
phases:

1. **Parity**: same config, same injected uniforms, same slot count: the
   paged engine's trajectories are bit-identical to the ring engine's
   (tokens and fp32 ages) on the generate, stream and batch paths,
   including an over-width (S > max_context) wrapped-ring prompt.
2. **Cancel/preempt/timeout storm**: an undersized pool, cancellations
   in flight and a zero-second deadline batch leave the allocator with
   zero leaked blocks and every block table empty.
3. **Fork parity**: ``sample_futures`` (hold + fork + copy-on-write +
   prefix index) on both cache layouts is bit-identical to the
   scheduler-free ``ring_reference_futures`` under injected uniforms.
4. **Fork/cancel/timeout storm**: concurrent futures fan-outs on an
   undersized prefix-cached pool with child cancellations in flight and
   an expiring-deadline batch: every refcount drains to zero and the
   prefix index is empty (and the pool free) after eviction.
5. **Chunked-prefill storm**: mixed long/short prompts on an undersized
   chunked, prefix-cached pool, cancels landing mid-prefill and pool
   pressure preempting mid-prefill slots: zero leaked blocks, refcounts
   drained, empty block table.

Bit-identity holds inside the port; it is never required against JAX.

Run:  PYTHONPATH=src python scripts/torch_paged_parity.py [--device cpu]
"""
import argparse
import sys
import threading
import time

import numpy as np

from repro_torch.api import GenerateRequest, RequestCancelledError
from repro_torch.api.client import EngineBackend
from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.serve import BatchedEngine, Request, ring_reference_futures


def _uniforms(max_new, V, seed):
    return np.random.default_rng(seed).uniform(
        size=(max_new, V)).astype(np.float32)


def _reqs(cfg, n, max_new, seed0=0):
    out = []
    for s in range(n):
        S = 3 + (s % 4)
        out.append(Request(
            tokens=(np.arange(3, 3 + S, dtype=np.int32) + s) % 90,
            ages=np.linspace(0.0, 30.0, S).astype(np.float32),
            max_new=max_new,
            uniforms=_uniforms(max_new, cfg.vocab_size, seed0 + s)))
    return out


def parity(params, cfg, device) -> None:
    def run(kind):
        eng = BatchedEngine(params, cfg, slots=2, max_context=64,
                            cache=kind, block_size=16, device=device)
        for r in _reqs(cfg, 5, 8):
            eng.submit(r)
        done = eng.run()
        assert len(done) == 5
        return eng, [(r.out_tokens, r.out_ages) for r in done]

    _, ring = run("ring")
    eng, paged = run("paged")
    assert ring == paged, "paged generate diverged from ring"
    assert eng.allocator.used == 0

    # over-width prompt: wrapped ring pack through the block copy
    S, W = 33, 16
    for kind in ("ring", "paged"):
        e = BatchedEngine(params, cfg, slots=1, max_context=W, cache=kind,
                          block_size=8, device=device)
        e.submit(Request(tokens=(np.arange(3, 3 + S) % 90).astype(np.int32),
                         ages=np.linspace(0.0, 30.0, S).astype(np.float32),
                         max_new=4,
                         uniforms=_uniforms(4, cfg.vocab_size, 99)))
        d = e.run()[0]
        if kind == "ring":
            wrap_ref = (d.out_tokens, d.out_ages)
        else:
            assert (d.out_tokens, d.out_ages) == wrap_ref, \
                "paged over-width prompt diverged"
            assert e.allocator.used == 0

    # stream + batch through the client backend surface
    u = _uniforms(6, cfg.vocab_size, 42)
    req = GenerateRequest(tokens=[3, 10, 20], ages=[0.0, 15.0, 28.0],
                          max_new=6, uniforms=u)
    ring_b = EngineBackend.create(params, cfg, slots=2, max_context=64,
                                  device=device)
    paged_b = EngineBackend.create(params, cfg, slots=2, max_context=64,
                                   cache="paged", block_size=16, device=device)
    ev_r = [(e.token, e.age) for e in ring_b.stream(req)]
    ev_p = [(e.token, e.age) for e in paged_b.stream(req)]
    assert ev_r == ev_p, "paged stream diverged from ring"
    batch = [GenerateRequest(tokens=[3, 10, 20], ages=[0.0, 15.0, 28.0],
                             max_new=6, uniforms=u) for _ in range(3)]
    b_r = [(r.tokens, r.ages) for r in ring_b.generate_batch(batch)]
    b_p = [(r.tokens, r.ages) for r in paged_b.generate_batch(batch)]
    assert b_r == b_p, "paged batch diverged from ring"
    assert paged_b.engine.allocator.used == 0
    print(f"parity OK: generate/stream/batch bit-identical "
          f"({len(ring)} + 1 wrapped + stream + batch)")


def storm(params, cfg, device) -> None:
    # undersized pool: capacity 5 blocks, a full slot needs 4 -> constant
    # growth pressure and preemptions while cancels land mid-flight
    eng = BatchedEngine(params, cfg, slots=4, max_context=32, cache="paged",
                        block_size=8, blocks=6, device=device).start()
    try:
        reqs = []
        for s in range(24):
            S = 3 + (s % 5)
            r = Request(tokens=(np.arange(3, 3 + S, dtype=np.int32)) % 90,
                        ages=np.linspace(0.0, 30.0, S).astype(np.float32),
                        max_new=12, request_id=f"storm-{s}")
            reqs.append(r)
            eng.submit(r)
        time.sleep(0.3)
        cancelled = [r.request_id for i, r in enumerate(reqs) if i % 3 == 0]
        for rid in cancelled:
            eng.cancel(rid)
        deadline = time.monotonic() + 120
        while (not all(r.done for r in reqs)) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert all(r.done for r in reqs), "storm requests did not drain"
    finally:
        eng.stop()
    n_cancelled = sum(isinstance(r.error, RequestCancelledError)
                      for r in reqs)
    n_ok = sum(r.error is None for r in reqs)
    assert n_ok + n_cancelled == len(reqs), \
        [type(r.error).__name__ for r in reqs if r.error is not None]
    assert eng.allocator.used == 0, \
        f"LEAK: {eng.allocator.used} blocks still allocated"
    assert (eng._table == -1).all(), "LEAK: block table still references pool"
    # timeout path also reclaims
    eng2 = BatchedEngine(params, cfg, slots=2, max_context=32, cache="paged",
                         block_size=8, request_timeout=0.0, device=device)
    for s in range(3):
        eng2.submit(Request(tokens=np.arange(3, 8, dtype=np.int32),
                            ages=np.linspace(0.0, 30.0, 5).astype(np.float32),
                            max_new=12))
    time.sleep(0.01)
    eng2.run(max_ticks=200)
    assert eng2.allocator.used == 0
    print(f"storm OK: {len(reqs)} requests ({n_cancelled} cancelled, "
          f"{eng.preemptions} preemptions, "
          f"{eng.pool_stats()['blocks_peak_used']}"
          f"/{eng.allocator.capacity} peak blocks), zero leaked blocks")


def fork_parity(params, cfg, device) -> None:
    toks = np.asarray([3, 10, 20, 30, 41], np.int32)
    ages = np.linspace(0.0, 30.0, 5).astype(np.float32)
    n, max_new, W, K = 4, 6, 64, 4
    u = _uniforms(n * max_new, cfg.vocab_size, seed=23).reshape(
        n, max_new, cfg.vocab_size)
    oracle = ring_reference_futures(params, cfg, toks, ages, n=n,
                                    max_new=max_new, uniforms=u, slots=K,
                                    max_context=W, device=device)
    ora = [(list(t), [np.float32(a) for a in a_]) for t, a_ in oracle]
    for kind, kw in (("ring", {}),
                     ("paged", {"block_size": 16}),
                     ("paged", {"block_size": 16, "prefix_cache": True})):
        eng = BatchedEngine(params, cfg, slots=K, max_context=W, cache=kind,
                            device=device, **kw)
        for round_ in range(2):          # round 2 hits the prefix index
            kids = eng.sample_futures(toks, ages, n=n, max_new=max_new,
                                      uniforms=u)
            got = [(list(k.out_tokens),
                    [np.float32(a) for a in k.out_ages]) for k in kids]
            assert got == ora, \
                f"forked futures diverged from oracle ({kind} {kw} " \
                f"round {round_})"
        if eng.paged:
            eng.drop_prefix_cache()
            assert eng.allocator.used == 0
            assert not eng.pool._refs, "refcounts left after drain"
    print("fork parity OK: ring/paged/prefix-cached sample_futures "
          "bit-identical to the oracle (2 rounds each)")


def fork_storm(params, cfg, device) -> None:
    # undersized prefix-cached pool under concurrent futures fan-outs,
    # mid-flight child cancellations, then an expiring-deadline batch
    eng = BatchedEngine(params, cfg, slots=4, max_context=32, cache="paged",
                        block_size=8, blocks=8, prefix_cache=True,
                        device=device).start()
    all_kids = []
    try:
        waves = []
        for w in range(6):
            S = 3 + (w % 3)
            t = threading.Thread(
                target=lambda w=w, S=S: all_kids.append(eng.sample_futures(
                    (np.arange(3, 3 + S, dtype=np.int32) + w) % 90,
                    np.linspace(0.0, 30.0, S).astype(np.float32),
                    n=3, max_new=10, request_id=f"fut-{w}",
                    wait_timeout=120.0)))
            t.start()
            waves.append(t)
        time.sleep(0.2)
        for w in range(0, 6, 2):         # cancel one child of every other
            eng.cancel(f"fut-{w}/fork-1")
        for t in waves:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in waves), "futures storm hung"
    finally:
        eng.stop()
    kids = [k for wave in all_kids for k in wave]
    bad = [k for k in kids
           if k.error is not None
           and not isinstance(k.error, RequestCancelledError)]
    assert not bad, [type(k.error).__name__ for k in bad]
    assert all(k.done for k in kids)
    # zero-leak with refcounts: drained engine + dropped index -> all free
    eng.drop_prefix_cache()
    assert eng.prefix.entries == 0, "prefix index not empty after eviction"
    assert not eng.pool._refs, f"refcounts not drained: {eng.pool._refs}"
    assert eng.allocator.used == 0, \
        f"LEAK: {eng.allocator.used} blocks still allocated"
    assert (eng._table == -1).all(), "LEAK: block table still references pool"

    # expiring deadlines mid-fork also drain
    eng2 = BatchedEngine(params, cfg, slots=2, max_context=32, cache="paged",
                         block_size=8, request_timeout=0.0,
                         prefix_cache=True, device=device)
    parent = Request(tokens=np.arange(3, 8, dtype=np.int32),
                     ages=np.linspace(0.0, 30.0, 5).astype(np.float32),
                     max_new=10, hold=True)
    eng2.submit(parent)
    kids2 = eng2.fork(parent.request_id, 3)
    time.sleep(0.01)
    eng2.run(max_ticks=200)
    assert all(k.done for k in kids2)
    eng2.drop_prefix_cache()
    assert eng2.allocator.used == 0 and not eng2.pool._refs
    st = eng.pool_stats()
    print(f"fork storm OK: {len(kids)} forked futures "
          f"({st['forks']} forks, {st['cow_copies']} COW copies, "
          f"{st['preemptions']} preemptions, peak shared "
          f"{st['shared_blocks_peak']}), refcounts drained, index empty")


def chunked_storm(params, cfg, device) -> None:
    # mixed long/short prompts on an undersized chunked pool: long prompts
    # span several one-block chunks, so cancels and preemptions land while
    # slots are still mid-prefill — their partially-written blocks (and the
    # shared prefix refs acquired at admission) must all release
    eng = BatchedEngine(params, cfg, slots=4, max_context=32, cache="paged",
                        block_size=8, blocks=8, prefix_cache=True,
                        prefill_chunk_tokens=8, device=device).start()
    base = (np.arange(3, 23, dtype=np.int32)) % 90      # shared long prefix
    base_ages = np.linspace(0.0, 30.0, 20).astype(np.float32)
    try:
        # warm registrant: its 2 full blocks seed the index so later long
        # admissions take the partial-hit suffix path
        warm = Request(tokens=base[:16], ages=base_ages[:16], max_new=2,
                       request_id="chunk-warm")
        eng.submit(warm)
        deadline = time.monotonic() + 60
        while not warm.done and time.monotonic() < deadline:
            time.sleep(0.02)
        assert warm.done and warm.error is None
        reqs = []
        for s in range(24):
            if s % 2 == 0:               # long: 16-token prefix + tail
                S = 17 + (s % 4)
                toks, ages = base[:S], base_ages[:S]
            else:                        # short: single partial block
                S = 3 + (s % 5)
                toks = (np.arange(3, 3 + S, dtype=np.int32) + s) % 90
                ages = np.linspace(0.0, 30.0, S).astype(np.float32)
            r = Request(tokens=toks, ages=ages, max_new=12,
                        request_id=f"chunk-storm-{s}")
            reqs.append(r)
            eng.submit(r)
        time.sleep(0.15)                 # some longs are mid-prefill now
        for i, r in enumerate(reqs):
            if i % 3 == 0:
                eng.cancel(r.request_id)
        deadline = time.monotonic() + 120
        while (not all(r.done for r in reqs)) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert all(r.done for r in reqs), "chunked storm did not drain"
    finally:
        eng.stop()
    bad = [r for r in reqs if r.error is not None
           and not isinstance(r.error, RequestCancelledError)]
    assert not bad, [type(r.error).__name__ for r in bad]
    st = eng.pool_stats()
    assert st["chunked_prefills"] > 0, "no admission took the chunked path"
    assert st["prefill_chunks"] > st["chunked_prefills"], \
        "no prompt actually spanned multiple chunks"
    assert st["prefill_in_progress"] == 0
    eng.drop_prefix_cache()
    assert not eng.pool._refs, f"refcounts not drained: {eng.pool._refs}"
    assert eng.allocator.used == 0, \
        f"LEAK: {eng.allocator.used} blocks still allocated"
    assert (eng._table == -1).all(), "LEAK: block table still references pool"
    print(f"chunked storm OK: {len(reqs)} requests "
          f"({st['chunked_prefills']} chunked prefills, "
          f"{st['prefill_chunks']} chunks, {st['suffix_tokens_saved']} "
          f"suffix tokens saved, {st['preemptions']} preemptions), "
          f"zero leaked blocks")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    params = init_delphi(cfg, 7, args.device)
    for phase in (parity, storm, fork_parity, fork_storm, chunked_storm):
        t0 = time.time()
        phase(params, cfg, args.device)
        print(f"  ({phase.__name__}: {time.time() - t0:.1f} s)")
    print(f"torch_paged_parity: all checks passed on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
