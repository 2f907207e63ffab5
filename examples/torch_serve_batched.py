"""End-to-end serving on the port: train a small Delphi, then serve a
stream of batched trajectory requests through the continuous-batching
engine (one decode-and-sample tick on the device, eq.-1 sampling by the
``tte_sample`` kernel, one packed host transfer a tick, bucketed batched
prefill on admission), and stream one request through
``Client.from_engine``.

The twin of ``examples/serve_batched.py`` on ``repro_torch``, on the card
unless ``--device cpu``.  The last line of the output is the kernels'
launch counts, as JSON.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--requests 24]
      [--device cpu]
"""
import argparse
import json
import time

from repro_torch.api import Client
from repro_torch.configs import get_config
from repro_torch.core import init_delphi
from repro_torch.data import (SimulatorConfig, batches, generate_dataset,
                              pack_trajectories)
from repro_torch.data import vocab as V
from repro_torch.kernels import ops
from repro_torch.serve import BatchedEngine, Request
from repro_torch.train import OptimizerConfig, train_loop

MAX_CONTEXT = 160


def make_config():
    """Delphi-2M at its published width, fp32, 160 positions."""
    return get_config("delphi-2m").replace(dtype="float32",
                                           max_seq_len=MAX_CONTEXT)


def make_data():
    """The packed training set (512 patients, 96 positions)."""
    train, _ = generate_dataset(SimulatorConfig(n_train=512, n_val=8))
    return pack_trajectories(train, 96)


def make_requests(n: int):
    """``n`` request histories, the first half of each simulated patient."""
    reqs, _ = generate_dataset(SimulatorConfig(n_train=n, n_val=1, seed=99))
    out = []
    for tok, age in reqs:
        h = max(len(tok) // 2, 2)
        out.append((tok[:h], age[:h]))
    return out


def train(params, cfg, packed, steps: int, device):
    ti = batches(packed, 32, seed=0)
    return train_loop(params, cfg, OptimizerConfig(lr=6e-4,
                                                   total_steps=steps),
                      ti, objective="delphi", steps=steps, log_every=20,
                      device=device)[0]


def serve(params, cfg, prompts, *, slots: int, max_new: int, device,
          uniforms=None):
    """Serve every prompt on one engine.  -> (engine, finished requests in
    submission order).  ``uniforms`` (one (max_new, V) array a prompt) are
    injected when given."""
    eng = BatchedEngine(params, cfg, slots=slots, max_context=MAX_CONTEXT,
                        device=device)
    reqs = []
    for i, (tok, age) in enumerate(prompts):
        r = Request(tokens=tok, ages=age, max_new=max_new,
                    uniforms=None if uniforms is None else uniforms[i])
        reqs.append(r)
        eng.submit(r)
    eng.run()
    return eng, reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_config()
    params = init_delphi(cfg, 0, args.device)

    print(f"== train {args.steps} steps ==")
    params = train(params, cfg, make_data(), args.steps, args.device)

    print(f"== serve {args.requests} requests on {args.slots} slots ==")
    prompts = make_requests(args.requests)
    t0 = time.time()
    eng, done = serve(params, cfg, prompts, slots=args.slots,
                      max_new=args.max_new, device=args.device)
    dt = time.time() - t0
    ev = sum(len(r.out_tokens) for r in done)
    print(f"   {len(done)} requests, {ev} events in {dt:.1f}s "
          f"({ev/dt:.1f} events/s, {eng.ticks/dt:.1f} ticks/s, "
          f"{eng.host_syncs} host syncs over {eng.ticks} ticks + "
          f"{eng.admit_batches} admissions, "
          f"prefill shapes {sorted(eng.prefill_shapes)})")

    r = done[0]
    print("   sample continuation:")
    for t, a in list(zip(r.out_tokens, r.out_ages))[:8]:
        print(f"     age {a:5.1f}  {V.code_name(int(t))}")
    deaths = sum(r.out_tokens[-1] == V.DEATH for r in done if r.out_tokens)
    print(f"   {deaths}/{len(done)} trajectories terminated at Death; "
          f"rest censored at max age / max_new")

    # the same engine behind the unified client API: per-event streaming
    client = Client.from_engine(eng)
    tok, age = prompts[0]
    print("   streamed via repro_torch.api.Client.from_engine(engine):")
    for e in client.stream(tokens=tok.tolist(), ages=age.tolist(),
                           max_new=6):
        print(f"     age {e.age:5.1f}  {V.code_name(e.token)}")
    print(json.dumps({"launch_counts": ops.launch_counts()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
