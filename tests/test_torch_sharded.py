"""The port's sharded step, run for real: 4 CPU processes in a gloo group
on a 2 x 2 (data x model) ``DeviceMesh``, the model's parameters,
optimizer state, batch and caches laid out as DTensors by
``launch.sharding.distribute_tree``, against the single-process plain
step on the same inputs (fp32, reduced configs, no JAX).

* Reduced TinyLlama (4 query heads, 1 KV head: the query heads split over
  ``model``, the KV head read whole, each rank picking it for its heads),
  reduced OLMoE (4 experts split over ``model``), reduced Mamba2 (each
  layer whole on each rank's rows, its weights gathered) and reduced
  Zamba2 (Mamba2 layers and the shared attention block): one train step's
  loss, every gradient and the AdamW update; a prefill's logits and cache;
  two decode steps' logits and cache.  TinyLlama also with
  ``seq_shard_attn`` (the queries split along the sequence instead of the
  heads): the same outputs.
* The collectives each real run issued (``launch.collectives``) equal, kind
  by kind and byte for byte, the count of the same step on meta DTensors
  over a fake process group of the same mesh (``launch.dryrun.
  count_sharded``): the dry run's figure is what the sharded step sends.

Each process group lives in processes of its own (``torch.multiprocessing``
spawn, a ``FileStore`` under ``tmp_path``, gloo on the loopback
interface), so that xdist's workers do not collide; one spawn runs every
case of every architecture (~30 s on 4 CPU cores).
"""
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.dryrun import count_sharded
from repro_torch.launch.mesh import Mesh
from repro_torch.models import decode_step, forward, init_params
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainer import (loss_and_grads, make_loss_fn,
                                       make_train_step)

MESH = Mesh(("data", "model"), (2, 2))
WORLD = 4
B, S = 4, 32
CACHE = S + 8          # the prefill's ring: room for the decode steps
DECODE_STEPS = 2
OCFG = OptimizerConfig(warmup_steps=1)
SPAWN_TIMEOUT = 300     # seconds for the whole gloo run (~30 s here)

# measured on the CPU (the largest over the cases below): loss 0.0,
# gradients 3.5e-6 of each leaf's largest |g|, first moment 2.0e-8 of it,
# the update 1.5e-5 absolute (lr 3e-4: AdamW's first step divides each
# gradient by its own magnitude, so a tiny gradient's rounding moves its
# update by up to ~5% of lr), logits 5.7e-6 (largest |logit| 4.2), rings
# and Mamba2 states 5.4e-6; the limits leave ~3-10x room for another
# CPU's summation order
LOSS_TOL = 5e-6
GRAD_REL = 2e-5
UPDATE_TOL = 5e-5
LOGIT_TOL = 5e-5
CACHE_TOL = 3e-5


def _cfg(arch, seq_shard=False):
    return get_config(arch, reduced=True).replace(dtype="float32",
                                                  seq_shard_attn=seq_shard)


def _inputs(arch):
    cfg = _cfg(arch)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(3, cfg.vocab_size, (B, S + DECODE_STEPS))
    batch = {"tokens": torch.from_numpy(toks[:, :S].astype(np.int32))}
    nxt = torch.from_numpy(toks[:, S:].astype(np.int32))
    return cfg, params, batch, init_opt_state(params), nxt


def _shardings(params, opt, batch):
    ps = sh.param_shardings(MESH, params)
    return ps, sh.opt_state_shardings(MESH, opt, ps), \
        sh.batch_shardings(MESH, batch)


def _cases(arch):
    return (False, True) if arch == "tinyllama-1.1b" else (False,)


def _full(tree):
    """DTensors gathered whole (every rank calls this), plain as they
    are."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_full(v) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_full(v) for v in tree))
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree


def _prefill_decode(params, cfg, batch, nxt):
    """A prefill (rings ``CACHE`` wide) and ``DECODE_STEPS`` decode steps:
    ([prefill logits, decode logits...], the final rings)."""
    with torch.no_grad():
        out = forward(params, cfg, batch, mode="prefill", cache_width=CACHE)
        logits, cache = [out["logits"]], out["cache"]
        for i in range(DECODE_STEPS):
            d = decode_step(params, cfg, cache, {"tokens": nxt[:, i:i + 1]},
                            S + i)
            logits.append(d["logits"])
            cache = d["cache"]
    return logits, cache


def _worker(rank, store_path, out_path):
    """One rank of the gloo group: every case of every architecture on
    DTensors; rank 0 saves the gathered results and the collectives it
    counted."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.collectives import CollectiveCounter
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        dm = init_device_mesh("cpu", MESH.sizes,
                              mesh_dim_names=MESH.axis_names)
        out = {}
        for arch in ARCHS:
            _, params, batch, opt, nxt = _inputs(arch)
            ps, os_, bs = _shardings(params, opt, batch)
            dp = sh.distribute_tree(params, ps, dm)
            do = sh.distribute_tree(opt, os_, dm)
            db = sh.distribute_tree(batch, bs, dm)
            res = out[arch] = {}
            for seq in _cases(arch):
                cfg = _cfg(arch, seq)
                grads, metrics = loss_and_grads(make_loss_fn(cfg, "lm"), dp,
                                                db)
                with CollectiveCounter() as train_cc:
                    new_p, new_o, _ = make_train_step(cfg, OCFG, "lm")(
                        dp, do, db)
                with CollectiveCounter() as prefill_cc:
                    with torch.no_grad():
                        forward(dp, cfg, db, mode="prefill",
                                cache_width=CACHE)
                logits, cache = _prefill_decode(dp, cfg, db, nxt)
                res[seq] = {"loss": _full(metrics["loss"]),
                            "grads": _full(grads), "params": _full(new_p),
                            "mu": _full(new_o["mu"]),
                            "logits": _full(logits), "cache": _full(cache),
                            "train_cc": dict(train_cc.bytes),
                            "prefill_cc": dict(prefill_cc.bytes)}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


ARCHS = ["tinyllama-1.1b", "olmoe-1b-7b", "mamba2-780m", "zamba2-1.2b"]
_RUNS = {}


def _gloo_run(arch, tmp_path_factory):
    """``arch``'s results from the one gloo run of every architecture."""
    if not _RUNS:
        import torch.multiprocessing as mp
        d = tmp_path_factory.mktemp("gloo")
        out = str(d / "res.pt")
        ctx = mp.spawn(_worker, args=(str(d / "store"), out), nprocs=WORLD,
                       join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT
        while not ctx.join(timeout=5):      # raises if a rank failed
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                pytest.fail(f"the gloo run did not end in {SPAWN_TIMEOUT} s")
        _RUNS.update(torch.load(out, weights_only=False))
    return _RUNS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def run(request, tmp_path_factory):
    return request.param, _gloo_run(request.param, tmp_path_factory)


def test_train_step_equals_the_plain_step(run):
    """Loss, every gradient (within ``GRAD_REL`` of its leaf's largest
    |g|), the AdamW update and the first moment, from the same parameters
    and batch."""
    arch, res = run
    _, params, batch, opt, _ = _inputs(arch)
    for seq, r in res.items():
        cfg = _cfg(arch, seq)
        grads, m = loss_and_grads(make_loss_fn(cfg, "lm"), params, batch)
        new_p, new_o, _ = make_train_step(cfg, OCFG, "lm")(params, opt,
                                                           batch)
        assert abs(float(r["loss"]) - float(m["loss"])) <= LOSS_TOL, seq
        assert set(r["grads"]) == set(grads)
        for k, g in grads.items():
            err = float((r["grads"][k] - g).abs().max())
            assert err <= GRAD_REL * float(g.abs().max()), (seq, k, err)
            assert float((r["params"][k] - new_p[k]).abs().max()) \
                <= UPDATE_TOL, (seq, k)
            assert torch.allclose(r["mu"][k], new_o["mu"][k], rtol=0,
                                  atol=GRAD_REL * float(g.abs().max())), k


def test_prefill_and_decode_equal_the_plain_route(run):
    """A prefill's logits and rings, then two decode steps' logits and
    rings (each rank writing its own slots)."""
    arch, res = run
    _, params, batch, _, nxt = _inputs(arch)
    for seq, r in res.items():
        logits, cache = _prefill_decode(params, _cfg(arch, seq), batch, nxt)
        for got, want in zip(r["logits"], logits):
            assert got.shape == want.shape
            assert float((got - want).abs().max()) <= LOGIT_TOL, seq
        got, want = sh.cache_leaves(r["cache"]), sh.cache_leaves(cache)
        assert set(got) == set(want)
        for k, w in want.items():
            if k.endswith("/pos"):
                assert torch.equal(got[k], w), k
            else:
                assert float((got[k] - w).abs().max()) <= CACHE_TOL, (seq, k)


def test_seq_shard_attn_leaves_the_outputs_unchanged(tmp_path_factory):
    """On the real group, reduced TinyLlama with and without
    ``seq_shard_attn``: the same loss, gradients and logits within the
    tolerances that hold each against the plain step."""
    res = _gloo_run("tinyllama-1.1b", tmp_path_factory)
    a, b = res[False], res[True]
    assert abs(float(a["loss"]) - float(b["loss"])) <= LOSS_TOL
    for k, g in a["grads"].items():
        assert float((g - b["grads"][k]).abs().max()) \
            <= GRAD_REL * float(g.abs().max()), k
    for x, y in zip(a["logits"], b["logits"]):
        assert float((x - y).abs().max()) <= LOGIT_TOL


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def test_real_collectives_equal_the_fake_group_count(run):
    """The collectives of the real train step and prefill, kind by kind
    and byte for byte, against the same steps on meta DTensors over a fake
    group of the same 2 x 2 mesh.  The fake mesh is a CPU one here, as the
    gloo group's: DTensor moves a CPU mesh's shards from one dimension to
    another by an all-gather (gloo has no all-to-all), where the dry run's
    mesh of the cards' type counts an all-to-all."""
    arch, res = run
    _, params, batch, opt, _ = _inputs(arch)
    ps, os_, bs = _shardings(params, opt, batch)
    mp_, mo, mb = _meta(params), _meta(opt), _meta(batch)
    for seq, r in res.items():
        cfg = _cfg(arch, seq)
        fake = count_sharded(make_train_step(cfg, OCFG, "lm"),
                             (mp_, mo, mb), (ps, os_, bs), MESH, "cpu")
        assert r["train_cc"] == fake["collectives"], seq
        assert r["train_cc"].get("all-reduce", 0) > 0

        def prefill(p, b):
            with torch.no_grad():
                return forward(p, cfg, b, mode="prefill", cache_width=CACHE)
        fake = count_sharded(prefill, (mp_, mb), (ps, bs), MESH, "cpu")
        assert r["prefill_cc"] == fake["collectives"], seq
