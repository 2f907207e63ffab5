"""The port's launch layer (``repro_torch.launch``: mesh, sharding,
distributed, specs, dryrun, roofline) against the JAX package's on the CPU.

* The sharding rules (``param_pspec``, ``cache_pspec``, ``batch_pspec``)
  give JAX's ``PartitionSpec`` on every leaf of all 12 architectures at
  full width, on the reference test's fake 16 x 16 mesh and on a fake 2 x
  16 x 16 one; the port's leaves come from meta tensors
  (``launch.specs``), JAX's from ``jax.eval_shape``.
* ``input_specs``' meta tensors equal JAX's ``ShapeDtypeStruct``s in shape
  and dtype, leaf by leaf, for the four input shapes on the reduced
  configs of all 12 architectures; ``long_context_cfg`` equals JAX's.
* ``active_params`` and ``model_flops`` equal JAX's exactly on the 12
  configs; the roofline's constants are the H100's.
* The dry run's FLOPs equal a hand count of a step's products within 2%;
  it makes nothing off the meta device (a full-width Qwen2.5-32B decode
  step); the CLI prints ``OK`` as a subprocess and the roofline CLI reads
  its record.
* ``ensure_distributed`` is a no-op in one process and raises on a
  mismatch; a gloo process group of one over a ``FileStore`` builds a 1 x
  1 CPU ``DeviceMesh`` (no socket: the store is a file, gloo's device the
  loopback interface), on which every placement is ``Replicate`` and a
  forward through the placed parameters equals the plain one bit for bit.
"""
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from hypcompat import given, settings, st
from jax.sharding import PartitionSpec as P

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.launch import roofline as jax_roofline
from repro.launch import sharding as jax_sh
from repro.launch import specs as jax_specs
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import make_decode_cache as jax_make_decode_cache
from repro_torch.configs import (ALL_ARCHS, ASSIGNED_ARCHS, INPUT_SHAPES,
                                 InputShape, get_config, get_shape)
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.distributed import ensure_distributed
from repro_torch.launch.mesh import (Mesh, data_axes, device_mesh,
                                     make_host_mesh, make_production_mesh,
                                     model_axis_size)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Fake16:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class Fake2x16:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": Fake16, "2x16x16": Fake2x16}


def _jax_leaves(tree):
    return {jax_sh._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_full(arch):
    """JAX's full-width parameter and decode_32k cache specs."""
    jcfg = jax_config(arch)
    p = jax_specs.params_spec(jcfg)
    c = jax.eval_shape(functools.partial(
        jax_make_decode_cache, cfg=jcfg, batch=128, context_len=32_768), p)
    return _jax_leaves(p), _jax_leaves(c)


def test_configs_shapes_and_archs_equal_jax():
    assert ASSIGNED_ARCHS == JAX_ASSIGNED
    assert set(ALL_ARCHS) == set(JAX_ARCHS)
    assert [(s.name, s.seq_len, s.global_batch, s.mode, s.tokens)
            for s in INPUT_SHAPES] == \
        [(s.name, s.seq_len, s.global_batch, s.mode, s.tokens)
         for s in JAX_SHAPES]
    assert get_shape("decode_32k") == InputShape("decode_32k", 32_768, 128,
                                                 "decode")
    assert get_config("tinyllama-1.1b").remat is False


def test_meshes():
    m = make_production_mesh()
    assert (m.axis_names, m.sizes, m.size, m.name) == \
        (("data", "model"), (16, 16), 256, "16x16")
    m2 = make_production_mesh(multi_pod=True)
    assert (m2.axis_names, m2.size, m2.name) == \
        (("pod", "data", "model"), 512, "2x16x16")
    assert data_axes(m2) == ("pod", "data") and model_axis_size(m2) == 16
    host, jhost = make_host_mesh(), jax_host_mesh()
    assert host.axis_names == tuple(jhost.axis_names)
    assert host.shape == dict(jhost.shape)
    assert data_axes(host) == ("data",) and model_axis_size(host) == 1
    with pytest.raises(ValueError):
        Mesh(("data",), (2, 2))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_param_and_cache_pspecs_equal_jax_at_full_width(arch, mesh):
    """Every parameter leaf (shapes from the port's meta tensors, equal to
    JAX's) and every decode_32k cache leaf gets JAX's spec."""
    fm = MESHES[mesh]()
    cfg = get_config(arch)
    jp, jc = _jax_full(arch)
    mine = specs.params_spec(cfg)
    assert set(mine) == set(jp)
    assert all(t.device.type == "meta" for t in mine.values())
    for k, t in mine.items():
        assert tuple(t.shape) == tuple(jp[k].shape), k
        assert P(*sh.param_pspec(fm, k, t.shape)) == \
            jax_sh.param_pspec(fm, k, jp[k].shape), k
    from repro_torch.models import make_decode_cache
    cache = sh.cache_leaves(make_decode_cache(mine, cfg, 128, 32_768))
    assert set(cache) == set(jc)
    for k, t in cache.items():
        assert tuple(t.shape) == tuple(jc[k].shape), k
        assert P(*sh.cache_pspec(fm, k, t.shape)) == \
            jax_sh.cache_pspec(fm, k, jc[k].shape), k
    for s in INPUT_SHAPES:
        b = specs.model_batch_spec(cfg, s.global_batch, s.seq_len,
                                   for_train=s.mode == "train")
        for k, t in b.items():
            assert P(*sh.batch_pspec(fm, t.shape)) == \
                jax_sh.batch_pspec(fm, tuple(t.shape)), (k, s.name)


@settings(max_examples=60, deadline=None)
@given(dim=st.integers(1, 4096))
def test_partition_divisibility(dim):
    spec = sh.partition(Fake16(), (dim,), ["model"])
    assert spec == (("model",) if dim % 16 == 0 else (None,))
    spec = sh.partition(Fake2x16(), (dim, 3), [("pod", "data"), None])
    assert spec == ((("pod", "data"), None) if dim % 32 == 0
                    else (None, None))
    assert P(*spec) == jax_sh.partition(Fake2x16(), (dim, 3),
                                        [("pod", "data"), None])


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_input_specs_equal_jax_leaf_by_leaf(arch):
    """The four shapes' step arguments on the reduced config: meta tensors
    against JAX's ``ShapeDtypeStruct``s (parameters, optimizer state,
    batch, cache, step), with the same specs on the 1 x 1 host mesh."""
    cfg = get_config(arch, reduced=True)
    jcfg = jax_config(arch, reduced=True)
    for shape, jshape in zip(INPUT_SHAPES, JAX_SHAPES):
        args, shards = specs.input_specs(cfg, shape, make_host_mesh())
        jargs, jshards = jax_specs.input_specs(jcfg, jshape, jax_host_mesh())
        groups = specs.flat_args(args, shards, shape.mode)
        names = list(groups)
        assert len(names) == len(jargs)
        for name, ja, js in zip(names, jargs, jshards):
            want = ({"step": ja} if name == "step" else _jax_leaves(ja))
            wsh = ({"step": js} if name == "step" else _jax_leaves(js))
            mine = groups[name]
            assert set(mine) == set(want), (shape.name, name)
            for k, (t, spec) in mine.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (k, shape)
                assert _dtype_name(t) == str(want[k].dtype), (k, shape)
                assert P(*spec) == wsh[k].spec, (k, shape)
        assert specs.long_context_cfg(cfg, shape).sliding_window == \
            jax_specs.long_context_cfg(jcfg, jshape).sliding_window


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_active_params_and_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert roofline.active_params(cfg) == jax_roofline.active_params(jcfg)
    for s in INPUT_SHAPES:
        rec = {"mode": s.mode, "seq_len": s.seq_len,
               "global_batch": s.global_batch}
        assert roofline.model_flops(cfg, rec) == \
            jax_roofline.model_flops(jcfg, rec)


def test_roofline_terms_use_the_h100():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    rec = {"arch": "tinyllama-1.1b", "shape": "train_4k", "mesh": "16x16",
           "n_chips": 256, "mode": "train", "seq_len": 4096,
           "global_batch": 256, "flops_per_device": 1e15,
           "bytes_per_device": 1e13, "collective_total": 1e10,
           "memory": {"peak_estimate_bytes": 2 ** 34}}
    t = roofline.terms(rec)
    np.testing.assert_allclose(t["compute_s"], 1e15 / 989e12)
    np.testing.assert_allclose(t["memory_s"], 1e13 / 3.35e12)
    np.testing.assert_allclose(t["collective_s"], 1e10 / 450e9)
    assert t["dominant"] == "memory"
    a = roofline.analyse(rec)
    assert a["useful_ratio"] == pytest.approx(
        roofline.model_flops(get_config("tinyllama-1.1b"), rec) / 256e15)


def _hand_prefill_flops(cfg, B, S):
    """The products of a dense prefill step: QKV, the plain attention's
    full S x S scores and their product with V, the output projection,
    SwiGLU's three, and the head at each row's last position."""
    d, H, Hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    per_layer = (2 * B * S * d * (H + 2 * Hkv) * hd
                 + 2 * 2 * B * H * S * S * hd
                 + 2 * B * S * H * hd * d
                 + 3 * 2 * B * S * d * f)
    return cfg.n_layers * per_layer + 2 * B * d * cfg.vocab_size


def _hand_decode_flops(cfg, B, W):
    d, H, Hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    per_layer = (2 * B * d * (H + 2 * Hkv) * hd + 2 * 2 * B * H * W * hd
                 + 2 * B * H * hd * d + 3 * 2 * B * d * f)
    return cfg.n_layers * per_layer + 2 * B * d * cfg.vocab_size


def test_dry_run_flops_equal_a_hand_count():
    """Reduced TinyLlama (2 layers, d 256, GQA 4/2, SwiGLU 512): a prefill
    of 2 x 64 and a decode step of 4 rows over 128 positions, within 2%
    of the hand count of their products (the elementwise work is not a
    product: FlopCounterMode counts products)."""
    cfg = get_config("tinyllama-1.1b", reduced=True)
    mesh = make_host_mesh()
    c = dryrun.count_step(cfg, InputShape("tiny", 64, 2, "prefill"), mesh)
    want = _hand_prefill_flops(cfg, 2, 64)
    assert abs(c["flops"] - want) <= 0.02 * want, (c["flops"], want)
    c = dryrun.count_step(cfg, InputShape("tiny", 128, 4, "decode"), mesh)
    want = _hand_decode_flops(cfg, 4, 128)
    assert abs(c["flops"] - want) <= 0.02 * want, (c["flops"], want)
    # a training step: forward, backward (twice the forward's products)
    # and the AdamW update; remat recomputes the forward once more
    tr = InputShape("tiny", 64, 2, "train")
    plain = dryrun.count_step(cfg, tr, mesh)["flops"]
    remat = dryrun.count_step(cfg.replace(remat=True), tr, mesh)["flops"]
    assert plain > 2.5 * want and remat > plain


def test_dry_run_allocates_nothing_and_refuses_ragged():
    """Full-width Qwen2.5-32B's decode_32k step (65 GB of bf16 weights, a
    17 GB cache a device group of 16), run sharded on DTensors over a fake
    16 x 16 group: nothing is made off the meta device, and the
    collectives are the hand count of its layout.  The 8 KV heads do not
    divide the model axis, so each ring's width is split over it and
    gathered whole for attention (k and v, every layer); the embedding and
    each layer's MLP (27,648 = 16 x 1,728 wide) end in an all-reduce of
    the 8 local rows; the 40 query heads do not divide 16, so attention
    repeats on every rank of the axis and needs none."""
    rec = dryrun.dryrun_one("qwen2.5-32b", "decode_32k")
    assert rec["off_meta_bytes"] < 2 ** 20
    assert rec["memory"]["argument_bytes_by_group"]["params"] > 2 ** 30
    cfg = get_config("qwen2.5-32b")
    rows, L = 128 // 16, cfg.n_layers
    ring = rows * cfg.n_kv_heads * 32_768 * cfg.head_dim * 2
    assert rec["collective_bytes_per_device"] == {
        "all-gather": 2 * L * ring,
        "all-reduce": (L + 1) * rows * cfg.d_model * 2}
    assert rec["flops_per_device"] > 0 and \
        rec["collective_total"] == 2 * L * ring + (L + 1) * rows * 5120 * 2
    assert rec["n_params"] > 30e9
    for impl in ("ragged", "ragged_local"):
        with pytest.raises(ValueError, match=f"moe_impl '{impl}'"):
            dryrun.dryrun_one("olmoe-1b-7b", "decode_32k", moe_impl=impl)


def test_dry_run_and_roofline_clis(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "delphi-2m", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK   delphi-2m_decode_32k_16x16")
    assert "all dry-runs passed" in out.stdout
    recs = roofline.load_records(str(tmp_path))
    assert [(r["arch"], r["shape"], r["mesh"], r["n_chips"]) for r in recs] \
        == [("delphi-2m", "decode_32k", "16x16", 256)]
    assert "| delphi-2m | decode_32k | 16x16 |" in roofline.table(recs)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(tmp_path), "--markdown"], capture_output=True, text=True,
        env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0 and "| delphi-2m |" in out.stdout


def test_ensure_distributed_single_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    n = 1 if not torch.cuda.is_available() else torch.cuda.device_count()
    assert ensure_distributed() == n
    assert ensure_distributed(expect_devices=n) == n
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match=f"expected {n + 1} global "
                       f"devices, found {n}"):
        ensure_distributed(expect_devices=n + 1)


def test_gloo_group_of_one_builds_a_host_device_mesh(tmp_path, monkeypatch):
    """A gloo group of one (a ``FileStore`` in ``tmp_path``; gloo on the
    loopback interface): ``ensure_distributed`` sees it, ``device_mesh``
    builds the 1 x 1 CPU mesh and refuses a 16 x 16 one; parameters placed
    by ``param_shardings`` are all ``Replicate``, and a forward through
    the placed (local) parameters equals the plain one bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.models import forward, init_params
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert ensure_distributed(expect_devices=1) == 1
        dm = device_mesh(make_host_mesh(), "cpu")
        assert dm.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="spans 256 devices"):
            device_mesh(make_production_mesh(), "cpu")
        cfg = get_config("delphi-2m", reduced=True).replace(dtype="float32")
        params = init_params(cfg, seed=0, device="cpu")
        placed = {}
        for k, spec in sh.param_shardings(make_host_mesh(), params).items():
            pl = sh.to_placements(spec, dm)
            assert pl == [Replicate(), Replicate()], k
            placed[k] = distribute_tensor(params[k], dm, pl)
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(
            rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)),
            "ages": torch.from_numpy(np.sort(rng.uniform(
                40, 70, (2, 16)), axis=1).astype(np.float32))}
        with torch.no_grad():
            want = forward(params, cfg, batch)["logits"]
            got = forward({k: v.to_local() for k, v in placed.items()},
                          cfg, batch)["logits"]
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="initialised process group"):
        device_mesh(make_host_mesh(), "cpu")


def test_to_placements_on_a_production_spec():
    """Specs on the 2 x 16 x 16 mesh: the batch over (pod, data) shards
    one dimension on both mesh axes; a model-sharded weight shards its
    dimension on the model axis."""
    from torch.distributed.tensor import Replicate, Shard
    m = make_production_mesh(multi_pod=True)
    spec = sh.batch_pspec(m, (64, 4096))
    assert spec == (("pod", "data"), None)
    assert sh.to_placements(spec, m) == [Shard(0), Shard(0), Replicate()]
    spec = sh.param_pspec(m, "layers/mlp/w_gate", (22, 2048, 5632))
    assert sh.to_placements(spec, m) == [Replicate(), Replicate(), Shard(2)]
    assert sh.shard_factor(m, spec) == 16
