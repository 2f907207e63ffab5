"""The sharded step's collective count (``repro_torch.launch.collectives``)
and the dry run on DTensors (``launch.dryrun``), against hand counts and
the JAX package's partitioned-HLO count on the CPU.

* ``CollectiveCounter`` names each kind as the reference's HLO does and
  counts a device's result bytes; ``fake_device_mesh`` builds and tears
  down its fake group.
* Reduced TinyLlama's train step on a 4 x 1 (data x model) mesh sends the
  all-reduce bytes of JAX's ``_extrapolated_counts`` on the same mesh
  (JAX in a subprocess with 4 host devices), but for scalars.
* Its prefill and train step on a 1 x 4 mesh against JAX term by term:
  the collectives XLA's SPMD partitioner emits for the reference's step
  (read from its dump after that pass) and those
  ``_extrapolated_counts`` reads after XLA's CPU pipeline, whose
  ``all-reduce-promotion`` pass widens every bf16 all-reduce to fp32.
* ``seq_shard_attn`` on a model axis the query heads do not divide: the
  per-device attention FLOPs fall by the axis size, and JAX's count falls
  with it.
* InternVL2, SeamlessM4T, Mamba2 and Zamba2 at full width, cut to 2
  layers, at the four input shapes on 16 x 16 (the dense and MoE LMs:
  ``tests/test_torch_sharded_zoo.py``): counted on the meta device with
  nothing made off it; ``remat`` recomputes the forward's collectives; a
  Mamba2 layer's gathers by hand; the dry run's CLI takes ``--variant``
  and refuses the ragged variants by name; the roofline's collective term
  can now dominate.
"""
import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.collectives import CollectiveCounter, collective_kind
from repro_torch.launch.mesh import Mesh, fake_device_mesh
from repro_torch.launch.specs import long_context_cfg
from repro_torch.models.params import param_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "tinyllama-1.1b"
B, S = 4, 64


def _tiny(**over):
    return get_config(TINY, reduced=True).replace(**over)


_JAX_CODE = r"""
import glob, json, os
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch.dryrun import (_diff, _extrapolated_counts, _lin,
                                 build_step_fn, collective_bytes)
from repro.launch.specs import input_specs
DUMP = os.environ["PARTITIONED_HLO_DIR"]


def partitioned(cfg, shape, mesh):
    # the collectives of the step as XLA's SPMD partitioner emits it (the
    # dump after that pass), at depth 1 and 2, extrapolated as
    # _extrapolated_counts extrapolates its compiled counts
    base = cfg.replace(unroll_layers=True, attn_direct=True)
    counts = []
    for n in (1, 2):
        c = base.replace(n_layers=n)
        args, shardings = input_specs(c, shape, mesh)
        seen = set(glob.glob(DUMP + "/*after_spmd-partitioning*"))
        with mesh:
            jax.jit(build_step_fn(c, shape),
                    in_shardings=shardings).lower(*args).compile()
        f, = set(glob.glob(DUMP + "/*after_spmd-partitioning*")) - seen
        with open(f) as fh:
            counts.append({"flops": 0.0, "bytes": 0.0,
                           "collectives": collective_bytes(fh.read())})
    d = _diff(counts[1], counts[0])
    return _lin(counts[0], d, cfg.n_layers - 1)["collectives"]


out = {}
devs = np.array(jax.devices()[:4])
for name, sizes, mode, over in (
        ("4x1 train", (4, 1), "train", {}),
        ("1x4 prefill", (1, 4), "prefill", {}),
        ("1x4 train", (1, 4), "train", {}),
        ("1x4 prefill heads6", (1, 4), "prefill", {"n_heads": 6}),
        ("1x4 prefill heads6 seqshard", (1, 4), "prefill",
         {"n_heads": 6, "seq_shard_attn": True})):
    mesh = Mesh(devs.reshape(sizes), ("data", "model"))
    cfg = get_config("tinyllama-1.1b", reduced=True).replace(**over)
    shape = InputShape("t", 64, 4, mode)
    c = _extrapolated_counts(cfg, shape, mesh)
    out[name] = {"flops": c["flops"], "collectives": c["collectives"]}
    if name in ("1x4 prefill", "1x4 train"):
        out[name]["partitioned"] = partitioned(cfg, shape, mesh)
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _jax_counts():
    """JAX's ``_extrapolated_counts`` for reduced TinyLlama at 4 x 64 on
    small meshes of 4 host devices, in a process of its own (the device
    count is fixed when JAX starts); on 1 x 4 also the partitioner's own
    count (``partitioned``), from XLA's HLO dump after SPMD partitioning."""
    import tempfile
    with tempfile.TemporaryDirectory() as dump:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu", PARTITIONED_HLO_DIR=dump,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                             f"--xla_dump_to={dump} "
                             "--xla_dump_hlo_pass_re=spmd-partitioning")
        out = subprocess.run([sys.executable, "-c", _JAX_CODE],
                             capture_output=True, text=True, env=env,
                             timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _count(cfg, mode, sizes):
    return dryrun.count_step(cfg, InputShape("t", S, B, mode),
                             Mesh(("data", "model"), sizes))


# --- the counter ----------------------------------------------------------

def _redistribute(src, dst, device_type):
    """One redistribution of a (8, 16) fp32 tensor on a fake 2 x 2 mesh,
    counted: (counter, the local result's bytes)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    names = {"R": Replicate(), "P": Partial(), "S0": Shard(0),
             "S1": Shard(1)}
    with fake_device_mesh(Mesh(("data", "model"), (2, 2)),
                          device_type) as dm:
        pl = [Replicate(), names[src]]
        shape = [8, 16]
        if src.startswith("S"):
            shape[int(src[1])] //= 2
        x = DTensor.from_local(torch.empty(shape, device="meta"), dm, pl,
                               run_check=False)
        with CollectiveCounter() as cc:
            y = x.redistribute(dm, [Replicate(), names[dst]])
        local = y.to_local()
    return cc, local.numel() * local.element_size()


@pytest.mark.parametrize("src,dst,kind", [
    ("P", "R", "all-reduce"), ("S0", "R", "all-gather"),
    ("P", "S0", "reduce-scatter"), ("S0", "S1", "all-to-all")])
def test_counter_names_each_kind_and_counts_result_bytes(src, dst, kind):
    """Partial -> Replicate, Shard -> Replicate, Partial -> Shard and
    Shard(0) -> Shard(1) over the model axis: one collective each, under
    the reference's kind name, its bytes the device's result."""
    cc, nbytes = _redistribute(src, dst, "cuda")
    assert cc.bytes == {kind: nbytes} and cc.calls == {kind: 1}
    assert cc.total == nbytes


def test_a_cpu_mesh_gathers_where_the_cards_exchange():
    """DTensor moves a CPU mesh's shards between dimensions by an
    all-gather of the whole (gloo has no all-to-all): the dry run counts
    on a mesh of the cards' type."""
    cc, nbytes = _redistribute("S0", "S1", "cpu")
    assert cc.bytes == {"all-gather": 2 * nbytes}


def test_collective_kind_reads_only_collectives():
    ops = torch.ops
    assert collective_kind(ops._c10d_functional.all_reduce.default) \
        == "all-reduce"
    assert collective_kind(
        ops._c10d_functional.all_gather_into_tensor.default) == "all-gather"
    assert collective_kind(ops._c10d_functional.wait_tensor.default) == ""
    assert collective_kind(ops.aten.mm.default) == ""


def test_a_tensor_parallel_mlp_sends_one_all_reduce_and_allocates_nothing():
    """Column- then row-split products on a fake 16 x 16 mesh: one
    all-reduce of the output's local rows, every tensor on meta."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import LocalTraffic
    with fake_device_mesh(Mesh(("data", "model"), (16, 16))) as dm:
        def place(shape, pl, full):
            return DTensor.from_local(torch.empty(shape, device="meta"), dm,
                                      pl, run_check=False,
                                      shape=torch.Size(full),
                                      stride=torch.empty(
                                          full, device="meta").stride())
        x = place((2, 64), [Shard(0), Replicate()], (32, 64))
        w1 = place((64, 16), [Replicate(), Shard(1)], (64, 256))
        w2 = place((16, 64), [Replicate(), Shard(0)], (256, 64))
        with LocalTraffic() as t:
            y = ((x @ w1).relu() @ w2).redistribute(
                dm, [Shard(0), Replicate()])
        assert y.shape == (32, 64)
    assert t.bytes == {"all-reduce": 2 * 64 * 4} and t.off_meta_bytes == 0


def test_fake_device_mesh_is_made_and_destroyed():
    import torch.distributed as dist
    with fake_device_mesh(Mesh(("pod", "data", "model"), (2, 16, 16))) as dm:
        assert dm.mesh_dim_names == ("pod", "data", "model")
        assert tuple(dm.mesh.shape) == (2, 16, 16)
        assert dist.get_world_size() == 512
        with pytest.raises(RuntimeError, match="without a process group"):
            with fake_device_mesh(Mesh(("data", "model"), (1, 1))):
                pass
    assert not dist.is_initialized()


# --- against JAX and hand counts ------------------------------------------

def test_train_all_reduce_equals_jax_on_4x1():
    """4 x 1: every parameter is whole on every device, so the only
    collective is the gradients' all-reduce in fp32: n_params x 4 bytes.
    JAX adds one 4-byte scalar (the loss, 5,510,148 B in all); the port
    reduces two fp32 scalars before the backward, the loss and the
    ``event_ce`` metric (the CE that JAX's loss and metric share), so it
    sends 4 B more.  Nothing else differs."""
    n_params = sum(int(torch.Size(s).numel())
                   for s in param_shapes(_tiny()).values())
    jax_ar = _jax_counts()["4x1 train"]["collectives"]
    assert jax_ar == {"all-reduce": 4 * n_params + 4}
    port = _count(_tiny(), "train", (4, 1))["collectives"]
    assert port == {"all-reduce": 4 * n_params + 2 * 4}
    assert 0 < port["all-reduce"] - jax_ar["all-reduce"] <= 64


def test_prefill_all_reduces_equal_a_hand_count_on_1x4():
    """1 x 4 (4 query heads and d_ff 512 divide the axis; the vocabulary
    of 512 too): the embedding's vocabulary-split gather ends in an
    all-reduce of the B x S x d rows, and each layer's attention output
    projection and MLP down product in one each; the head's logits stay
    split over the vocabulary, and the 1-KV-head projections are whole on
    every device.  All in bf16: (1 + 2 L) x B S d x 2 bytes = 655,360 B,
    as XLA's SPMD partitioner emits JAX's step.  ``_extrapolated_counts``
    reads 1,310,720 B: the same five all-reduces after XLA's CPU pipeline,
    whose ``all-reduce-promotion`` pass widens each bf16 all-reduce to
    fp32 (a choice of the CPU backend, after partitioning)."""
    cfg = _tiny()
    want = (1 + 2 * cfg.n_layers) * B * S * cfg.d_model * 2
    assert _count(cfg, "prefill", (1, 4))["collectives"] == \
        {"all-reduce": want}
    jax_counts = _jax_counts()["1x4 prefill"]
    assert jax_counts["partitioned"] == {"all-reduce": want}
    assert jax_counts["collectives"] == {"all-reduce": 2 * want}


def test_train_all_reduces_against_jax_term_by_term_on_1x4():
    """The train step on 1 x 4 (reduced TinyLlama, 4 x 64), in bytes a
    device, L layers; ``act`` a (B, S, d) bf16 partial sum, ``kv`` a (B,
    S, Hkv, hd) bf16 key or value gradient, ``lse`` a (B, S - 1) fp32 row
    reduction over the vocabulary-split logits.

    XLA's SPMD partitioner emits JAX's step with: forward, the embedding's
    gather, each layer's output projection and down product ((1 + 2 L)
    act) and the log-sum-exp's max and sum (2 lse); backward, the head's
    input gradient (act), each layer's w_gate and w_up input gradients
    reduced one by one (2 act), its q projection's input gradient (act)
    and its key and value gradients (2 kv: the one KV head is whole on
    every device, the query heads that read it split); the target logit
    (lse) and the global norm's squared sums of the 7 model-split leaves
    (embed, lm_head, wq, wo, w_gate, w_up, w_down), one scalar each.

    ``_extrapolated_counts`` (3,410,924 B) is that after XLA's CPU
    pipeline, whose ``all-reduce-promotion`` pass widens every bf16
    all-reduce to fp32: (2 + 5 L) act + 2 L kv more.

    The port (1,575,896 B) reduces in the partitioner's dtypes, and places
    three reductions otherwise (the partitioner's own choices; nothing is
    left out, nothing narrowed):
    * the w_gate and w_up input gradients are summed before one all-reduce
      of the MLP's input (``sharded.gather_grad``): L act fewer;
    * the key and value gradients stay partial into wk and wv, whose
      weight gradients are reduced once a leaf in fp32 with the others: 2
      L kv fewer, 2 L x d Hkv hd x 4 more;
    * the global norm sums the leaves' squares in sorted order, DTensor
      reducing the running partial sum where it first meets a replicated
      leaf's: 2 scalars, not 7."""
    cfg = _tiny()
    L, d, Hkv, hd = cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    act, kv, lse = B * S * d * 2, B * S * Hkv * hd * 2, B * (S - 1) * 4
    jax_counts = _jax_counts()["1x4 train"]
    part = jax_counts["partitioned"]["all-reduce"]
    assert jax_counts["partitioned"] == {"all-reduce": (
        (1 + 2 * L) * act + 2 * lse
        + act + L * (2 * act + act + 2 * kv)
        + lse + 7 * 4)}
    assert jax_counts["collectives"] == {
        "all-reduce": part + (2 + 5 * L) * act + 2 * L * kv}
    assert jax_counts["collectives"] == {"all-reduce": 3410924}
    port = _count(cfg, "train", (1, 4))["collectives"]
    assert port == {"all-reduce": part - L * act - 2 * L * kv
                    + 2 * L * d * Hkv * hd * 4 - 5 * 4}
    assert port == {"all-reduce": 1575896}


def test_seq_shard_attn_cuts_the_repeated_attention():
    """6 query heads on a 4-way model axis do not divide it, so without
    ``seq_shard_attn`` every device of the axis computes the whole
    attention (its S x S scores, their product with V) and the whole
    output projection (whose weight the 6 heads leave whole).  With it
    each device takes S / 4 query rows of both: its FLOPs fall by exactly
    3/4 of that work.  JAX's count falls too, by at least as much."""
    cfg = _tiny(n_heads=6)
    H, hd, d, L = cfg.n_heads, cfg.head_dim, cfg.d_model, cfg.n_layers
    attn = L * (2 * 2 * B * H * S * S * hd + 2 * B * S * H * hd * d)
    plain = _count(cfg, "prefill", (1, 4))["flops"]
    shard = _count(cfg.replace(seq_shard_attn=True), "prefill",
                   (1, 4))["flops"]
    assert plain - shard == attn * 3 / 4
    j = _jax_counts()
    drop = j["1x4 prefill heads6"]["flops"] \
        - j["1x4 prefill heads6 seqshard"]["flops"]
    assert drop >= attn * 3 / 4


# --- the dry run ----------------------------------------------------------

ZOO = ["internvl2-26b", "seamless-m4t-large-v2", "mamba2-780m",
       "zamba2-1.2b"]


@pytest.mark.parametrize("shape", [s.name for s in INPUT_SHAPES])
@pytest.mark.parametrize("arch", ZOO)
def test_the_rest_of_the_zoo_counts_at_full_width_on_16x16(arch, shape):
    """The VLM, the encoder-decoder, Mamba2 and the hybrid at their
    published widths, depth cut to 2 layers (SeamlessM4T's encoder too;
    Zamba2's shared block then applies once): the sharded step runs on meta
    DTensors over a fake 16 x 16 group, sends collectives and makes
    nothing off the meta device (the dense and MoE LMs:
    ``tests/test_torch_sharded_zoo.py``)."""
    from repro_torch.configs import get_shape
    shp = get_shape(shape)
    cut = get_config(arch).replace(n_layers=2)
    if cut.n_encoder_layers:
        cut = cut.replace(n_encoder_layers=2)
    c = dryrun.count_step(long_context_cfg(cut, shp), shp,
                          dryrun.make_production_mesh())
    assert c["off_meta_bytes"] == 0
    assert c["flops"] > 0 and sum(c["collectives"].values()) > 0


def test_remat_recomputes_the_forward_collectives():
    """Reduced TinyLlama's train step on a fake 2 x 2 group with ``remat``
    (the dry run's training baseline): each layer's forward runs again in
    the backward, checkpointed DTensors and all, so it sends more
    all-reduce bytes and counts more FLOPs than without."""
    plain = _count(_tiny(), "train", (2, 2))
    remat = _count(_tiny(remat=True), "train", (2, 2))
    assert remat["collectives"]["all-reduce"] \
        > plain["collectives"]["all-reduce"]
    assert remat["flops"] > plain["flops"]


def test_dry_run_refuses_the_ragged_variants_by_name():
    for variant, impl in (("moe-ragged", "ragged"),
                          ("moe-ragged-local", "ragged_local")):
        with pytest.raises(ValueError, match=f"moe_impl '{impl}'"):
            dryrun.dryrun_one("olmoe-1b-7b", "decode_32k", variant=variant)
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.dryrun_one(TINY, "decode_32k", variant="ragged")


@pytest.mark.parametrize("variant,field,value", [
    ("moe-einsum", "moe_impl", "dense_einsum"), ("no-remat", "remat", False),
    ("seqshard", "seq_shard_attn", True)])
def test_dry_run_takes_the_reference_variants(variant, field, value,
                                              tmp_path):
    """Each variant the dry run runs sets its field in the record and in
    the record's file name (full-depth OLMoE-1B-7B's decode_32k)."""
    rec = dryrun.dryrun_one("olmoe-1b-7b", "decode_32k", variant=variant,
                            out=str(tmp_path))
    assert rec["variant"] == variant and rec[field] == value
    assert rec["collective_total"] > 0
    assert (tmp_path / f"olmoe-1b-7b_decode_32k_16x16_{variant}.json"
            ).exists()


def test_mamba2_layers_run_whole_on_each_rank_of_the_model_axis():
    """Mamba2-780M's decode on 16 x 16 (2 layers): its in-projection packs
    z, x, B, C and dt along one width that the reference's spec splits
    over ``model`` across their boundaries, so each layer's weights and
    state are gathered whole over the axis (counted) and the layer runs
    on each rank's 8 rows; the 50,280-entry vocabulary does not divide 16,
    so nothing else is sent."""
    from repro_torch.configs import get_shape
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import params_spec
    from repro_torch.models.ssm import conv_channels
    cfg = get_config("mamba2-780m").replace(n_layers=2)
    mesh = dryrun.make_production_mesh()
    c = dryrun.count_step(cfg, get_shape("decode_32k"), mesh)
    ssm = {k: v for k, v in params_spec(cfg, serving=True).items()
           if k.startswith("layers/ssm/")}
    split = sum(v[0].numel() * v.element_size() for k, v in ssm.items()
                if sh.shard_factor(mesh, sh.param_pspec(mesh, k, v.shape)) > 1)
    rows = 128 // 16
    state = rows * cfg.ssm_n_heads * cfg.ssm_state * cfg.ssm_head_dim * 4
    conv = rows * cfg.ssm_conv * conv_channels(cfg) * 2
    want = cfg.n_layers * (split + state
                           + (conv if conv_channels(cfg) % 16 == 0 else 0))
    assert c["collectives"] == {"all-gather": want}
    assert c["off_meta_bytes"] == 0


def test_dry_run_cli_variant_and_the_collective_term(tmp_path):
    """``--variant seqshard`` writes its tag and a record with the
    collectives by kind and no note; TinyLlama's decode (its 4-KV-head
    rings split over the width and gathered for attention: 0.54 GB a
    device for 2 layers) is dominated by the roofline's collective term,
    whose suggestion is now reachable."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", TINY,
         "--shape", "prefill_32k", "--variant", "seqshard", "--out",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith(f"OK   {TINY}_prefill_32k_16x16_seqshard")
    rec, = roofline.load_records(str(tmp_path))
    assert rec["variant"] == "seqshard" and rec["seq_shard_attn"]
    assert "collective_note" not in rec
    assert rec["collective_total"] == sum(
        rec["collective_bytes_per_device"].values()) > 0
    assert rec["flops_total"] == rec["flops_per_device"] * 256
    shp = dryrun.get_shape("decode_32k")
    cfg = get_config(TINY).replace(n_layers=2)
    c = dryrun.count_step(cfg, shp, dryrun.make_production_mesh())
    rec = {"arch": TINY, "mode": "decode", "n_chips": 256,
           "seq_len": shp.seq_len, "global_batch": shp.global_batch,
           "flops_per_device": c["flops"], "bytes_per_device": c["bytes"],
           "collective_total": float(sum(c["collectives"].values()))}
    a = roofline.analyse(rec, cfg)
    assert a["dominant"] == "collective"
    assert a["suggestion"] == roofline._SUGGEST["collective"]
