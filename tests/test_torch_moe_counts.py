"""The dry run of the grouped MoE dispatches (``launch.dryrun`` with
``moe_impl="ragged"`` / ``"ragged_local"``, the reference's variants
``moe-ragged`` and ``moe-ragged-local``): reduced OLMoE-1B-7B (L 2, d 256,
4 heads of 64, E 4 of width 128, top-k 2, vocabulary 512, bf16) at B 4 x
S 64 on 4 x 1, 2 x 2 and 1 x 4 (data x model) meshes, per device, against
hand counts and against the JAX package's ``_extrapolated_counts`` on the
same meshes of 4 host devices (a subprocess).

The port's counts are exact hand counts, term by term:
* FLOPs (``_port_flops``): per layer the q, k, v and o projections (heads
  split over ``model``), the fp32 router (on ``route``'s 256-row blocks),
  attention, and the three grouped products over the rank's T·k routed
  rows (``launch.dryrun.grouped_mm_flops``: 2·rows·d·f each, whatever the
  routing; the experts split over ``model`` here, and the record's
  ``grouped`` says that a rank on the card multiplies only its own
  experts' rows, so that their count is an upper bound); the head; a train step three times its forward's
  products (no ``remat``).  ``ragged_local``'s rows are the device's own
  tokens, ``ragged``'s every token of the batch (the global sort).
* Collectives: a prefill's all-reduces of the embedding's and each
  layer's attention and expert partial sums over ``model`` ((1 + 2 L)
  rows of B S d / D in bf16), and ``ragged``'s all-gather of the tokens
  over the data axis (L x B S d in bf16).

Against the reference (ROADMAP §C records each difference):
* On 4 x 1 ``ragged_local``'s prefill sends nothing, on both sides, and
  its FLOPs a device fall below ``ragged``'s, on both sides: the global
  sort gives every device the whole batch's rows.
* 4 x 1 train: the gradients' all-reduce over the data axis in fp32 and
  three scalars, 4 n_params + 12 bytes, on both sides, byte for byte.
* XLA's CPU backend expands ``lax.ragged_dot`` into a product over every
  group (~E times the rows' FLOPs), so JAX counts ``ragged_local`` above
  ``dense_scan`` where the port counts it below (T·k rows against
  ``dense_scan``'s T·E).
* 2 x 2 and 1 x 4 prefill, term by term: JAX's partitioner reduces each
  grouped product's rows over ``model`` (gate, up and down: T·k x (2 f +
  d), fp32 after XLA's CPU all-reduce promotion), where the port reduces
  the (T, d) combine once a layer in bf16.
* 4 x 1 ``ragged``, term by term: JAX gathers the routing and all-reduces
  the gathered rows; the port all-gathers the tokens.
* 1 x 4 train under ``ragged_local``: XLA cannot compile it (a RET_CHECK
  in its SPMD partitioner: a cross-partition all-reduce outside manual
  mode); the port counts it, and the count is the hand count.
"""
import functools
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 64

_JAX_CODE = r"""
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch.dryrun import _extrapolated_counts

cfg = get_config("olmoe-1b-7b", reduced=True)
devs = np.array(jax.devices()[:4])
out = {}
for sizes, mode, impls in (
        ((4, 1), "prefill", ("dense_scan", "ragged", "ragged_local")),
        ((2, 2), "prefill", ("ragged", "ragged_local")),
        ((4, 1), "train", ("ragged_local",)),
        ((1, 4), "train", ("ragged", "ragged_local")),
        ((1, 4), "prefill", ("ragged", "ragged_local"))):
    mesh = Mesh(devs.reshape(sizes), ("data", "model"))
    for impl in impls:
        key = f"{sizes[0]}x{sizes[1]} {mode} {impl}"
        try:
            c = _extrapolated_counts(cfg, InputShape("t", 64, 4, mode), mesh,
                                     impl)
            out[key] = {"flops": c["flops"], "collectives": c["collectives"]}
        except Exception as e:  # noqa: BLE001
            out[key] = {"error": str(e)[:500]}
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _JAX_CODE],
                         capture_output=True, text=True, env=env,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _cfg():
    return get_config("olmoe-1b-7b", reduced=True)


@functools.lru_cache(maxsize=None)
def _port(sizes, mode, impl):
    return dryrun.count_step(_cfg(), InputShape("t", S, B, mode),
                             Mesh(("data", "model"), sizes), impl)


def _port_flops(sizes, mode, impl, grouped=False):
    """The hand count of one device's FLOPs (module docstring); with
    ``grouped``, the grouped products' alone."""
    c = _cfg()
    D, M = sizes
    L, d, E, k, f = c.n_layers, c.d_model, c.n_experts, c.top_k, c.moe_d_ff
    H, hd, V = c.n_heads, c.head_dim, c.vocab_size
    T = B * S
    mine = T // D                                  # the device's tokens
    rows = T if impl == "ragged" else mine         # the tokens it routes
    experts = 3 * 2 * rows * k * d * f
    layer = (2 * mine * d * 4 * H * hd // M              # q, k, v, o
             + 2 * 256 * math.ceil(rows / 256) * d * E   # the router
             + 2 * 2 * (B // D) * (H // M) * S * S * hd  # attention
             + experts)
    head_rows = B // D if mode == "prefill" else mine
    fwd = L * (experts if grouped else layer) \
        + (0 if grouped else 2 * head_rows * d * V // M)
    return fwd if mode == "prefill" else 3 * fwd


def _act(sizes):
    """One device's (B / D, S, d) bf16 rows."""
    return B // sizes[0] * S * _cfg().d_model * 2


@pytest.mark.parametrize("sizes,mode", [((4, 1), "prefill"), ((2, 2), "prefill"),
                                        ((1, 4), "prefill"), ((4, 1), "train"),
                                        ((1, 4), "train")])
@pytest.mark.parametrize("impl", ["ragged", "ragged_local"])
def test_port_counts_equal_the_hand_count(sizes, mode, impl):
    """Every term of the FLOPs, and the grouped products' share of them
    (the record's ``grouped`` term); a prefill's collectives: (1 + 2 L)
    rows' all-reduces over ``model`` (none on a 1-wide axis) and
    ``ragged``'s token all-gather over ``data`` (none on a 1-wide
    axis)."""
    c = _port(sizes, mode, impl)
    assert c["off_meta_bytes"] == 0
    assert c["flops"] == _port_flops(sizes, mode, impl)
    assert c["grouped_flops"] == _port_flops(sizes, mode, impl, grouped=True)
    if mode == "prefill":
        want = {}
        if sizes[1] > 1:
            want["all-reduce"] = (1 + 2 * _cfg().n_layers) * _act(sizes)
        if impl == "ragged" and sizes[0] > 1:
            want["all-gather"] = _cfg().n_layers * B * S * _cfg().d_model * 2
        assert c["collectives"] == want


def test_ragged_local_prefill_on_4x1_sends_nothing_as_the_reference():
    """Each device sorts, gathers and scatters its own rows: no collective
    in the port's count or JAX's, and fewer FLOPs a device than
    ``ragged``'s global sort on both sides (JAX 3.13x, the port 2.19x:
    XLA's CPU expansion of ``ragged_dot`` inflates both of JAX's)."""
    j = _jax()
    local, glob = j["4x1 prefill ragged_local"], j["4x1 prefill ragged"]
    assert local["collectives"] == {} and local["flops"] == 289523872
    assert glob["flops"] == 905706112
    assert glob["collectives"] == {"all-gather": 12288,
                                   "all-reduce": 1056768}
    assert _port((4, 1), "prefill", "ragged_local")["collectives"] == {}
    assert local["flops"] < glob["flops"]
    assert _port((4, 1), "prefill", "ragged_local")["flops"] \
        < _port((4, 1), "prefill", "ragged")["flops"]


def test_the_global_sort_multiplies_each_device_s_expert_rows():
    """``ragged`` on a data-split mesh routes, sorts and multiplies the
    whole batch's T·k rows on every device: the port's count exceeds
    ``ragged_local``'s by exactly the other devices' rows' router and
    expert products, on 4 x 1 and 2 x 2; with one data shard (1 x 4) the
    two are the same step.  JAX's 2 x 2 prefill shows the same excess."""
    c = _cfg()
    for sizes in ((4, 1), (2, 2)):
        extra = (_port(sizes, "prefill", "ragged")["flops"]
                 - _port(sizes, "prefill", "ragged_local")["flops"])
        other = B * S - B * S // sizes[0]
        assert extra == c.n_layers * 3 * 2 * other * c.top_k * c.d_model \
            * c.moe_d_ff
    a, b = _port((1, 4), "prefill", "ragged"), \
        _port((1, 4), "prefill", "ragged_local")
    assert (a["flops"], a["collectives"]) == (b["flops"], b["collectives"])
    j = _jax()
    assert j["2x2 prefill ragged"]["flops"] == 502616544
    assert j["2x2 prefill ragged_local"]["flops"] == 292796896


def test_4x1_train_all_reduce_equals_the_reference_byte_for_byte():
    """Every parameter whole on every device: the gradients' all-reduce in
    fp32 and three scalars (the loss, its CE and the aux's mean over the
    data shards), 4 n_params + 12 bytes, on both sides."""
    from repro_torch.models.params import param_shapes
    import torch
    n = sum(int(torch.Size(s).numel()) for s in param_shapes(_cfg()).values())
    want = {"all-reduce": 4 * n + 12}
    assert _jax()["4x1 train ragged_local"]["collectives"] == want
    assert _port((4, 1), "train", "ragged_local")["collectives"] == want


def test_jax_counts_ragged_dot_as_a_product_over_every_group():
    """JAX's ``ragged_local`` 4 x 1 prefill counts above its
    ``dense_scan`` (XLA's CPU lowering multiplies every row by every
    group); the port's falls below its ``dense_scan`` by the (E - k) x T
    rows the grouped products skip, less ``dense_scan``'s combine."""
    j = _jax()
    assert j["4x1 prefill ragged_local"]["flops"] \
        > j["4x1 prefill dense_scan"]["flops"] == 198611344
    c = _cfg()
    mine = B * S // 4
    drop = (_port((4, 1), "prefill", "dense_scan")["flops"]
            - _port((4, 1), "prefill", "ragged_local")["flops"])
    # dense_scan's router runs unpadded (64 rows), the ragged route's in a
    # 256-row block
    router = 2 * (256 - mine) * c.d_model * c.n_experts
    assert drop == c.n_layers * (3 * 2 * (c.n_experts - c.top_k) * mine
                                 * c.d_model * c.moe_d_ff
                                 + 2 * mine * c.d_model * c.n_experts
                                 - router)


@pytest.mark.parametrize("sizes", [(2, 2), (1, 4)])
def test_prefill_collectives_against_the_reference_term_by_term(sizes):
    """``ragged_local``'s prefill where the experts split over ``model``,
    in bytes a device; ``act`` one device's (B / D, S, d) rows, ``rows``
    its T·k routed rows (T = B S / D).

    XLA's SPMD partitioner emits JAX's step with the embedding's gather
    and each layer's attention output projection all-reduced (1 + L act),
    and each layer's three grouped products reduced as partial sums over
    the experts: gate and up (2 x rows x f), down (rows x d), besides six
    int32 scalars and four gathered (E,) int32 group-size vectors a
    layer; XLA's CPU pipeline then widens every all-reduce to fp32.

    The port multiplies only each rank's own experts' rows, so gate, up
    and SiLU stay local, and it reduces the (T, d) combine once a layer
    in bf16 ((1 + 2 L) act): the difference is where the experts' partial
    sums meet, and their width."""
    c = _cfg()
    L, k, f, d, E = c.n_layers, c.top_k, c.moe_d_ff, c.d_model, c.n_experts
    act, rows = _act(sizes), B * S // sizes[0] * k
    key = f"{sizes[0]}x{sizes[1]} prefill ragged_local"
    assert _jax()[key]["collectives"] == {
        "all-reduce": 2 * act * (1 + L) + L * 4 * rows * (2 * f + d)
        + 6 * 4,
        "all-gather": L * 4 * E * 4}
    assert _port(sizes, "prefill", "ragged_local")["collectives"] == {
        "all-reduce": (1 + 2 * L) * act}


def test_the_global_sort_s_collectives_against_the_reference():
    """``ragged`` on 4 x 1, in bytes a device (no model split): JAX's
    partitioner gathers each layer's router probabilities (T x E fp32, for
    the aux's mean) and routed experts (T·k int32) over the data axis and
    all-reduces the gathered token indices (T·k int32), their weights
    (T·k fp32) and the gathered rows x[sorted_token] (T·k x d, fp32 after
    XLA's CPU promotion); the port gathers each layer's tokens (T x d
    bf16) and routes them on every device, so it sends no all-reduce."""
    c = _cfg()
    L, k, d, E = c.n_layers, c.top_k, c.d_model, c.n_experts
    T = B * S
    assert _jax()["4x1 prefill ragged"]["collectives"] == {
        "all-gather": L * (T * E * 4 + T * k * 4),
        "all-reduce": L * (T * k * 4 + T * k * 4 + T * k * d * 4)}
    assert _port((4, 1), "prefill", "ragged")["collectives"] == {
        "all-gather": L * T * d * 2}


def test_1x4_ragged_local_train_counts_where_xla_cannot_compile():
    """XLA's SPMD partitioner refuses the reference's 1 x 4
    ``ragged_local`` train step; the port counts it: the FLOPs hand count,
    and the all-reduces: the forward's (1 + 2 L) rows, the log-sum-exp's
    max and sum and the target logit over the vocabulary-split head (3
    rows of B (S - 1) fp32), the head's input gradient and each layer's
    attention and expert input gradients (1 + 2 L rows), each layer's
    routing weights' gradient (T·k fp32, partial over ``model``), and
    the global norm's two scalars."""
    j = _jax()["1x4 train ragged_local"]
    assert "Cross-partition allreduce must be in (partial) manual " \
        "partitioning mode" in j["error"]
    assert _jax()["1x4 train ragged"]["flops"] == 971795968
    c = _cfg()
    L, act = c.n_layers, _act((1, 4))
    port = _port((1, 4), "train", "ragged_local")
    assert port["flops"] == _port_flops((1, 4), "train", "ragged_local") \
        == 883949568
    assert port["collectives"] == {"all-reduce": (
        (1 + 2 * L) * act + 3 * B * (S - 1) * 4 + (1 + 2 * L) * act
        + L * B * S * c.top_k * 4 + 2 * 4)}
