"""Dry run of every (architecture x input shape x mesh) step on the meta
device: FLOPs, bytes, collective bytes and memory per device, without a
byte allocated (the JAX package's ``launch/dryrun.py``).

Usage (one combination, or the sweep over the zoo's 10 architectures and
the four shapes):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        tinyllama-1.1b --shape train_4k [--variant seqshard] \
        [--multi-pod] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference lowers and compiles each step for 512 fake XLA devices and
reads XLA's cost analysis and the partitioned HLO's collectives.  The port
runs the sharded step itself, eagerly, on DTensors: the step's arguments
(``launch.specs``' meta tensors) are laid out by ``launch.sharding``'s
specs (``distribute_tree``) over a ``DeviceMesh`` of the production mesh
on a ``fake`` process group (``launch.mesh.fake_device_mesh``), so each
DTensor holds a meta tensor of one device's shard and every collective
returns a meta tensor of its result's shape.  ``train`` is the loss, its
backward and the AdamW update (with ``remat``, the deployment baseline of
the reference's dry run), ``prefill`` is ``forward(mode="prefill")`` and
``decode`` is ``decode_step``.  What one device runs of that step is
counted as it is dispatched (the operations on its local tensors, not
DTensor's global view of them):

* FLOPs of its products, by the rules of ``torch.utils.flop_counter``.
  Attention runs each rank's shards through the kernels' plain versions
  (``kernels/ops.py`` takes them on the meta device), so the count is the
  same work whatever implements it.  Work that the layout repeats on every
  device of an axis (attention whose heads do not divide the model axis,
  a Mamba2 layer, which runs whole on each device's rows) is counted on
  each, as in the reference's partitioned counts.  An eager
  stack runs every layer, so each is counted: the reference's one- and
  two-layer extrapolation and its ``unroll_layers``/``attn_direct``
  lowering modes have no role here and are not ported.
* Bytes: each local operation's tensor inputs read and outputs written once
  at their logical size (views and metadata operations move nothing): the
  unfused eager step's traffic, the counterpart of XLA's "bytes accessed".
* Collectives (``launch.collectives``): each functional collective's
  result bytes on the device, by the reference's kind names.
* Memory: the arguments' bytes per device under their shardings
  (parameters, optimizer state, cache, batch) and the largest sum of the
  device's live local activations the step reaches.

``flops_total`` and ``bytes_total`` are the device's counts times the
mesh's devices.  ``--variant`` takes the reference's variant names:
``seqshard`` (``ModelConfig.seq_shard_attn``), ``moe-einsum``,
``moe-ragged``, ``moe-ragged-local`` and ``no-remat``.  The grouped
dispatches run on the meta DTensors as on the card: the routing's sort
and the group offsets are shapes without values there, and a grouped
product (``torch._grouped_mm``) counts 2·M·K·N for M rows, whatever the
offsets (:func:`grouped_mm_flops`).  A device's M is the top-k rows of
every token it routes (its own under ``ragged_local``, the whole batch's
under ``ragged``); where the experts split over ``model`` a device on
the card multiplies only the rows routed to its own experts, a number
the data decides, so the count is of the static shapes it runs (no
routing is invented), an upper bound by up to the model axis's width.
The record's ``grouped`` says which rows were counted, whether the count
is exact or that upper bound, and the grouped products' FLOPs a device
(``flops_per_device`` includes them), which ``launch.roofline`` reads to
state the compute term with and without them.

Each combination writes one JSON record with the reference's keys where a
number has a counterpart (``arch``, ``shape``, ``variant``, ``mesh``,
``mode``, ``seq_len``, ``global_batch``, ``n_chips``, ``flops_per_device``,
``bytes_per_device``, ``collective_bytes_per_device``,
``collective_total``, ``memory.peak_estimate_bytes``, ...), which
``launch.roofline`` reads.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 get_shape)
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.collectives import (CollectiveCounter,
                                            in_shape_propagation)
from repro_torch.launch.mesh import (fake_device_mesh, make_production_mesh,
                                     model_axis_size)
from repro_torch.launch.specs import flat_args, input_specs, long_context_cfg
from repro_torch.models import decode_step, forward
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import make_train_step

# the reference's variants: (config override, MoE dispatch)
VARIANTS = {
    "seqshard": (dict(seq_shard_attn=True), "dense_scan"),
    "moe-einsum": ({}, "dense_einsum"),
    "moe-ragged": ({}, "ragged"),
    "moe-ragged-local": ({}, "ragged_local"),
    "no-remat": (dict(remat=False), "dense_scan"),
}

def grouped_mm_flops(a, b, *args, out_val=None, **kwargs) -> int:
    """FLOPs of ``aten._grouped_mm``, whatever its offsets: every row of
    the grouped operand meets exactly one group, so rows ``a`` (M, K)
    against a stack ``b`` (E, K, N) are 2·M·K·N (the routing moves rows
    between groups, not their number).  The backward's (K, M) x (M, N)
    product grouped along M, out (E, K, N), is 2·K·M·N; a batched (E, M,
    K) x (E, K, N) is 2·E·M·K·N."""
    n = 2 * a.shape[-1] * out_val.numel()
    return n // out_val.shape[0] if a.dim() == 2 and b.dim() == 2 else n


class LocalFlops(TorchDispatchMode):
    """``torch.utils.flop_counter.FlopCounterMode``'s count (its rules,
    and the decomposition of an operation it has no rule for) over the
    operations one device runs, with a rule for the grouped product
    (:func:`grouped_mm_flops`), which it lacks: a DTensor operation is
    passed on to DTensor (``NotImplemented``), whose local operations
    come back here, and DTensor's shape propagation is not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.grouped_flops = 0
        self.registry = {**FlopCounterMode(display=False).flop_registry,
                         torch.ops.aten._grouped_mm: grouped_mm_flops}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and issubclass(t, torch.Tensor)
               and not issubclass(t, FakeTensor) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        if packet not in self.registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if packet in self.registry and not in_shape_propagation():
            n = self.registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            if packet is torch.ops.aten._grouped_mm:
                self.grouped_flops += n
        return out


class LocalTraffic(CollectiveCounter):
    """The collectives of :class:`CollectiveCounter` and, over the
    operations one device runs, the bytes of their tensor inputs and
    outputs (view operations excluded), the peak of the live bytes of the
    tensors they made, and the bytes of any tensor made off the meta
    device."""

    def __init__(self):
        super().__init__()
        self.traffic = 0
        self.live = 0
        self.peak = 0
        self.off_meta_bytes = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def count(self, func, args, kwargs, out) -> None:
        self.record(func, out)
        if getattr(func, "is_view", False):
            return
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        for t in ins + outs:
            self.traffic += t.numel() * t.element_size()
        for o in outs:
            n = o.numel() * o.element_size()
            if o.device.type != "meta":
                self.off_meta_bytes += n
            self.live += n
            weakref.finalize(o, self._free, n)
        self.peak = max(self.peak, self.live)


def build_step_fn(cfg: ModelConfig, shape: InputShape,
                  moe_impl: str = "dense_scan") -> Callable:
    """The step of ``shape.mode`` over :func:`launch.specs.input_specs`'
    arguments."""
    if shape.mode == "train":
        objective = "delphi" if cfg.age_encoding else "lm"
        return make_train_step(cfg, OptimizerConfig(), objective,
                               moe_impl=moe_impl)
    if shape.mode == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                out = forward(params, cfg, batch, mode="prefill",
                              moe_impl=moe_impl)
            return out["logits"][:, -1], out["cache"]
        return prefill_step

    def serve_step(params, cache, batch, step):
        with torch.no_grad():
            out = decode_step(params, cfg, cache, batch, step,
                              moe_impl=moe_impl)
        return out["logits"], out["cache"]
    return serve_step


def distribute_args(args, shardings, dmesh):
    """:func:`launch.specs.input_specs`' arguments as DTensors laid out by
    their shardings on ``dmesh`` (meta tensors stay meta: each DTensor
    holds one device's shard)."""
    return tuple(sh.distribute_leaf(a, s, dmesh) if isinstance(a, torch.Tensor)
                 else sh.distribute_tree(a, s, dmesh)
                 for a, s in zip(args, shardings))


def count_sharded(step: Callable, args, shardings, mesh,
                  device_type: str = "cuda") -> Dict:
    """Run ``step(*args)`` once with its arguments laid out as DTensors by
    ``shardings`` (:func:`distribute_args`) over a fake process group of
    ``mesh`` (a mesh of ``device_type``: ``"cpu"`` takes a gloo group's
    collectives), under the counters: one device's FLOPs, bytes,
    collective bytes by kind and live-activation peak, and the bytes made
    off the meta device (0 for meta arguments)."""
    flops = LocalFlops()
    traffic = LocalTraffic()
    with fake_device_mesh(mesh, device_type) as dm:
        dargs = distribute_args(args, shardings, dm)
        with flops, traffic:
            out = step(*dargs)
            del out
        del dargs
    return {"flops": float(flops.flops),
            "grouped_flops": float(flops.grouped_flops),
            "bytes": float(traffic.traffic),
            "collectives": dict(traffic.bytes),
            "activation_peak": float(traffic.peak),
            "off_meta_bytes": traffic.off_meta_bytes}


def count_step(cfg: ModelConfig, shape: InputShape, mesh,
               moe_impl: str = "dense_scan") -> Dict:
    """:func:`count_sharded` of the step of ``shape`` on
    :func:`launch.specs.input_specs`' meta arguments, with the arguments'
    bytes per device by group and the parameter count."""
    args, shardings = input_specs(cfg, shape, mesh)
    groups = flat_args(args, shardings, shape.mode)
    arg_bytes = {g: sum(t.numel() * t.element_size()
                        // sh.shard_factor(mesh, s)
                        for t, s in leaves.values())
                 for g, leaves in groups.items()}
    step = build_step_fn(long_context_cfg(cfg, shape), shape, moe_impl)
    t0 = time.perf_counter()
    c = count_sharded(step, args, shardings, mesh)
    c.update(argument_bytes=arg_bytes, count_s=time.perf_counter() - t0,
             n_params=sum(t.numel() for t, _ in groups["params"].values()))
    return c


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               moe_impl: str = "dense_scan", variant: Optional[str] = None,
               out: Optional[str] = None) -> Dict:
    """One combination's record (written to ``out``/<tag>.json when
    ``out`` is given).  Training runs with ``remat``, the reference's
    deployment baseline; ``variant`` (a :data:`VARIANTS` name) overrides
    the config and the MoE dispatch, as the reference's."""
    shape = get_shape(shape_name)
    cfg = long_context_cfg(get_config(arch), shape)
    if shape.mode == "train":
        cfg = cfg.replace(remat=True)
    if variant is not None:
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}: one of "
                             f"{sorted(VARIANTS)}")
        over, moe_impl = VARIANTS[variant]
        cfg = cfg.replace(**over)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n = mesh.size
    c = count_step(cfg, shape, mesh, moe_impl)
    args_dev = sum(c["argument_bytes"].values())
    act_dev = c["activation_peak"]
    coll = c["collectives"]
    rec = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": mesh.name, "n_chips": n, "mode": shape.mode,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "sliding_window": cfg.sliding_window, "moe_impl": moe_impl,
        "remat": cfg.remat, "seq_shard_attn": cfg.seq_shard_attn,
        "n_params": c["n_params"], "count_s": round(c["count_s"], 2),
        "flops_total": c["flops"] * n, "flops_per_device": c["flops"],
        "bytes_total": c["bytes"] * n, "bytes_per_device": c["bytes"],
        "collective_bytes_per_device": coll,
        "collective_total": float(sum(coll.values())),
        "off_meta_bytes": c["off_meta_bytes"],
        "grouped": grouped_term(cfg, mesh, moe_impl, c["grouped_flops"]),
        "memory": {
            "argument_bytes": args_dev,
            "argument_bytes_by_group": c["argument_bytes"],
            "activation_peak_bytes": act_dev,
            "peak_estimate_bytes": args_dev + act_dev,
        },
    }
    if out is not None:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, _tag(arch, shape_name, mesh.name,
                                         variant, moe_impl) + ".json"),
                  "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def grouped_term(cfg: ModelConfig, mesh, moe_impl: str,
                 flops: float) -> Optional[Dict]:
    """The record's ``grouped`` (None where no grouped product runs):
    ``rows``, which rows the grouped products' FLOPs counted; ``exact``,
    False where the count is an upper bound (the experts split over
    ``model``: on the card a device multiplies only the rows routed to
    its own experts); ``flops_per_device``, the grouped products' FLOPs
    (``aten._grouped_mm``'s, forward and backward), part of the record's
    ``flops_per_device``."""
    if not cfg.n_experts or moe_impl not in ("ragged", "ragged_local"):
        return None
    tokens = ("every token of the batch" if moe_impl == "ragged"
              else "each of the device's tokens")
    m = model_axis_size(mesh)
    split = m > 1 and cfg.n_experts % m == 0
    rows = (f"top-k rows for {tokens}, against the device's "
            f"{cfg.n_experts // m} experts" if split
            else f"top-k rows for {tokens}, each against its expert")
    return {"rows": rows, "exact": not split, "flops_per_device": flops}


def _tag(arch: str, shape: str, mesh: str, variant: Optional[str],
         moe_impl: str = "dense_scan") -> str:
    tag = f"{arch}_{shape}_{mesh}"
    suffix = variant or (None if moe_impl == "dense_scan" else moe_impl)
    return tag if suffix is None else f"{tag}_{suffix}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS))
    args = ap.parse_args(argv)
    if args.all:
        combos = [(a, s.name) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    failures = []
    for arch, shape in combos:
        mesh = "2x16x16" if args.multi_pod else "16x16"
        tag = _tag(arch, shape, mesh, args.variant)
        try:
            rec = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                             variant=args.variant, out=args.out)
            print(f"OK   {tag}: counted in {rec['count_s']}s flops/dev "
                  f"{rec['flops_per_device']:.3e} bytes/dev "
                  f"{rec['bytes_per_device']:.3e} coll "
                  f"{rec['collective_total']:.3e}B peak "
                  f"{rec['memory']['peak_estimate_bytes'] / 2**30:.2f}GiB",
                  flush=True)
        except Exception as e:  # noqa: BLE001
            failures.append(tag)
            print(f"FAIL {tag}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         + ", ".join(failures))
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
