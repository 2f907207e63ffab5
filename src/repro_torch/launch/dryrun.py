"""Dry run of every (architecture x input shape x mesh) step on the meta
device: FLOPs, bytes and memory per device, without a byte allocated
(the JAX package's ``launch/dryrun.py``).

Usage (one combination, or the sweep over the zoo's 10 architectures and
the four shapes):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        tinyllama-1.1b --shape train_4k [--multi-pod] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference lowers and compiles each step for 512 fake XLA devices and
reads XLA's cost analysis.  The port runs the step itself, eagerly, on
meta tensors (``launch.specs``): ``train`` is the loss, its backward and
the AdamW update (with ``remat``, the deployment baseline of the
reference's dry run), ``prefill`` is ``forward(mode="prefill")`` and
``decode`` is ``decode_step``.  Every aten operation of that run is
counted as it is dispatched:

* FLOPs by ``torch.utils.flop_counter.FlopCounterMode``.  Attention goes
  through the kernels' plain versions (``kernels/ops.py`` takes them on
  the meta device), so the count is the same work whatever implements it.
  An eager stack runs every layer, so each is counted: the reference's
  one-and-two-layer extrapolation (``_lin``/``_diff``) and its
  ``unroll_layers``/``attn_direct`` lowering modes have no role here and
  are not ported.
* Bytes: each operation's tensor inputs read and outputs written once at
  their logical size (views and metadata operations move nothing): the
  unfused eager step's traffic, the counterpart of XLA's "bytes
  accessed".
* Memory: the arguments' bytes per device under their shardings
  (parameters, optimizer state, cache, batch) and the largest sum of live
  activations the step reaches.

The counts are of the whole (global) step; a device's share is the count
over the mesh's devices, as for a balanced partition.  The eager count
models no collective: ``collective_total`` is 0 and the record says so.
``moe_impl`` picks the MoE dispatch; ``ragged`` (and ``ragged_local``)
cannot run here: their group sizes come from the routed data, and meta
tensors hold none, so the dry run refuses them by name.

Each combination writes one JSON record with the reference's keys where a
number has a counterpart (``arch``, ``shape``, ``mesh``, ``mode``,
``seq_len``, ``global_batch``, ``n_chips``, ``flops_per_device``,
``bytes_per_device``, ``memory.peak_estimate_bytes``, ...), which
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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 get_shape)
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import flat_args, input_specs, long_context_cfg
from repro_torch.models import decode_step, forward
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import make_train_step

# dispatch routes whose group sizes come from the data
DATA_DEPENDENT_IMPLS = ("ragged", "ragged_local")


class TrafficMode(TorchDispatchMode):
    """Counts, over every aten operation dispatched under it, the bytes of
    its tensor inputs and outputs (view operations excluded), the peak of
    the live bytes of the tensors the operations made, and the bytes of
    any tensor made off the meta device."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.off_meta_bytes = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False):
            return out
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        for t in ins + outs:
            self.bytes += t.numel() * t.element_size()
        for o in outs:
            n = o.numel() * o.element_size()
            if o.device.type != "meta":
                self.off_meta_bytes += n
            self.live += n
            weakref.finalize(o, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


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


def count_step(cfg: ModelConfig, shape: InputShape, mesh,
               moe_impl: str = "dense_scan") -> Dict:
    """Run the step once on meta tensors under the counters: FLOPs, bytes,
    the live-activation peak (all of the global step), the arguments'
    bytes per device by group, and the bytes made off the meta device."""
    if moe_impl in DATA_DEPENDENT_IMPLS:
        raise ValueError(
            f"moe_impl {moe_impl!r} cannot be dry-run: its grouped products "
            f"take their group sizes from the routed tokens, and meta "
            f"tensors hold no data; dry-run 'dense_scan' or 'dense_einsum'")
    args, shardings = input_specs(cfg, shape, mesh)
    groups = flat_args(args, shardings, shape.mode)
    arg_bytes = {g: sum(t.numel() * t.element_size()
                        // sh.shard_factor(mesh, s)
                        for t, s in leaves.values())
                 for g, leaves in groups.items()}
    step = build_step_fn(long_context_cfg(cfg, shape), shape, moe_impl)
    flops = FlopCounterMode(display=False)
    traffic = TrafficMode()
    t0 = time.perf_counter()
    with flops, traffic:
        out = step(*args)
        del out
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(traffic.bytes),
            "activation_peak": float(traffic.peak),
            "off_meta_bytes": traffic.off_meta_bytes,
            "argument_bytes": arg_bytes, "count_s": time.perf_counter() - t0,
            "n_params": sum(t.numel() for t, _ in groups["params"].values())}


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               moe_impl: str = "dense_scan",
               out: Optional[str] = None) -> Dict:
    """One combination's record (written to ``out``/<tag>.json when
    ``out`` is given).  Training runs with ``remat``, the reference's
    deployment baseline."""
    shape = get_shape(shape_name)
    cfg = long_context_cfg(get_config(arch), shape)
    if shape.mode == "train":
        cfg = cfg.replace(remat=True)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n = mesh.size
    c = count_step(cfg, shape, mesh, moe_impl)
    args_dev = sum(c["argument_bytes"].values())
    act_dev = c["activation_peak"] / n
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh.name,
        "n_chips": n, "mode": shape.mode, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "sliding_window": cfg.sliding_window, "moe_impl": moe_impl,
        "remat": cfg.remat, "n_params": c["n_params"],
        "count_s": round(c["count_s"], 2),
        "flops_total": c["flops"], "flops_per_device": c["flops"] / n,
        "bytes_total": c["bytes"], "bytes_per_device": c["bytes"] / n,
        "collective_bytes_per_device": {}, "collective_total": 0.0,
        "collective_note": "the eager meta-device count models no "
                           "collective; 0 here, not a measurement",
        "off_meta_bytes": c["off_meta_bytes"],
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
                                         moe_impl) + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def _tag(arch: str, shape: str, mesh: str, moe_impl: str) -> str:
    tag = f"{arch}_{shape}_{mesh}"
    return tag if moe_impl == "dense_scan" else f"{tag}_{moe_impl}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
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
        tag = _tag(arch, shape, mesh, "dense_scan")
        try:
            rec = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                             out=args.out)
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
