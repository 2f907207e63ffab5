"""Checkpointing in the JAX package's layout (``train/checkpoint.py``):
``params.npz`` keyed by the ``/``-joined parameter paths, and ``meta.json``
holding ``{"config": dataclasses.asdict(cfg), "extra": {...}}``.

The two packages read each other's directories: the port's flat keys are the
JAX pytree's paths, and every field of the port's ``ModelConfig`` is a field
of JAX's, so JAX's ``load_config`` builds its config from the port's
``meta.json``; the port's :func:`load_config` keeps every field it has:
those that shape a model (``rope_theta``: a Qwen2.5 checkpoint keeps its
10^6; the MoE fields ``n_experts``, ``top_k``, ``n_shared_experts``,
``moe_d_ff`` and ``router_aux_coef``; the encoder and frontend fields
``n_encoder_layers``, ``enc_len_ratio``, ``dec_enc_len``, ``frontend`` and
``n_frontend_tokens``, without which an MoE, VLM or encoder-decoder
checkpoint would load with the wrong shapes or inputs) among them.  It
drops only the fields the port does not read (``param_dtype``,
``use_pallas``, ``remat``, ``unroll_layers``, ``attn_direct``,
``seq_shard_attn``, ``no_event_token``: JAX's compile, sharding and
precision knobs and a padding id no port code uses).
"""
from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import STACKS


def save(path: str, params: Mapping[str, torch.Tensor],
         cfg: ModelConfig | None = None,
         extra: Dict[str, Any] | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    _write_npz(os.path.join(path, "params.npz"), params)
    meta: Dict[str, Any] = {"extra": extra or {}}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def _write_npz(file: str, params: Mapping[str, torch.Tensor]) -> None:
    """The file ``np.savez(file, **models.to_flat_numpy(params))`` writes
    (members ``<key>.npy`` in the tensors' dtypes, stored uncompressed,
    ZIP64), written one leaf at a time from wherever the tensors live: a
    leaf under ``STACKS`` one layer slice at a time (from the card through
    one pinned host buffer), so the host holds one slice or unstacked
    leaf, never the tree.  A dtype numpy lacks (bf16) raises, as
    ``to_flat_numpy`` does."""
    fmt = np.lib.format
    with zipfile.ZipFile(file, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in params.items():
            leaf = leaf.detach()
            stacked = key.startswith(STACKS) and leaf.dim() > 0
            with zf.open(key + ".npy", mode="w", force_zip64=True) as fid:
                dtype = leaf.new_empty(0).cpu().numpy().dtype
                fmt.write_array_header_1_0(fid, {
                    "descr": fmt.dtype_to_descr(dtype),
                    "fortran_order": False, "shape": tuple(leaf.shape)})
                pieces = leaf if stacked else (leaf,)
                stage = (torch.empty(pieces[0].shape, dtype=leaf.dtype,
                                     pin_memory=True)
                         if leaf.is_cuda and leaf.numel() else None)
                for piece in pieces:
                    if stage is None:
                        arr = np.ascontiguousarray(piece.cpu().numpy())
                    else:
                        arr = stage.copy_(piece).numpy()
                    fid.write(arr.reshape(-1).view(np.uint8))


def restore(path: str, params_template: Mapping[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """Restore into the keys, shapes, dtypes and devices of
    ``params_template`` (e.g. ``init_params`` of the same config)."""
    out = {}
    with np.load(os.path.join(path, "params.npz")) as data:
        for key, leaf in params_template.items():
            if key not in data.files:
                raise ValueError(f"{path}: no parameter {key!r}")
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape}, expected "
                                 f"{tuple(leaf.shape)}")
            out[key] = torch.tensor(arr, dtype=leaf.dtype,
                                    device=leaf.device)
    return out


def load_config(path: str) -> Tuple[ModelConfig, Dict[str, Any]]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in meta["config"].items()
                         if k in known})
    return cfg, meta.get("extra", {})
