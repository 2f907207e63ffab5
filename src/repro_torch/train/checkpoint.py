"""Checkpointing in the JAX package's layout (``train/checkpoint.py``):
``params.npz`` keyed by the ``/``-joined parameter paths, and ``meta.json``
holding ``{"config": dataclasses.asdict(cfg), "extra": {...}}``.

The two packages read each other's directories: the port's flat keys are the
JAX pytree's paths, and every field of the port's ``ModelConfig`` is a field
of JAX's, so JAX's ``load_config`` builds its config from the port's
``meta.json``; the port's :func:`load_config` keeps the fields it has and
drops the JAX-only ones (MoE, encoder, frontend and compile knobs, which
the configurations the port serves leave at their defaults).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import to_flat_numpy


def save(path: str, params: Mapping[str, torch.Tensor],
         cfg: ModelConfig | None = None,
         extra: Dict[str, Any] | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **to_flat_numpy(params))
    meta: Dict[str, Any] = {"extra": extra or {}}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


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
