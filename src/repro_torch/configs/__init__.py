"""Architecture config registry of the port.

``get_config(arch_id)`` returns the full :class:`ModelConfig`;
``get_config(arch_id, reduced=True)`` its small test variant.  The port
registers the architectures its model code serves.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import DENSE, SSM, ModelConfig  # noqa: F401

_REGISTRY: Dict[str, str] = {
    "delphi-2m": "delphi_2m",
    "mamba2-780m": "mamba2_780m",
}

ALL_ARCHS = list(_REGISTRY)


def get_config(arch_id: str, *, reduced: bool = False) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg
