"""Architecture config registry of the port.

``get_config(arch_id)`` returns the full :class:`ModelConfig`;
``get_config(arch_id, reduced=True)`` its small test variant.  The port
registers the architectures its model code serves: Delphi (2M and 100M),
the generic dense LMs (TinyLlama, H2O-Danube, Qwen2.5, DeepSeek), Mamba2
and the Mamba2/attention hybrid Zamba2.  ``qwen2.5-32b`` runs reduced
only: its fp32 masters (~131 GB) do not fit one 80 GB card.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (DENSE, HYBRID, SSM,  # noqa: F401
                                      ModelConfig)

_REGISTRY: Dict[str, str] = {
    "delphi-2m": "delphi_2m",
    "delphi-100m": "delphi_100m",
    "qwen2.5-32b": "qwen2_5_32b",
    "mamba2-780m": "mamba2_780m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "deepseek-7b": "deepseek_7b",
    "zamba2-1.2b": "zamba2_1_2b",
}

ALL_ARCHS = list(_REGISTRY)


def get_config(arch_id: str, *, reduced: bool = False) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg
