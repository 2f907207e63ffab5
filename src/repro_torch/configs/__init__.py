"""Architecture config registry of the port.

``get_config(arch_id)`` returns the full :class:`ModelConfig`;
``get_config(arch_id, reduced=True)`` its small test variant.  The port
registers the JAX package's 12 architectures: Delphi (2M and 100M), the
generic dense LMs (TinyLlama, H2O-Danube, Qwen2.5, DeepSeek), the mixtures
of experts (OLMoE-1B-7B, Qwen2-MoE-A2.7B), Mamba2, the Mamba2/attention
hybrid Zamba2, the vision-language InternVL2-26B (patch embeddings before
the text) and the encoder-decoder SeamlessM4T-large-v2 (frame embeddings
into the encoder).  ``qwen2.5-32b`` runs reduced only: its fp32 masters
(~131 GB) do not fit one 80 GB card.  The MoE models and InternVL2-26B
(79 GB of fp32 weights) run on the card from weights made there in the
activation dtype (``models.params.init_params_on_device``).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (AUDIO, DENSE, ENC_DEC,  # noqa: F401
                                      HYBRID, MOE, SSM, VLM, ModelConfig)

_REGISTRY: Dict[str, str] = {
    "delphi-2m": "delphi_2m",
    "delphi-100m": "delphi_100m",
    "qwen2.5-32b": "qwen2_5_32b",
    "mamba2-780m": "mamba2_780m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "deepseek-7b": "deepseek_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "internvl2-26b": "internvl2_26b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ALL_ARCHS = list(_REGISTRY)


def get_config(arch_id: str, *, reduced: bool = False) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg
