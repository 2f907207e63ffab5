"""Delphi-100M — scaled Delphi variant for the end-to-end training launcher.

Same technique (age encoding + dual head), ~100M backbone parameters; used by
``examples``/``launch/train.py`` when a larger-than-paper model is wanted.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="delphi-100m",
    arch_type=DENSE,
    citation="this work (scaled variant of Delphi-2M)",
    n_layers=16,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=1289,
    norm="layernorm",
    activation="gelu",
    max_seq_len=1024,
    tie_embeddings=True,
    dual_head=True,
    age_encoding=True,
)
