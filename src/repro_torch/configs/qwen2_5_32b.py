"""Qwen2.5-32B — dense GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type=DENSE,
    citation="hf:Qwen/Qwen2.5-0.5B (family card, 32B variant)",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)
