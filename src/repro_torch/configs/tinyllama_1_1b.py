"""TinyLlama-1.1B — llama2-architecture small dense model. [arXiv:2401.02385]"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_type=DENSE,
    citation="arXiv:2401.02385",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10_000.0,
    max_seq_len=32_768,
)
