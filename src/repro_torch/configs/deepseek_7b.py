"""DeepSeek-7B — llama-architecture dense model. [arXiv:2401.02954]"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type=DENSE,
    citation="arXiv:2401.02954",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10_000.0,
    max_seq_len=32_768,
)
