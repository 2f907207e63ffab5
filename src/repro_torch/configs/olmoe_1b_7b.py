"""OLMoE-1B-7B — 64 routed experts, top-8, no shared experts. [arXiv:2409.02060]"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type=MOE,
    citation="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    moe_d_ff=1024,
    n_experts=64,
    top_k=8,
    n_shared_experts=0,
    vocab_size=50304,
    rope_theta=10_000.0,
    max_seq_len=32_768,
)
