"""Qwen2-MoE-A2.7B — 60 routed experts top-4 plus 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type=MOE,
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,            # per-expert hidden size (spec)
    moe_d_ff=1408,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,   # 4 shared experts, each moe_d_ff wide (5632 combined)
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)
