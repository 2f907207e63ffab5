"""Mamba2-780M: attention-free SSD (state-space duality).  [arXiv:2405.21060]

d_inner = 2 * 1536 = 3072, head_dim 64 -> 48 SSD heads, state N = 128,
RMSNorm, untied head.
"""
from repro_torch.configs.base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type=SSM,
    citation="arXiv:2405.21060",
    n_layers=48,
    d_model=1536,
    n_heads=0,            # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    max_seq_len=1_048_576,  # constant-state decode: unbounded context
)
