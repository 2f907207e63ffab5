"""Zamba2-1.2B: a Mamba2 backbone with one weight-shared attention block
applied periodically.  [arXiv:2411.15242]

38 Mamba2 layers; one shared transformer block (attention + SwiGLU MLP,
d_ff 8192) applied before every 6th Mamba layer (7 applications).  The
original interleaves two shared blocks with LoRA-specialised projections;
the JAX package shares a single block, and so does this copy.
"""
from repro_torch.configs.base import HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type=HYBRID,
    citation="arXiv:2411.15242",
    n_layers=38,          # Mamba2 layers
    d_model=2048,
    n_heads=32,           # shared attention block (MHA: kv = heads)
    n_kv_heads=32,
    d_ff=8192,            # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    attn_every=6,
    sliding_window=4096,  # the shared block's window at long context
    max_seq_len=1_048_576,
)
