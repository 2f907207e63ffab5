"""InternVL2-26B: the InternLM2-20B language backbone behind a vision-patch
frontend.  [arXiv:2404.16821]

As in the JAX package, the ViT and its projector are not part of the
model: the caller gives ``n_frontend_tokens`` (256) patch embeddings a row,
(batch, 256, d_model), which the decoder takes before the text.
"""
from repro_torch.configs.base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type=VLM,
    citation="arXiv:2404.16821",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    frontend="vision_patches",
    n_frontend_tokens=256,
)
