"""SeamlessM4T-large-v2: the encoder-decoder speech backbone.
[arXiv:2308.11596]

As in the JAX package, the mel-spectrogram and the conv codec are not part
of the model: the caller gives frame embeddings, (batch, M, d_model), to
the 24-layer bidirectional encoder; the 24-layer causal decoder attends to
the encoder's output through cross-attention (``dec_enc_len`` 4,096 is the
memory length of the decode shapes).
"""
from repro_torch.configs.base import AUDIO, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type=AUDIO,
    citation="arXiv:2308.11596",
    n_layers=24,           # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    norm="layernorm",
    activation="gelu",
    max_seq_len=32_768,
    frontend="audio_frames",
    enc_len_ratio=8,
    dec_enc_len=4096,
)
