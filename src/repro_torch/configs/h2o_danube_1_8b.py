"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    arch_type=DENSE,
    citation="arXiv:2401.16818",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
    max_seq_len=32_768,
)
