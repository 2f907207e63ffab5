"""Delphi-2M — the paper's model (nanoGPT-style GPT over ICD-10 event tokens).

~2M parameters, continuous age encoding in place of positional encodings,
dual event/time head, "Death" termination token and max-age 85 defaults.
[Shmatko et al., Nature 2025; gerstung-lab/Delphi; Duarte et al. 2026]
"""
from repro_torch.configs.base import DENSE, ModelConfig

# Vocabulary: 1,276 ICD-10-level disease tokens + sex/lifestyle + specials
# (pad=0, Death=1, no-event=2): 1,289 tokens (``repro_torch.data.vocab``).
CONFIG = ModelConfig(
    name="delphi-2m",
    arch_type=DENSE,
    citation="arXiv/Nature 2025 Delphi-2M; Duarte et al. 2026 (paper reproduced here)",
    n_layers=12,
    d_model=120,
    n_heads=12,
    n_kv_heads=12,
    d_ff=480,
    vocab_size=1289,
    norm="layernorm",
    activation="gelu",
    max_seq_len=256,
    tie_embeddings=True,
    dual_head=True,
    age_encoding=True,
    death_token=1,
    max_age=85.0,
)
