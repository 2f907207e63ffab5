"""Model configuration dataclass (the port's own copy).

The JAX package's configuration, cut to the fields the port reads: the
dense transformer core (RoPE, GQA, SwiGLU or GELU, RMSNorm or LayerNorm,
sliding windows, QKV biases, tied or untied heads), the Mamba2 (SSD) block
and Delphi's knobs.  Field names and defaults are the JAX package's, so
the same values describe the same model in both.  The model code serves
the dense family (Delphi and the generic dense LMs), the pure SSM family
(Mamba2) and the hybrid family (Zamba2: Mamba2 layers with a weight-shared
attention block every ``attn_every`` layers) and raises
``NotImplementedError`` for the rest (``repro_torch.models.model``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# Architecture families (the port serves DENSE, SSM and HYBRID)
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENC_DEC = "enc_dec"
VLM = "vlm"
AUDIO = "audio"


@dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str
    arch_type: str
    citation: str = ""

    # transformer core -----------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None     # default d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    activation: str = "swiglu"         # swiglu | gelu
    rope_theta: float = 10_000.0
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None

    # SSM / Mamba2 (SSD) -----------------------------------------------------
    ssm_state: int = 0                 # N: state size per head
    ssm_expand: int = 2                # d_inner = expand * d_model
    ssm_head_dim: int = 64             # P: SSD head dim
    ssm_conv: int = 4                  # depthwise conv width
    ssm_chunk: int = 128               # SSD chunk length

    # hybrid (zamba2-style): shared attention block applied every k SSM layers
    attn_every: int = 0                # 0 = never (pure SSM)

    # Delphi -----------------------------------------------------------------
    dual_head: bool = False            # event+time competing-exponential head
    age_encoding: bool = False         # continuous age encoding (replaces pos enc)
    death_token: int = 1
    max_age: float = 85.0

    # numerics -----------------------------------------------------------------
    dtype: str = "bfloat16"            # activation dtype on the card

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.arch_type not in (DENSE, MOE, SSM, HYBRID, ENC_DEC, VLM, AUDIO):
            raise ValueError(f"unknown arch_type {self.arch_type!r}")
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("GQA requires n_heads % n_kv_heads == 0")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        if self.n_heads == 0:
            return 1
        return self.n_heads // max(self.n_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model 256, 4 heads (attention
        models), SSM state 16 / head dim 32 / chunk 32 (SSM models), the
        shared block before every layer (hybrid), vocab <= 512 (the JAX
        package's ``reduced()`` for the families this port covers)."""
        kw = dict(n_layers=2, d_model=256, head_dim=64, d_ff=512,
                  vocab_size=min(self.vocab_size, 512), max_seq_len=256)
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, 4 // min(self.q_per_kv, 4))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.attn_every:
            kw.update(attn_every=1, n_layers=2)
        if self.sliding_window:
            kw["sliding_window"] = 64
        return self.replace(**kw)
