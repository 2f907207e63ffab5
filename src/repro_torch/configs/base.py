"""Model configuration dataclass (the port's own copy).

The JAX package's configuration, cut to the fields the port reads: the
dense transformer core (RoPE, GQA, SwiGLU or GELU, RMSNorm or LayerNorm,
sliding windows, QKV biases, tied or untied heads), the mixture of experts
(routed experts, top-k, shared experts, the router's aux-loss weight), the
Mamba2 (SSD) block, the encoder-decoder (encoder depth, encoder memory
length), the modality frontends (audio frames, vision patches) and
Delphi's knobs.  Field names and defaults are the JAX package's, so the
same values describe the same model in both.  The model code
(``repro_torch.models.model``) serves every family: dense (Delphi and the
generic dense LMs), MoE (OLMoE, Qwen2-MoE: the dense block with its MLP
replaced by the experts), SSM (Mamba2), hybrid (Zamba2: Mamba2 layers with
a weight-shared attention block every ``attn_every`` layers), VLM
(InternVL2: the dense decoder over patch embeddings put before the text)
and audio / enc-dec (SeamlessM4T: a bidirectional encoder over frame
embeddings and a decoder with cross-attention to its output).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Architecture families
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENC_DEC = "enc_dec"  # seq2seq (audio backbone)
VLM = "vlm"          # decoder-only with a vision-patch frontend
AUDIO = "audio"      # enc-dec with an audio-frame frontend

# max_seq_len of the recurrent families: constant-state decode bounds no
# context, so a prompt axis padded to it would be a million positions wide;
# a caller that pads to a fixed axis names its own
UNBOUNDED_CONTEXT = 1_048_576


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

    # MoE ------------------------------------------------------------------
    n_experts: int = 0                 # routed experts (0 = dense MLP)
    top_k: int = 0
    n_shared_experts: int = 0          # always-on experts (qwen2-moe style)
    moe_d_ff: int = 0                  # per-expert hidden dim
    router_aux_coef: float = 0.01

    # SSM / Mamba2 (SSD) -----------------------------------------------------
    ssm_state: int = 0                 # N: state size per head
    ssm_expand: int = 2                # d_inner = expand * d_model
    ssm_head_dim: int = 64             # P: SSD head dim
    ssm_conv: int = 4                  # depthwise conv width
    ssm_chunk: int = 128               # SSD chunk length

    # hybrid (zamba2-style): shared attention block applied every k SSM layers
    attn_every: int = 0                # 0 = never (pure SSM)

    # encoder-decoder --------------------------------------------------------
    n_encoder_layers: int = 0          # >0 => enc-dec; decoder gets cross-attn
    enc_len_ratio: int = 8             # encoder frames = seq_len // ratio (audio)
    dec_enc_len: int = 4096            # encoder memory length for decode shapes

    # modality frontend (audio frames / vision patches, given as embeddings)
    frontend: Optional[str] = None     # None | "audio_frames" | "vision_patches"
    n_frontend_tokens: int = 256       # VLM: patch tokens put before the text

    # Delphi -----------------------------------------------------------------
    dual_head: bool = False            # event+time competing-exponential head
    age_encoding: bool = False         # continuous age encoding (replaces pos enc)
    death_token: int = 1
    max_age: float = 85.0

    # numerics / runtime -------------------------------------------------------
    dtype: str = "bfloat16"            # activation dtype on the card
    remat: bool = False                # training: recompute each layer's
    #                                    activations in the backward

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.arch_type not in (DENSE, MOE, SSM, HYBRID, ENC_DEC, VLM, AUDIO):
            raise ValueError(f"unknown arch_type {self.arch_type!r}")
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("GQA requires n_heads % n_kv_heads == 0")
        if self.n_experts and not 0 < self.top_k <= self.n_experts:
            raise ValueError(f"MoE requires 0 < top_k <= n_experts: top_k "
                             f"{self.top_k}, n_experts {self.n_experts}")
        if self.arch_type == MOE and not self.n_experts:
            # the JAX package lets this through and then builds MoE layers
            # of zero experts; the port refuses it where it is made
            raise ValueError("arch_type 'moe' requires n_experts > 0")

    @property
    def has_encoder(self) -> bool:
        return self.n_encoder_layers > 0

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
        models), 4 experts of width 128, top-k <= 2 and at most one shared
        expert (MoE), SSM state 16 / head dim 32 / chunk 32 (SSM models),
        the shared block before every layer (hybrid), 2 encoder layers and
        an encoder memory of 64 (enc-dec), 8 frontend tokens, vocab <= 512
        (the JAX package's ``reduced()``)."""
        kw = dict(n_layers=2, d_model=256, head_dim=64, d_ff=512,
                  vocab_size=min(self.vocab_size, 512), max_seq_len=256)
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, 4 // min(self.q_per_kv, 4))
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2), moe_d_ff=128,
                      n_shared_experts=min(self.n_shared_experts, 1))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.attn_every:
            kw.update(attn_every=1, n_layers=2)
        if self.n_encoder_layers:
            kw.update(n_encoder_layers=2, dec_enc_len=64)
        if self.sliding_window:
            kw["sliding_window"] = 64
        if self.frontend:
            kw["n_frontend_tokens"] = 8
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    """A named (seq_len, global_batch, mode) workload (the JAX package's
    shapes, which its dry run and ``launch.dryrun`` of the port size)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                        LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}


def get_shape(name: str) -> InputShape:
    return SHAPES_BY_NAME[name]
