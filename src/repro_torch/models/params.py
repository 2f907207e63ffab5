"""The weight bridge: the JAX package's flat checkpoint layout <-> tensors.

Parameters are a flat ``dict`` of fp32 tensors keyed by the ``/``-joined
pytree paths that the JAX package's ``train/checkpoint.py`` writes to
``params.npz`` (layer-stacked leaves carry a leading layer axis).  The
dense family (H query heads, Hkv key/value heads of width hd):

    embed/embed (V, d)
    embed/lm_head (d, V)          untied head (tie_embeddings=False)
    embed/out_bias (V,)           Delphi's dual head
    final_norm/scale (d,)         final_norm/bias (d,)  (LayerNorm only)
    layers/{attn_norm,mlp_norm}/scale (L, d)
    layers/{attn_norm,mlp_norm}/bias (L, d)             (LayerNorm only)
    layers/attn/wq (L, d, H, hd)  layers/attn/{wk,wv} (L, d, Hkv, hd)
    layers/attn/wo (L, H, hd, d)
    layers/attn/bq (L, H, hd)     layers/attn/{bk,bv} (L, Hkv, hd)  (qkv_bias)
    GELU:    layers/mlp/w_fc (L, d, ff)    layers/mlp/b_fc (L, ff)
             layers/mlp/w_proj (L, ff, d)  layers/mlp/b_proj (L, d)
    SwiGLU:  layers/mlp/{w_gate,w_up} (L, d, ff)   layers/mlp/w_down (L, ff, d)

Delphi is LayerNorm, GELU, tied, with the dual head; the llama-family
LMs (TinyLlama, H2O-Danube, Qwen2.5, DeepSeek) are RMSNorm, SwiGLU,
untied, with GQA and, for Qwen2.5, QKV biases.

Mamba2 (SSM, RMSNorm, untied head; di = d_inner, ch = di + 2N):

    embed/embed (V, d)            embed/lm_head (d, V)
    final_norm/scale (d,)         layers/norm/scale (L, d)
    layers/ssm/in_proj (L, d, 2di + 2N + H)
    layers/ssm/conv_w (L, conv, ch)            layers/ssm/conv_b (L, ch)
    layers/ssm/{A_log,dt_bias,D} (L, H)        layers/ssm/norm_scale (L, di)
    layers/ssm/out_proj (L, di, d)

The same weights therefore load into both packages, which is what the
parity tests and the serving CLI's ``--ckpt`` rest on.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SSM, ModelConfig

Params = Dict[str, torch.Tensor]


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape of every parameter: the dense family (pre-norm
    transformer blocks whose norm, MLP, QKV biases and head follow the
    config's knobs) or, for ``arch_type="ssm"``, a stack of Mamba2 blocks
    with an untied head."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    norm_keys = ("scale",) if cfg.norm == "rmsnorm" else ("scale", "bias")
    shapes = {"embed/embed": (V, d)}
    if not cfg.tie_embeddings:
        shapes["embed/lm_head"] = (d, V)
    if cfg.dual_head:
        shapes["embed/out_bias"] = (V,)
    for k in norm_keys:
        shapes[f"final_norm/{k}"] = (d,)
    if cfg.arch_type == SSM:
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
        ch = di + 2 * N
        for k in norm_keys:
            shapes[f"layers/norm/{k}"] = (L, d)
        shapes.update({
            "layers/ssm/in_proj": (L, d, 2 * di + 2 * N + H),
            "layers/ssm/conv_w": (L, cfg.ssm_conv, ch),
            "layers/ssm/conv_b": (L, ch),
            "layers/ssm/A_log": (L, H),
            "layers/ssm/dt_bias": (L, H),
            "layers/ssm/D": (L, H),
            "layers/ssm/norm_scale": (L, di),
            "layers/ssm/out_proj": (L, di, d),
        })
        return shapes
    H, Hkv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    for norm in ("attn_norm", "mlp_norm"):
        for k in norm_keys:
            shapes[f"layers/{norm}/{k}"] = (L, d)
    shapes.update({
        "layers/attn/wq": (L, d, H, hd),
        "layers/attn/wk": (L, d, Hkv, hd),
        "layers/attn/wv": (L, d, Hkv, hd),
        "layers/attn/wo": (L, H, hd, d),
    })
    if cfg.qkv_bias:
        shapes.update({"layers/attn/bq": (L, H, hd),
                       "layers/attn/bk": (L, Hkv, hd),
                       "layers/attn/bv": (L, Hkv, hd)})
    if cfg.activation == "swiglu":
        shapes.update({"layers/mlp/w_gate": (L, d, ff),
                       "layers/mlp/w_up": (L, d, ff),
                       "layers/mlp/w_down": (L, ff, d)})
    else:
        shapes.update({"layers/mlp/w_fc": (L, d, ff),
                       "layers/mlp/b_fc": (L, ff),
                       "layers/mlp/w_proj": (L, ff, d),
                       "layers/mlp/b_proj": (L, d)})
    return shapes


def from_jax_flat(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                  device="cuda") -> Params:
    """Tensors on ``device`` from the JAX package's flat ``/``-keyed arrays.
    Raises on a missing or unexpected key or a wrong shape."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint keys do not match {cfg.name}: "
                         f"missing {missing}, unexpected {extra}")
    out: Params = {}
    for key, shape in want.items():
        arr = np.asarray(flat[key])
        if arr.shape != shape:
            raise ValueError(f"{key}: shape {arr.shape}, expected {shape}")
        out[key] = torch.tensor(arr, dtype=torch.float32, device=dev)
    return out


def to_flat_numpy(params: Params) -> Dict[str, np.ndarray]:
    """The inverse of :func:`from_jax_flat` (host numpy arrays)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def load_checkpoint(path: str, cfg: ModelConfig, device="cuda") -> Params:
    """Load ``path/params.npz`` as written by the JAX package's
    ``train.checkpoint.save``."""
    with np.load(os.path.join(path, "params.npz")) as data:
        flat = {k: data[k] for k in data.files}
    return from_jax_flat(flat, cfg, device)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the JAX ``init_params`` keys, shapes and scales,
    drawn from ``numpy.random.default_rng(seed)`` (not JAX's stream: the
    values differ from the reference's, their distribution does not)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, H, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    di, Hs = cfg.d_inner, cfg.ssm_n_heads

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    flat: Dict[str, np.ndarray] = {}
    for key, shape in param_shapes(cfg).items():
        if key == "embed/embed":
            flat[key] = normal(shape, 0.02)
        elif key == "embed/out_bias":
            # logits are log-hazards (1/years): start rates low so the total
            # rate sum e^logit is O(0.1/yr), not O(vocab)
            flat[key] = np.full(shape, -8.0, np.float32)
        elif key in ("embed/lm_head", "layers/ssm/in_proj"):
            flat[key] = normal(shape, d ** -0.5)
        elif key == "layers/ssm/conv_w":
            flat[key] = normal(shape, cfg.ssm_conv ** -0.5)
        elif key == "layers/ssm/out_proj":
            flat[key] = normal(shape, di ** -0.5)
        elif key == "layers/ssm/A_log":
            a_log = np.log(np.linspace(1.0, 16.0, Hs, dtype=np.float32))
            flat[key] = np.broadcast_to(a_log, shape).astype(np.float32)
        elif key == "layers/ssm/dt_bias":     # softplus^-1(0.01)
            flat[key] = np.full(shape, np.log(np.expm1(np.float32(0.01))),
                                np.float32)
        elif key in ("layers/ssm/D", "layers/ssm/norm_scale") \
                or key.endswith("/scale"):
            flat[key] = np.ones(shape, np.float32)
        elif key == "layers/ssm/conv_b":
            flat[key] = np.zeros(shape, np.float32)
        elif key.endswith("/bias") or key.startswith("layers/mlp/b_") \
                or key in ("layers/attn/bq", "layers/attn/bk",
                           "layers/attn/bv"):
            flat[key] = np.zeros(shape, np.float32)
        elif key in ("layers/attn/wq", "layers/attn/wk", "layers/attn/wv"):
            flat[key] = normal(shape, d ** -0.5)
        elif key == "layers/attn/wo":
            flat[key] = normal(shape, (H * hd) ** -0.5)
        elif key in ("layers/mlp/w_fc", "layers/mlp/w_gate",
                     "layers/mlp/w_up"):
            flat[key] = normal(shape, d ** -0.5)
        elif key in ("layers/mlp/w_proj", "layers/mlp/w_down"):
            flat[key] = normal(shape, ff ** -0.5)
        else:
            raise AssertionError(f"no initializer for {key}")
    return from_jax_flat(flat, cfg, dev)
