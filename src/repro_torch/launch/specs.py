"""Meta-device stand-ins and their shardings for every (architecture x
input shape) step (the JAX package's ``launch/specs.py``).

Where the reference builds ``jax.ShapeDtypeStruct``s with
``jax.eval_shape``, the port builds tensors on PyTorch's ``meta`` device:
shapes and dtypes without storage, so a 32-billion-parameter model's
parameters, optimizer state and a 32k-token cache are described without
a byte allocated, and the dry run (``launch.dryrun``) can run the step on
them.  Each comes with its shardings (``launch.sharding``'s specs).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import base as cb
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import sharding as sh
from repro_torch.models import make_decode_cache
from repro_torch.models.params import param_shapes
from repro_torch.train.optimizer import init_opt_state

META = torch.device("meta")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def params_spec(cfg: ModelConfig, *, serving: bool = False
                ) -> Dict[str, torch.Tensor]:
    """The flat parameters as meta tensors: fp32 masters, or bf16 for
    serving (inference ships bf16 checkpoints, as the reference's
    spec)."""
    dt = torch.bfloat16 if serving else torch.float32
    return {k: meta(s, dt) for k, s in param_shapes(cfg).items()}


def model_batch_spec(cfg: ModelConfig, batch: int, seq: int, *,
                     for_train: bool) -> Dict[str, torch.Tensor]:
    """The model-input dict of one step: tokens, Delphi's ages (and to
    train its targets, waiting times and loss mask), a VLM's patch
    embeddings, an encoder-decoder's frame embeddings."""
    act = _DTYPES[cfg.dtype]
    b = {"tokens": meta((batch, seq), torch.int32)}
    if cfg.age_encoding:
        b["ages"] = meta((batch, seq), torch.float32)
        if for_train:
            b["targets"] = meta((batch, seq), torch.int32)
            b["target_dt"] = meta((batch, seq), torch.float32)
            b["loss_mask"] = meta((batch, seq), torch.float32)
    if cfg.frontend == "vision_patches":
        b["patches"] = meta((batch, cfg.n_frontend_tokens, cfg.d_model), act)
    if cfg.frontend == "audio_frames":
        b["frames"] = meta((batch, max(seq // cfg.enc_len_ratio, 1),
                            cfg.d_model), act)
    return b


def long_context_cfg(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The long_500k policy: attention architectures without a window get
    an 8,192-token sliding window; SSM runs natively (the reference's)."""
    if shape.name == "long_500k" and cfg.arch_type != cb.SSM \
            and cfg.sliding_window is None:
        return cfg.replace(sliding_window=8192)
    return cfg


def input_specs(cfg: ModelConfig, shape: InputShape, mesh
                ) -> Tuple[Tuple, Tuple]:
    """-> (args, shardings) of the step of ``shape.mode``, as meta tensors
    and specs:

    train:   (params, opt_state, batch)
    prefill: (params, batch)
    decode:  (params, cache, batch, step)

    The cache is the port's ({"self": LayerCache, ...}); its shardings
    are keyed by its flat leaves (``"self/k"``, ...)."""
    cfg = long_context_cfg(cfg, shape)
    p_spec = params_spec(cfg, serving=shape.mode != "train")
    p_shard = sh.param_shardings(mesh, p_spec)
    if shape.mode == "train":
        o_spec = init_opt_state(p_spec)
        o_shard = sh.opt_state_shardings(mesh, o_spec, p_shard)
        batch = model_batch_spec(cfg, shape.global_batch, shape.seq_len,
                                 for_train=True)
        return ((p_spec, o_spec, batch),
                (p_shard, o_shard, sh.batch_shardings(mesh, batch)))
    if shape.mode == "prefill":
        batch = model_batch_spec(cfg, shape.global_batch, shape.seq_len,
                                 for_train=False)
        return (p_spec, batch), (p_shard, sh.batch_shardings(mesh, batch))
    # decode: one new token against a cache of shape.seq_len context
    cache = make_decode_cache(p_spec, cfg, shape.global_batch,
                              shape.seq_len)
    batch = model_batch_spec(cfg, shape.global_batch, 1, for_train=False)
    batch.pop("frames", None)    # decode reads the cross cache, not frames
    batch.pop("patches", None)   # patch tokens already live in the cache
    step = meta((), torch.int32)
    return ((p_spec, cache, batch, step),
            (p_shard, sh.cache_shardings(mesh, cache),
             sh.batch_shardings(mesh, batch), ()))


def flat_args(args: Tuple, shardings: Tuple, mode: str
              ) -> Dict[str, Dict[str, Tuple[Any, Tuple]]]:
    """{group: {leaf: (tensor, spec)}} of :func:`input_specs`' result, the
    groups ``params``, ``opt_state``, ``cache``, ``batch`` and ``step``."""
    names = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "cache", "batch", "step")}[mode]
    out = {}
    for name, a, s in zip(names, args, shardings):
        if name == "opt_state":
            leaves = {f"{m}/{k}": (v, s[m][k]) for m in ("mu", "nu")
                      for k, v in a[m].items()}
            leaves["step"] = (a["step"], s["step"])
        elif name == "cache":
            leaves = {k: (v, s[k]) for k, v in sh.cache_leaves(a).items()}
        elif name == "step":
            leaves = {"step": (a, s)}
        else:
            leaves = {k: (v, s[k]) for k, v in a.items()}
        out[name] = leaves
    return out
