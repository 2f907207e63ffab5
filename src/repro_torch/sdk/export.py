"""Model export: the ONNX-conversion step of the paper, in PyTorch.

``export_model`` serializes inference graphs with ``torch.export`` into a
self-contained artifact directory (the file names and graph signatures of
the JAX package's ``repro/sdk/export.py``):

    model.bin       full-sequence graph  f(params, tokens, ages) -> logits
    prefill.bin     (spec v2) prompt -> (last-token logits, KV cache leaves)
    decode.bin      (spec v2) KV-cached one-token step: the cache tensors are
                    explicit graph inputs AND outputs
    params.npz      parameter arrays under the flat ``/``-keyed paths of the
                    JAX package's checkpoints (``models.params``)
    manifest.json   FAIR metadata (checksums, signature, provenance, sampling)

Each ``.bin`` holds one ``torch.export.save`` archive.  The parameters are
graph inputs (a ``dict``), not constants of the graphs, so ``params.npz``
is the one copy of the weights, readable by the JAX package's ``nest``.
The kernels inside a graph are one node per call of an operator of
``repro_torch.kernels.library``: the attention kernels and ``ssd_intra``,
the hand-written CUDA kernels on the card, their plain versions on the
CPU.  The loading side (``sdk.runtime``) imports no model code.

The cache crosses the graph boundary as a flat list of tensors, in the
order of the JAX package's ``tree_leaves`` over the model's cache dict
(its keys sorted): ``[k, v, pos]`` of the ``LayerCache`` rings for the
attention stacks, ``[h, conv]`` of Mamba2's ``SSMCache``, ``[k, v, pos,
h, conv]`` for the hybrid (``attn`` before ``ssm``).  The decode graph
writes the new token's K/V and position, and the new recurrent state,
into those tensors in place and returns them: the list it returns is the
list it was given, updated.

Graphs are traced on the CPU at the configuration's dtype, so a machine
with no card can export.  Every token-only architecture is exported:
Delphi, whose graphs take ages beside the tokens, the generic dense LMs
(RoPE, GQA, SwiGLU, RMSNorm, windows, QKV biases), the MoE LMs (whose
all-expert dispatch has no data-dependent shape), Mamba2 and the hybrid
Zamba2, whose graphs take tokens only (the decode graph ``(token,
step)``).  The prompt is right-padded to the fixed ``seq_len`` axis, and
the prefill graph masks the padding with ``last_index``: attention rings
by ``mask_padded_positions``, a recurrent state by the masked SSD prefill
(``dt = 0`` past ``last_index`` and the conv tail gathered there,
``models.ssm.ssm_forward``), so the state handed to decode is the state
after the prompt, and the graphs' signatures are the reference's.  A VLM
or an encoder-decoder is refused by name: no signature carries its
patches or frames.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import (decode_step, forward, mask_padded_positions,
                                to_flat_numpy)
from repro_torch.models.attention import LayerCache
from repro_torch.models.layers import act_dtype
from repro_torch.models.model import n_attn_apps
from repro_torch.models.ssm import SSMCache, empty_ssm_cache
from repro_torch.sdk.manifest import (SPEC_V1, SPEC_V2, build_manifest,
                                      write_manifest)

FULL_GRAPH = "model.bin"
PREFILL_GRAPH = "prefill.bin"
DECODE_GRAPH = "decode.bin"


def nest(flat: Dict[str, Any]) -> Dict:
    """Rebuild the nested dict of the JAX package's pytree from flattened
    'a/b/c' keys."""
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def _cache_kinds(cfg: ModelConfig):
    """The model's cache dict as (key, leaf type) in the boundary's order:
    the JAX package's ``tree_leaves`` order, its keys sorted."""
    if cfg.arch_type == cb.SSM:
        return (("ssm", SSMCache),)
    if cfg.arch_type == cb.HYBRID:
        return (("attn", LayerCache), ("ssm", SSMCache))
    return (("self", LayerCache),)


def _leaves(cfg: ModelConfig, cache) -> List[torch.Tensor]:
    """The model's cache dict as the flat tensor list of the boundary."""
    return [t for key, _ in _cache_kinds(cfg) for t in cache[key]]


def _unflatten(cfg: ModelConfig, leaves) -> Dict[str, Any]:
    """The boundary's flat tensor list as the model's cache dict."""
    cache, i = {}, 0
    for key, kind in _cache_kinds(cfg):
        n = len(kind._fields)
        cache[key] = kind(*leaves[i:i + n])
        i += n
    return cache


def _example_cache(cfg: ModelConfig, S: int, device) -> Dict[str, Any]:
    """An empty cache of the prefill graph's shapes: rings S wide, whatever
    the window (a right-padded prompt longer than the window would evict
    its own context from a narrower ring), and the recurrent state."""
    dt = act_dtype(cfg)
    cache = {}
    for key, _ in _cache_kinds(cfg):
        if key == "ssm":
            cache[key] = empty_ssm_cache(cfg, cfg.n_layers, 1, dt, device)
        else:
            n = n_attn_apps(cfg) if key == "attn" else cfg.n_layers
            cache[key] = attn.empty_cache(n, 1, cfg.n_kv_heads, S,
                                          cfg.head_dim, dt, device)
    return cache


def build_inference_fns(cfg: ModelConfig, seq_len: int) -> Dict[str, Any]:
    """The three inference callables an artifact serializes.

    Shared between ``export_model`` and ``repro_torch.api.LocalBackend``
    (which calls them eagerly), so the artifact's decode path and the local
    decode path are one function by construction.

    Returns dict with:
      ``full(p, tokens[, ages]) -> logits (1, S, V)``
      ``prefill(p, tokens[, ages], last_index) -> (logits (1, V), [cache])``
      ``decode(p, [cache], token[, age], step) -> (logits (1, V), [cache])``
    where ``[cache]`` is the flat leaf list of the module docstring (rings
    of width ``seq_len``), and ``decode`` updates it in place.
    """
    S = seq_len
    delphi = cfg.age_encoding

    def _batch(tokens, ages):
        b = {"tokens": tokens}
        if delphi:
            b["ages"] = ages
        return b

    def _full(p, tokens, ages):
        return forward(p, cfg, _batch(tokens, ages), mode="train")["logits"]

    def _prefill(p, tokens, ages, last_index):
        # a recurrent state is masked at last_index inside the prefill
        out = forward(p, cfg, _batch(tokens, ages), mode="prefill",
                      cache_width=S, last_index=last_index)
        # right-padded positions hold garbage K/V: invalidate them so that
        # decode never attends past the prompt's true last token
        cache = mask_padded_positions(out["cache"], last_index)
        return out["logits"][:, 0], _leaves(cfg, cache)

    def _decode(p, cache_leaves, token, age, step):
        d = decode_step(p, cfg, _unflatten(cfg, cache_leaves),
                        _batch(token, age), step)
        return d["logits"][:, 0], _leaves(cfg, d["cache"])

    if delphi:
        def full_fn(p, tokens, ages):
            return _full(p, tokens, ages)

        def prefill_fn(p, tokens, ages, last_index):
            return _prefill(p, tokens, ages, last_index)

        def decode_fn(p, cache_leaves, token, age, step):
            return _decode(p, cache_leaves, token, age, step)
    else:
        def full_fn(p, tokens):
            return _full(p, tokens, None)

        def prefill_fn(p, tokens, last_index):
            return _prefill(p, tokens, None, last_index)

        def decode_fn(p, cache_leaves, token, step):
            return _decode(p, cache_leaves, token, None, step)

    return {"full": full_fn, "prefill": prefill_fn, "decode": decode_fn}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _graph_signatures(cfg: ModelConfig, S: int,
                      cache_leaves) -> Dict[str, Any]:
    """The manifest ``graphs`` section: per-graph files + tensor signatures
    (ages only where the model reads them: the Delphi family)."""
    V = cfg.vocab_size
    delphi = cfg.age_encoding
    tok = {"name": "tokens", "shape": [1, S], "dtype": "int32"}
    ages = ([{"name": "ages", "shape": [1, S], "dtype": "float32"}]
            if delphi else [])
    age = ([{"name": "age", "shape": [1, 1], "dtype": "float32"}]
           if delphi else [])
    cache_spec = [{"shape": list(l.shape), "dtype": _dtype_name(l.dtype)}
                  for l in cache_leaves]
    cache_io = {"name": "cache", "leaves": len(cache_leaves)}
    return {
        "full": {
            "file": FULL_GRAPH,
            "inputs": [tok] + ages,
            "outputs": [{"name": "logits", "shape": [1, S, V],
                         "dtype": "float32"}],
        },
        "prefill": {
            "file": PREFILL_GRAPH,
            "inputs": [tok] + ages + [{"name": "last_index", "shape": [1],
                                       "dtype": "int32"}],
            "outputs": [{"name": "logits", "shape": [1, V],
                         "dtype": "float32"}, cache_io],
        },
        "decode_step": {
            "file": DECODE_GRAPH,
            "inputs": [cache_io,
                       {"name": "token", "shape": [1, 1], "dtype": "int32"}]
                      + age
                      + [{"name": "step", "shape": [1], "dtype": "int32"}],
            "outputs": [{"name": "logits", "shape": [1, V],
                         "dtype": "float32"}, cache_io],
        },
        "cache": {"n_leaves": len(cache_leaves), "leaves": cache_spec,
                  "width": S},
    }


class _Graph(torch.nn.Module):
    """A callable as the module ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _check_exportable(cfg: ModelConfig) -> None:
    if cfg.arch_type in (cb.VLM, cb.AUDIO, cb.ENC_DEC):
        raise NotImplementedError(
            f"{cfg.name}: export_model exports the token-only architectures "
            f"only: the artifact's graphs take tokens (and Delphi's ages), "
            f"and arch_type={cfg.arch_type} also needs the "
            f"{'patches' if cfg.arch_type == cb.VLM else 'frames'} of its "
            f"modality frontend, which no graph signature carries")


def export_model(params, cfg: ModelConfig, out_dir: str, *,
                 seq_len: Optional[int] = None,
                 logits_fn: Optional[Callable] = None,
                 spec_version: str = SPEC_V2) -> str:
    """Export inference graph(s) + params + manifest.

    The full graph is ``f(params, tokens[, ages]) -> logits`` with tokens
    (1, seq_len) int32 (ages for the Delphi family only).  Spec v2 (the
    default) also exports the prefill and KV-cached decode_step graphs, so
    that clients generate with O(1) model work per token instead of
    re-running the O(S·V) full graph.

    ``spec_version="1"``/``"1.0"`` exports a v1 (full-graph-only) artifact;
    a custom ``logits_fn(params, tokens, ages)`` implies v1 (there is no way
    to derive prefill / decode graphs from an opaque callable).

    ``params`` is the port's flat parameter dict (any device); the graphs
    are traced on CPU copies in fp32, and compute in ``cfg.dtype``.
    """
    if spec_version in ("1", SPEC_V1):
        spec_version = SPEC_V1
    elif spec_version in ("2", SPEC_V2):
        spec_version = SPEC_V2
    else:
        raise ValueError(f"unknown artifact spec_version {spec_version!r}; "
                         f"supported: {SPEC_V1!r}, {SPEC_V2!r}")
    if logits_fn is not None and spec_version != SPEC_V1:
        raise ValueError(
            "a custom logits_fn exports only the full graph: pass "
            "spec_version='1' (prefill/decode graphs cannot be derived "
            "from an opaque callable)")
    S = seq_len or cfg.max_seq_len
    if S > cfg.max_seq_len:
        raise ValueError(
            f"seq_len={S} exceeds cfg.max_seq_len={cfg.max_seq_len}: the "
            f"exported graph would compute positions the model was never "
            f"configured for — pass seq_len <= {cfg.max_seq_len} or raise "
            f"max_seq_len in the config")
    _check_exportable(cfg)
    os.makedirs(out_dir, exist_ok=True)
    p = {k: v.detach().to("cpu", torch.float32) for k, v in params.items()}

    fns = build_inference_fns(cfg, S)
    delphi = cfg.age_encoding
    tokens = torch.zeros((1, S), dtype=torch.int32)
    ages = torch.zeros((1, S), dtype=torch.float32)
    full_args = (p, tokens, ages) if delphi else (p, tokens)

    def _export_graph(fn, args, fname):
        with torch.no_grad():
            ep = torch.export.export(_Graph(fn), args, strict=False)
        ep._example_inputs = None       # the weights live in params.npz
        with open(os.path.join(out_dir, fname), "wb") as f:
            torch.export.save(ep, f)

    _export_graph(logits_fn if logits_fn is not None else fns["full"],
                  full_args, FULL_GRAPH)
    graphs = None
    if spec_version == SPEC_V2:
        last = torch.zeros((1,), dtype=torch.int32)
        _export_graph(fns["prefill"], full_args + (last,), PREFILL_GRAPH)
        leaves = _leaves(cfg, _example_cache(cfg, S, p["embed/embed"].device))
        token = torch.zeros((1, 1), dtype=torch.int32)
        age = torch.zeros((1, 1), dtype=torch.float32)
        step_args = (token, age, last) if delphi else (token, last)
        _export_graph(fns["decode"], (p, leaves) + step_args, DECODE_GRAPH)
        graphs = _graph_signatures(cfg, S, leaves)
    np.savez(os.path.join(out_dir, "params.npz"), **to_flat_numpy(p))

    signature = {
        "inputs": [{"name": "tokens", "shape": [1, S], "dtype": "int32"}]
                  + ([{"name": "ages", "shape": [1, S], "dtype": "float32"}]
                     if delphi else []),
        "outputs": [{"name": "logits", "shape": [1, S, cfg.vocab_size],
                     "dtype": "float32"}],
        "params": "params.npz (flattened pytree paths)",
    }
    write_manifest(build_manifest(cfg, out_dir, signature=signature,
                                  spec_version=spec_version, graphs=graphs),
                   out_dir)
    return out_dir
