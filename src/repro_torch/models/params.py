"""The weight bridge: the JAX package's flat checkpoint layout <-> tensors.

Parameters are a flat ``dict`` of tensors keyed by the ``/``-joined
pytree paths that the JAX package's ``train/checkpoint.py`` writes to
``params.npz`` (layer-stacked leaves carry a leading layer axis): fp32
masters (``init_params``, training), or each leaf in the dtype it is used
in (:func:`use_dtype`: ``init_params_on_device``, ``from_jax_flat``,
``load_checkpoint``; all fp32 under an fp32 config).  The
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

MoE (OLMoE, Qwen2-MoE): the dense block with ``layers/moe/*`` in place of
``layers/mlp/*`` (E routed experts of width f = ``moe_d_ff``; the shared
experts, where the config has them, fused into one SwiGLU MLP of width
fs = ``n_shared_experts * f``):

    layers/moe/router (L, d, E)
    layers/moe/{w_gate,w_up} (L, E, d, f)      layers/moe/w_down (L, E, f, d)
    layers/moe/shared/{w_gate,w_up} (L, d, fs) layers/moe/shared/w_down (L, fs, d)

Mamba2 (SSM, RMSNorm, untied head; di = d_inner, ch = di + 2N):

    embed/embed (V, d)            embed/lm_head (d, V)
    final_norm/scale (d,)         layers/norm/scale (L, d)
    layers/ssm/in_proj (L, d, 2di + 2N + H)
    layers/ssm/conv_w (L, conv, ch)            layers/ssm/conv_b (L, ch)
    layers/ssm/{A_log,dt_bias,D} (L, H)        layers/ssm/norm_scale (L, di)
    layers/ssm/out_proj (L, di, d)

Zamba2 (hybrid): Mamba2's ``embed/*``, ``final_norm/*``, ``layers/norm/*``
and ``layers/ssm/*`` stacked over its L Mamba layers, and one transformer
block shared by every application, unstacked (no layer axis):

    shared_attn/{attn_norm,mlp_norm}/scale (d,)
    shared_attn/attn/wq (d, H, hd)  shared_attn/attn/{wk,wv} (d, Hkv, hd)
    shared_attn/attn/wo (H, hd, d)
    shared_attn/mlp/{w_gate,w_up} (d, ff)   shared_attn/mlp/w_down (ff, d)

InternVL2 (VLM) has the dense family's leaves and no more: its patch
embeddings are an input, not a weight.  The encoder-decoder (SeamlessM4T,
``arch_type="audio"``; Le = ``n_encoder_layers``) adds a stack of dense
blocks under ``encoder/``, the encoder's final norm, and in each decoder
block a cross-attention with its own pre-norm:

    encoder/{attn_norm,mlp_norm}/{scale,bias} (Le, d)
    encoder/attn/{wq,wk,wv,wo}, encoder/mlp/* (Le, ...), as layers/*
    enc_norm/scale (d,)           enc_norm/bias (d,)    (LayerNorm only)
    layers/cross_norm/{scale,bias} (L, d)
    layers/cross_attn/wq (L, d, H, hd)  layers/cross_attn/{wk,wv} (L, d, Hkv, hd)
    layers/cross_attn/wo (L, H, hd, d)  (and b{q,k,v} with qkv_bias)

The same weights therefore load into both packages, which is what the
parity tests and the serving CLI's ``--ckpt`` rest on.  ``load_checkpoint``
reads such a file one leaf, and one layer slice, at a time.
"""
from __future__ import annotations

import functools
import os
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (AUDIO, ENC_DEC, HYBRID, MOE, SSM,
                                      ModelConfig)

Params = Dict[str, torch.Tensor]

# weights that enter a matrix product, a bias added in the activation
# dtype, or the activation-dtype conv (cast to the activation dtype); norms,
# out_bias, the MoE router, A_log, dt_bias, D and norm_scale are used in fp32
_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_MLP = ("w_fc", "b_fc", "w_proj", "b_proj", "w_gate", "w_up", "w_down")
MATMUL_KEYS = (("embed/embed", "embed/lm_head")
               + tuple(f"{stack}/attn/{w}" for stack in ("layers", "encoder")
                       for w in _ATTN)
               + tuple(f"layers/cross_attn/{w}" for w in _ATTN)
               + tuple(f"{stack}/mlp/{w}" for stack in ("layers", "encoder")
                       for w in _MLP)
               + ("layers/moe/w_gate", "layers/moe/w_up",
                  "layers/moe/w_down", "layers/moe/shared/w_gate",
                  "layers/moe/shared/w_up", "layers/moe/shared/w_down",
                  "layers/ssm/in_proj", "layers/ssm/conv_w",
                  "layers/ssm/conv_b", "layers/ssm/out_proj"))
# the stacks of blocks: a leaf under these prefixes has a leading layer axis
STACKS = ("layers/", "encoder/")


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape of every parameter: the dense family (pre-norm
    transformer blocks whose norm, MLP, QKV biases and head follow the
    config's knobs), for ``arch_type="moe"`` those blocks with the
    experts in place of the MLP, for ``arch_type="ssm"`` a stack of Mamba2 blocks with
    an untied head, and for ``arch_type="hybrid"`` that stack and one
    shared transformer block (``shared_attn/*``, no layer axis); a VLM
    is the dense family, and an encoder-decoder (``audio``, ``enc_dec``)
    adds the ``encoder/*`` stack, ``enc_norm/*`` and each decoder block's
    cross-attention."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    norm_keys = ("scale",) if cfg.norm == "rmsnorm" else ("scale", "bias")
    shapes = {"embed/embed": (V, d)}
    if not cfg.tie_embeddings:
        shapes["embed/lm_head"] = (d, V)
    if cfg.dual_head:
        shapes["embed/out_bias"] = (V,)
    for k in norm_keys:
        shapes[f"final_norm/{k}"] = (d,)
    if cfg.arch_type in (SSM, HYBRID):
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
        if cfg.arch_type == HYBRID:
            shapes.update(_block_shapes(cfg, "shared_attn/", ()))
        return shapes
    enc_dec = cfg.arch_type in (AUDIO, ENC_DEC)
    if enc_dec:
        shapes.update(_block_shapes(cfg, "encoder/",
                                    (cfg.n_encoder_layers,)))
        for k in norm_keys:
            shapes[f"enc_norm/{k}"] = (d,)
    shapes.update(_block_shapes(cfg, "layers/", (L,), cross=enc_dec))
    return shapes


def _block_shapes(cfg: ModelConfig, prefix: str, lead: Tuple[int, ...],
                  cross: bool = False) -> Dict[str, Tuple[int, ...]]:
    """A pre-norm transformer block's parameters under ``prefix``, each
    with the leading axes ``lead`` (``(L,)`` for a stack, ``()`` for the
    hybrid's shared block); with ``cross`` also a cross-attention and its
    norm (a decoder block of the encoder-decoder)."""
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, ff = cfg.head_dim, cfg.d_ff
    norm_keys = ("scale",) if cfg.norm == "rmsnorm" else ("scale", "bias")
    norms = ("attn_norm", "mlp_norm") + (("cross_norm",) if cross else ())
    shapes = {f"{prefix}{norm}/{k}": lead + (d,)
              for norm in norms for k in norm_keys}
    block = {}
    for a in ("attn",) + (("cross_attn",) if cross else ()):
        block.update({f"{a}/wq": (d, H, hd), f"{a}/wk": (d, Hkv, hd),
                      f"{a}/wv": (d, Hkv, hd), f"{a}/wo": (H, hd, d)})
        if cfg.qkv_bias:
            block.update({f"{a}/bq": (H, hd), f"{a}/bk": (Hkv, hd),
                          f"{a}/bv": (Hkv, hd)})
    if cfg.arch_type == MOE and prefix == "layers/":
        E, f = cfg.n_experts, cfg.moe_d_ff
        block.update({"moe/router": (d, E), "moe/w_gate": (E, d, f),
                      "moe/w_up": (E, d, f), "moe/w_down": (E, f, d)})
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * f
            block.update({"moe/shared/w_gate": (d, fs),
                          "moe/shared/w_up": (d, fs),
                          "moe/shared/w_down": (fs, d)})
    elif cfg.activation == "swiglu":
        block.update({"mlp/w_gate": (d, ff), "mlp/w_up": (d, ff),
                      "mlp/w_down": (ff, d)})
    else:
        block.update({"mlp/w_fc": (d, ff), "mlp/b_fc": (ff,),
                      "mlp/w_proj": (ff, d), "mlp/b_proj": (d,)})
    shapes.update({prefix + k: lead + v for k, v in block.items()})
    return shapes


def use_dtype(cfg: ModelConfig, key: str) -> torch.dtype:
    """The dtype leaf ``key`` is stored and used in: ``MATMUL_KEYS`` leaves
    (the hybrid's shared block as a stacked layer's) in the activation
    dtype ``cfg.dtype``, the rest in fp32.  With ``cfg.dtype`` fp32 every
    leaf is fp32."""
    if key.replace("shared_attn/", "layers/", 1) in MATMUL_KEYS:
        return getattr(torch, cfg.dtype)
    return torch.float32


def _check_keys(cfg: ModelConfig, want, have) -> None:
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint keys do not match {cfg.name}: "
                         f"missing {missing}, unexpected {extra}")


def _check_shape(key: str, got, shape) -> None:
    if tuple(got) != tuple(shape):
        raise ValueError(f"{key}: shape {tuple(got)}, expected {shape}")


def from_jax_flat(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                  device="cuda") -> Params:
    """Tensors on ``device`` from the JAX package's flat ``/``-keyed arrays,
    each in its use dtype (:func:`use_dtype`).  Raises on a missing or
    unexpected key or a wrong shape."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    _check_keys(cfg, want, flat)
    out: Params = {}
    for key, shape in want.items():
        arr = np.asarray(flat[key])
        _check_shape(key, arr.shape, shape)
        out[key] = torch.tensor(arr, dtype=use_dtype(cfg, key), device=dev)
    return out


def to_flat_numpy(params: Params) -> Dict[str, np.ndarray]:
    """The inverse of :func:`from_jax_flat` under an fp32 config (host
    numpy arrays; numpy has no bf16)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def load_checkpoint(path: str, cfg: ModelConfig, device="cuda") -> Params:
    """Load ``path/params.npz`` as written by ``train.checkpoint.save`` of
    either package, one leaf at a time, each leaf into its use dtype
    (:func:`use_dtype`: with ``cfg.dtype`` bf16 the ``MATMUL_KEYS`` leaves
    in bf16, so an engine's ``cast_params`` keeps the very tensors and
    one copy of the model is held).  Raises on a missing or unexpected
    key or a wrong shape, as :func:`from_jax_flat`.

    A member stored uncompressed (``np.savez`` writes ZIP64 members so) is
    read from the file at its data offset (past the zip local header and
    the ``.npy`` header), a leaf under ``STACKS`` one layer slice at a
    time, other leaves whole, and its CRC-32 checked as ``np.load``
    checks it (in chunks on a pool of threads, combined).  Each piece goes
    to ``device`` in the file's dtype (on the card through one pinned host
    buffer) and is cast there into the leaf, so the device holds at most
    the use-dtype tree and one piece in fp32, and the host one piece (a
    full-width OLMoE-1B-7B checkpoint: its 13.9 GB bf16 tree and a 0.54 GB
    layer of ``w_up``, not a 27.7 GB fp32 tree beside the cast copy).  A
    compressed member (``np.savez_compressed``) or a Fortran-ordered
    array is read whole into host memory, one leaf at a time, and copied
    to the device one piece at a time."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    out: Params = {}
    with open(os.path.join(path, "params.npz"), "rb") as f, \
            zipfile.ZipFile(f) as zf, \
            ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        members = {(n[:-4] if n.endswith(".npy") else n): zf.getinfo(n)
                   for n in zf.namelist()}
        _check_keys(cfg, want, members)
        reader = _NpzReader(f, zf, pool, pin=dev.type == "cuda")
        for key, shape in want.items():
            out[key] = reader.leaf(members[key], key, shape,
                                   use_dtype(cfg, key), dev)
    return out


class _NpzReader:
    """Reads the members of one open ``.npz`` file piece by piece for
    :func:`load_checkpoint`: ``f`` the file, ``zf`` its zip directory,
    ``pool`` the threads that check CRC-32s, ``pin`` whether pieces are
    read into page-locked host memory (bound for the card)."""

    def __init__(self, f, zf: zipfile.ZipFile, pool: ThreadPoolExecutor,
                 pin: bool):
        self.f, self.zf, self.pool, self.pin = f, zf, pool, pin

    def leaf(self, info: zipfile.ZipInfo, key: str, shape: Tuple[int, ...],
             dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
        """Member ``info`` as a ``dtype`` tensor on ``dev``, copied there
        one piece at a time (the pieces' host buffer dies with this
        call)."""
        stacked = key.startswith(STACKS)
        leaf = torch.empty(shape, dtype=dtype, device=dev)
        for i, piece in enumerate(self._pieces(info, key, shape, stacked)):
            (leaf[i] if stacked else leaf).copy_(piece.to(dev))
        return leaf

    def _pieces(self, info: zipfile.ZipInfo, key: str,
                shape: Tuple[int, ...], stacked: bool
                ) -> Iterator[torch.Tensor]:
        """The leaf of member ``info`` as host tensors in the file's dtype:
        its layer slices in order where ``stacked``, else the whole leaf;
        one buffer is reused across slices, so each piece is valid until
        the next is read."""
        fmt, f = np.lib.format, self.f
        f.seek(info.header_offset)
        local = f.read(30)
        read_header = None
        if info.compress_type == zipfile.ZIP_STORED and \
                local[:4] == b"PK\x03\x04":
            start = info.header_offset + 30 + sum(
                struct.unpack("<HH", local[26:30]))
            f.seek(start)
            read_header = {(1, 0): fmt.read_array_header_1_0,
                           (2, 0): fmt.read_array_header_2_0
                           }.get(fmt.read_magic(f))
        if read_header is not None:
            got, fortran, dtype = read_header(f)
            _check_shape(key, got, shape)
            if not fortran and not dtype.hasobject:
                yield from self._stored(info, start, dtype, shape, stacked)
                return
        with self.zf.open(info) as member:          # checks the CRC-32
            arr = fmt.read_array(member, allow_pickle=False)
        _check_shape(key, arr.shape, shape)
        arr = arr.astype(arr.dtype.newbyteorder("="), copy=False)
        for piece in (arr if stacked else (arr,)):
            yield torch.from_numpy(np.ascontiguousarray(piece))

    def _stored(self, info: zipfile.ZipInfo, start: int, dtype: np.dtype,
                shape: Tuple[int, ...], stacked: bool
                ) -> Iterator[torch.Tensor]:
        """:meth:`_pieces` for an uncompressed C-ordered member whose
        ``.npy`` header ends at ``f.tell()``: positioned reads into one
        piece buffer, the member's CRC-32 accumulated and checked at its
        end."""
        f = self.f
        data = f.tell()
        f.seek(start)
        crc = zlib.crc32(f.read(data - start))
        native = dtype.newbyteorder("=")
        piece = shape[1:] if stacked else shape
        if self.pin:
            buf = torch.empty(piece, pin_memory=True, dtype=torch.from_numpy(
                np.empty(0, native)).dtype)
            arr = buf.numpy()
        else:
            arr = np.empty(piece, native)
            buf = torch.from_numpy(arr)
        n = shape[0] if stacked else 1
        if info.file_size != data - start + n * arr.nbytes:
            raise zipfile.BadZipFile(
                f"{info.filename}: {info.file_size} bytes, its header says "
                f"{data - start + n * arr.nbytes}")
        raw = memoryview(arr.reshape(-1).view(np.uint8))
        for i in range(n):
            f.seek(data + i * arr.nbytes)
            if f.readinto(raw) != arr.nbytes:
                raise zipfile.BadZipFile(f"{info.filename}: truncated")
            crc = crc32(raw, crc, self.pool)
            if native != dtype:                 # the file's other byte order
                arr[...] = arr.view(dtype)
            yield buf
        if crc != info.CRC:
            raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")


# the chunk a thread checks: crc32 adds pieces of at least twice this in
# parallel
CRC_CHUNK = 32 * 2**20


def crc32(data, crc: int = 0, pool: Optional[ThreadPoolExecutor] = None,
          chunk: int = CRC_CHUNK) -> int:
    """``zlib.crc32(data, crc)``, on ``pool``'s threads in ``chunk``-byte
    pieces (zlib's ``crc32`` releases the interpreter lock) combined as
    zlib's ``crc32_combine`` does, where ``data`` holds two chunks or
    more."""
    data = memoryview(data).cast("B")
    n = len(data)
    if pool is None or n < 2 * chunk:
        return zlib.crc32(data, crc)
    spans = [data[i:i + chunk] for i in range(0, n, chunk)]
    for part, crc_part in zip(spans, pool.map(zlib.crc32, spans)):
        crc = _gf2_apply(_crc32_shift(len(part)), crc) ^ crc_part
    return crc


def _gf2_apply(mat: Tuple[int, ...], vec: int) -> int:
    """The 32 x 32 GF(2) matrix ``mat`` (its columns as ints) times ``vec``."""
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


@functools.lru_cache(maxsize=64)
def _crc32_shift(nbytes: int) -> Tuple[int, ...]:
    """The operator that advances a CRC-32 over ``nbytes`` zero bytes
    (zlib's ``crc32_combine``: crc(A + B) = shift(len B)(crc A) ^ crc B),
    by squaring the one-bit operator."""
    op = (0xEDB88320,) + tuple(1 << i for i in range(31))   # one zero bit
    out = tuple(1 << i for i in range(32))                  # identity
    bits = 8 * nbytes
    while bits:
        if bits & 1:
            out = tuple(_gf2_apply(op, c) for c in out)
        op = tuple(_gf2_apply(op, c) for c in op)
        bits >>= 1
    return out


def _init_rule(cfg: ModelConfig, full: str):
    """How leaf ``full`` is initialised: ("normal", scale), ("full",
    value) or ("a_log", None) (log 1..16 over the SSD heads), with the JAX
    ``init_params`` scales."""
    d, H, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    # the shared block and the encoder's blocks initialise as a layer of
    # the stack does, and a cross-attention as a self-attention
    key = (full.replace("shared_attn/", "layers/", 1)
           .replace("encoder/", "layers/", 1)
           .replace("/cross_attn/", "/attn/", 1))
    if key == "embed/embed":
        return "normal", 0.02
    if key == "embed/out_bias":
        # logits are log-hazards (1/years): start rates low so the total
        # rate sum e^logit is O(0.1/yr), not O(vocab)
        return "full", -8.0
    if key in ("embed/lm_head", "layers/ssm/in_proj"):
        return "normal", d ** -0.5
    if key == "layers/ssm/conv_w":
        return "normal", cfg.ssm_conv ** -0.5
    if key == "layers/ssm/out_proj":
        return "normal", cfg.d_inner ** -0.5
    if key == "layers/ssm/A_log":
        return "a_log", None
    if key == "layers/ssm/dt_bias":     # softplus^-1(0.01)
        return "full", float(np.log(np.expm1(np.float32(0.01))))
    if key in ("layers/ssm/D", "layers/ssm/norm_scale") \
            or key.endswith("/scale"):
        return "full", 1.0
    if key == "layers/ssm/conv_b" or key.endswith("/bias") \
            or key.startswith("layers/mlp/b_") \
            or key in ("layers/attn/bq", "layers/attn/bk", "layers/attn/bv"):
        return "full", 0.0
    if key in ("layers/attn/wq", "layers/attn/wk", "layers/attn/wv"):
        return "normal", d ** -0.5
    if key == "layers/attn/wo":
        return "normal", (H * hd) ** -0.5
    if key in ("layers/mlp/w_fc", "layers/mlp/w_gate", "layers/mlp/w_up",
               "layers/moe/router", "layers/moe/w_gate", "layers/moe/w_up",
               "layers/moe/shared/w_gate", "layers/moe/shared/w_up"):
        return "normal", d ** -0.5
    if key in ("layers/mlp/w_proj", "layers/mlp/w_down"):
        return "normal", ff ** -0.5
    if key == "layers/moe/w_down":
        return "normal", cfg.moe_d_ff ** -0.5
    if key == "layers/moe/shared/w_down":
        return "normal", (cfg.n_shared_experts * cfg.moe_d_ff) ** -0.5
    raise AssertionError(f"no initializer for {full}")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the JAX ``init_params`` keys, shapes and scales,
    drawn from ``numpy.random.default_rng(seed)`` (not JAX's stream: the
    values differ from the reference's, their distribution does not), in
    fp32 on the host, then moved to ``device``.  Every config but the MoE
    ones, InternVL2 and SeamlessM4T takes this route (their weights, and
    so the bits of every earlier run, stay as they were); a model too
    large to pass through the host in fp32 takes
    :func:`init_params_on_device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    flat: Dict[str, np.ndarray] = {}
    for full, shape in param_shapes(cfg).items():
        kind, arg = _init_rule(cfg, full)
        if kind == "normal":
            flat[full] = (rng.standard_normal(shape, dtype=np.float32)
                          * np.float32(arg))
        elif kind == "a_log":
            a_log = np.log(np.linspace(1.0, 16.0, cfg.ssm_n_heads,
                                       dtype=np.float32))
            flat[full] = np.broadcast_to(a_log, shape).astype(np.float32)
        else:
            flat[full] = np.full(shape, arg, np.float32)
    return from_jax_flat(flat, cfg.replace(dtype="float32"), dev)


def init_params_on_device(cfg: ModelConfig, seed: int = 0,
                          device="cuda") -> Params:
    """Random weights with :func:`init_params`' keys, shapes and scales,
    made on ``device`` (the card unless the caller passes ``cpu``): the
    route of the MoE configs, InternVL2-26B and SeamlessM4T-large-v2,
    whose fp32 trees (OLMoE 27.7 GB, Qwen2-MoE 57 GB, InternVL2 79 GB,
    SeamlessM4T 6.5 GB) would take minutes of host RNG and, beside a cast
    copy, more than the card's memory.

    Each leaf is drawn from one ``torch.Generator`` on ``device`` seeded
    with ``seed``, in fp32, one layer slice at a time (a whole
    (24, 60, 2048, 1408) expert leaf would be 16.6 GB in fp32), and stored
    in the dtype it is used in: ``MATMUL_KEYS`` leaves in the activation
    dtype ``cfg.dtype``, the rest in fp32.  ``models.model.cast_params`` is
    then a no-op on them (``Tensor.to`` returns the tensor itself), so an
    engine holds one copy of the model and no fp32 copy of the whole
    exists anywhere.  The values are not :func:`init_params`' (another
    stream); the same config and seed give the same tensors, and a config
    that differs only in ``dtype`` gets the same draws, rounded to its
    dtype (the fp32 model beside the bf16 one)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: Params = {}
    for full, shape in param_shapes(cfg).items():
        dtype = use_dtype(cfg, full)
        kind, arg = _init_rule(cfg, full)
        if kind == "full":
            out[full] = torch.full(shape, arg, dtype=dtype, device=dev)
            continue
        if kind == "a_log":
            a_log = torch.log(torch.linspace(1.0, 16.0, cfg.ssm_n_heads,
                                             device=dev))
            out[full] = a_log.expand(shape).to(dtype).clone()
            continue
        leaf = torch.empty(shape, dtype=dtype, device=dev)
        stacked = full.startswith(STACKS)
        for sl in (leaf if stacked else (leaf,)):
            sl.copy_(torch.randn(sl.shape, generator=gen, device=dev)
                     .mul_(arg))
        out[full] = leaf
    return out
