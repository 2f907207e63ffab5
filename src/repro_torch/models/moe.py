"""Mixture-of-experts MLP of the port (the JAX package's ``models/moe.py``):
a top-k router over ``E`` routed experts, optional shared experts, and the
Switch load-balance loss.

Routing follows the reference: router logits in fp32, softmax, top-k,
the k weights renormalised to sum to 1, and the aux loss ``E * sum_e f_e *
p_e`` (``f_e`` the share of routed slots that chose expert ``e``, ``p_e``
its mean probability).  The router weight stays fp32 (it is not a
``MATMUL_KEYS`` leaf); the experts' weights enter their products in the
activation dtype.

:func:`apply_moe` computes the function of the reference's default
dispatch (``moe_dense_scan``: every expert over every token, combined
with the mostly-zero router weights) in the form of its
``moe_dense_einsum``: batched products over the whole expert stack,
``(E, t, d) x (E, d, f)`` for gate and up, SiLU(gate) * up, ``x (E, f,
d)``, then the combine over the experts with the ``(t, E)`` router
weights.  Each of these gives a token's row the same bits whatever the
number of tokens t beside it (measured on the H100 from 8 to 1,024 rows),
which keeps a prompt prefilled in chunks bit-equal to the same prompt
prefilled whole; one product ``(t, E f) x (E f, d)`` that summed over the
experts as it contracted did not (cuBLAS splits its 84,480-long
contraction by t).  Tokens go through in chunks of fixed length
(:func:`token_chunk`), so that each ``(E, t, .)`` intermediate holds at
most ``CHUNK_ELEMENTS`` elements.
Nothing here reads a value back to the host or takes a shape from the
data, so a serving tick keeps its one host copy and ``torch.export``
traces the route.  The reference's sorted ``ragged`` dispatch computes
the same function with the routed experts' products only; it is not
ported (its grouped product needs device-side group offsets).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_swiglu

# the fp32 router product runs in blocks of this many rows (the last one
# zero-padded): cuBLAS's fp32 kernels sum an (M, d) x (d, E) product's row
# in another order as M changes (measured on the H100 at E 60 and 64 from
# M 8 to 8,192, batched or not), and a token routed by other bits in a
# chunked prefill than in a whole one can flip an expert and part the two;
# at one shape every row gets the same bits
ROUTER_ROWS = 256

# the (E, t, f) and (E, t, d) intermediates of one token chunk: 2^27
# elements each at most, 256 MB in bf16 (Qwen2-MoE: 1,092 tokens a chunk,
# OLMoE: 1,024)
CHUNK_ELEMENTS = 1 << 27


def router_logits(router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (T, d) @ router (d, E) in fp32, in products of ``ROUTER_ROWS``
    rows each, so that a row's logits do not depend on T."""
    T = x.shape[0]
    xf = F.pad(x.float(), (0, 0, 0, (-T) % ROUTER_ROWS))
    r = router.float()
    out = [xf[i:i + ROUTER_ROWS] @ r
           for i in range(0, xf.shape[0], ROUTER_ROWS)]
    return (out[0] if len(out) == 1 else torch.cat(out))[:T]


def route(router: torch.Tensor, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> (weights (T, k) fp32, experts (T, k) int64, aux fp32
    scalar).

    ``lax.top_k`` puts the lower index first among equal values.
    ``torch.topk`` does not promise any order among them (on the CPU it
    returned experts 1 and 3 of four equal probabilities, not 0 and 1), so
    the experts are taken from a stable descending sort, which keeps the
    lower index first."""
    probs = torch.softmax(router_logits(router, x), dim=-1)         # (T, E)
    weights, experts = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    weights, experts = weights[:, :top_k], experts[:, :top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    E = probs.shape[-1]
    chosen = torch.zeros_like(probs).scatter_add_(
        1, experts, torch.ones_like(weights))                      # (T, E)
    aux = E * (chosen.mean(dim=0) * probs.mean(dim=0)).sum()
    return weights, experts, aux


def token_chunk(cfg: ModelConfig) -> int:
    """Tokens a chunk of :func:`apply_moe`'s products takes."""
    return max(1, CHUNK_ELEMENTS // (cfg.n_experts
                                     * max(cfg.d_model, cfg.moe_d_ff)))


def apply_moe(blk, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss fp32 scalar).
    ``blk`` is a block's weights by name (``models.model.Block``):
    ``moe/router`` (d, E), ``moe/w_gate``/``moe/w_up`` (E, d, f),
    ``moe/w_down`` (E, f, d) and, with shared experts, the SwiGLU MLP
    ``moe/shared/*`` of width ``n_shared_experts * f``."""
    B, S, d = x.shape
    dt = x.dtype
    flat = x.reshape(B * S, d)
    weights, experts, aux = route(blk["moe/router"], flat, cfg.top_k)
    combine = torch.zeros((B * S, cfg.n_experts), dtype=dt,
                          device=x.device).scatter_(1, experts,
                                                    weights.to(dt))
    wg, wu, wd = (blk[k].to(dt) for k in ("moe/w_gate", "moe/w_up",
                                          "moe/w_down"))
    E = wg.shape[0]
    step = token_chunk(cfg)
    outs = []
    for lo in range(0, B * S, step):
        xs = flat[lo:lo + step]
        xe = xs.unsqueeze(0).expand(E, *xs.shape)                   # (E, t, d)
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)           # (E, t, f)
        y = torch.bmm(h, wd)                                        # (E, t, d)
        outs.append(torch.einsum("etd,te->td", y, combine[lo:lo + step]))
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    if "moe/shared/w_gate" in blk:
        y = y + apply_swiglu(flat, blk["moe/shared/w_gate"],
                             blk["moe/shared/w_up"], blk["moe/shared/w_down"])
    return y.reshape(B, S, d), aux
