"""Roofline analysis of the dry run's records, with the constants of the
NVIDIA H100 SXM (the JAX package's ``launch/roofline.py``, whose constants
are a TPU v5e's).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The collective bytes are the sharded step's own (``launch.collectives``:
each collective's result bytes on a device, counted as the dry run runs
the step on DTensors).

MODEL_FLOPS uses the 6ND (train) / 2ND (inference) convention with N =
active parameters; the ratio of MODEL_FLOPS to the counted FLOPs exposes
remat recompute and dispatch waste (the dense MoE dispatch runs every
expert over every token).

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir DIR \
        [--markdown]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig

# The card these are for: NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W
# power limit, as nvidia-smi reports it.  Datasheet peaks, not
# measurements: a card capped below 700 W runs slower under load.
PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12          # HBM3 bytes/s
# NVLink 4: 18 links of 50 GB/s make 900 GB/s a card, 450 GB/s each way.
# A collective's bytes leave a card at the one-way rate, so the collective
# term uses 450 GB/s (the role of the reference's ICI_BW).
LINK_BW = 450e9


def active_params(cfg: ModelConfig) -> int:
    """Approximate active (per-token) parameter count (MoE: top_k routed +
    shared; frontends excluded)."""
    d = cfg.d_model
    if cfg.arch_type == "ssm":
        per_layer = d * (2 * cfg.d_inner + 2 * cfg.ssm_state
                         + cfg.ssm_n_heads) + cfg.d_inner * d
    elif cfg.arch_type == "hybrid":
        mamba = d * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_n_heads) \
            + cfg.d_inner * d
        attn = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                + cfg.n_heads * cfg.head_dim * d + 3 * d * cfg.d_ff)
        n_apps = -(-cfg.n_layers // cfg.attn_every)
        return cfg.n_layers * mamba + n_apps * attn + 2 * cfg.vocab_size * d
    else:
        attn = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                + cfg.n_heads * cfg.head_dim * d)
        if cfg.n_experts:
            mlp = 3 * d * cfg.moe_d_ff * (cfg.top_k + cfg.n_shared_experts)
        elif cfg.activation == "swiglu":
            mlp = 3 * d * cfg.d_ff
        else:
            mlp = 2 * d * cfg.d_ff
        per_layer = attn + mlp
        n_layers = cfg.n_layers + cfg.n_encoder_layers
        return n_layers * per_layer + 2 * cfg.vocab_size * d
    return cfg.n_layers * per_layer + 2 * cfg.vocab_size * d


def model_flops(cfg: ModelConfig, rec: Dict) -> float:
    """6*N*D train / 2*N*D inference, D = tokens processed this step."""
    n_act = active_params(cfg)
    if rec["mode"] == "train":
        return 6.0 * n_act * rec["seq_len"] * rec["global_batch"]
    if rec["mode"] == "prefill":
        return 2.0 * n_act * rec["seq_len"] * rec["global_batch"]
    return 2.0 * n_act * rec["global_batch"]      # decode: 1 token/row


def terms(rec: Dict) -> Dict[str, float]:
    comp = (rec["flops_per_device"] or 0.0) / PEAK_FLOPS
    memb = (rec["bytes_per_device"] or 0.0) / HBM_BW
    coll = rec.get("collective_total", 0.0) / LINK_BW
    dominant = max(("compute", comp), ("memory", memb),
                   ("collective", coll), key=lambda kv: kv[1])[0]
    return {"compute_s": comp, "memory_s": memb, "collective_s": coll,
            "dominant": dominant}


_SUGGEST = {
    "compute": "reduce redundant FLOPs (remat policy, MoE ragged dispatch, "
               "fused kernels) or widen the model axis",
    "memory": "shrink the working set: bf16 residuals, fused/chunked "
              "softmax+CE, flash attention tiles, fewer unfused "
              "elementwise passes",
    "collective": "re-shard to cut all-gathers (2D sharding of embed/logits, "
                  "overlap collectives with compute, fewer resharding "
                  "points)",
}


def analyse(rec: Dict, cfg: Optional[ModelConfig] = None) -> Dict:
    cfg = cfg or get_config(rec["arch"])
    t = terms(rec)
    mf = model_flops(cfg, rec)
    counted = (rec["flops_per_device"] or 0.0) * rec["n_chips"]
    out = dict(rec)
    out.update(t)
    out["model_flops_total"] = mf
    out["useful_ratio"] = mf / counted if counted else None
    out["suggestion"] = _SUGGEST[t["dominant"]]
    return out


def load_records(dirpath: str) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | variant | compute_s | memory_s | "
            "collective_s | dominant | useful FLOP ratio | peak GiB/dev |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for rec in recs:
        a = analyse(rec)
        ur = f"{a['useful_ratio']:.3f}" if a["useful_ratio"] else "-"
        rows.append(
            f"| {a['arch']} | {a['shape']} | {a['mesh']} "
            f"| {a.get('variant') or '-'} "
            f"| {a['compute_s']:.3e} | {a['memory_s']:.3e} "
            f"| {a['collective_s']:.3e} | **{a['dominant']}** | {ur} "
            f"| {a['memory']['peak_estimate_bytes']/2**30:.2f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    if args.markdown:
        print(table(recs))
        return
    for rec in recs:
        a = analyse(rec)
        print(f"{a['arch']:24s} {a['shape']:12s} {a['mesh']:8s} "
              f"comp {a['compute_s']:.3e}s mem {a['memory_s']:.3e}s "
              f"coll {a['collective_s']:.3e}s -> {a['dominant']:10s} "
              f"useful {a['useful_ratio'] if a['useful_ratio'] else 0:.3f}")


if __name__ == "__main__":
    main()
