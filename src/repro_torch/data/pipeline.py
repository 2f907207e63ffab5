"""Batching pipeline: trajectory packing, target/dt construction, iterators
(numpy only; a copy of the JAX package's ``data/pipeline.py``).

Packing follows the Delphi training recipe: one patient per row, padded to
``seq_len``; targets are next events; ``target_dt`` is the (non-negative)
waiting time to the next event; the loss mask excludes positions whose target
is PAD or NO_EVENT (the "no event" marker is an input-side hazard refresh, not
a supervised outcome).
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from repro_torch.data import vocab as V


def pack_trajectories(trajs: Sequence[Tuple[np.ndarray, np.ndarray]],
                      seq_len: int) -> Dict[str, np.ndarray]:
    """-> dict of arrays (N, seq_len): tokens, ages, targets, target_dt,
    loss_mask."""
    n = len(trajs)
    tokens = np.zeros((n, seq_len), np.int32)
    ages = np.zeros((n, seq_len), np.float32)
    targets = np.zeros((n, seq_len), np.int32)
    target_dt = np.zeros((n, seq_len), np.float32)
    mask = np.zeros((n, seq_len), np.float32)
    for i, (t, a) in enumerate(trajs):
        L = min(len(t), seq_len)
        tokens[i, :L] = t[:L]
        ages[i, :L] = a[:L]
        ages[i, L:] = a[L - 1] if L else 0.0
        if L > 1:
            targets[i, :L - 1] = t[1:L]
            target_dt[i, :L - 1] = np.maximum(a[1:L] - a[:L - 1], 1e-4)
            real = (t[1:L] != V.PAD) & (t[1:L] != V.NO_EVENT)
            mask[i, :L - 1] = real.astype(np.float32)
    return {"tokens": tokens, "ages": ages, "targets": targets,
            "target_dt": target_dt, "loss_mask": mask}


def batches(packed: Dict[str, np.ndarray], batch_size: int, *, seed: int = 0,
            epochs: int | None = None) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epoch iterator over a packed dataset (drops the remainder)."""
    n = packed["tokens"].shape[0]
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            yield {k: v[idx] for k, v in packed.items()}
        epoch += 1


def lm_batch(rng: np.random.Generator, batch: int, seq_len: int,
             vocab_size: int) -> Dict[str, np.ndarray]:
    """Generic random-token LM batch."""
    tokens = rng.integers(0, vocab_size, (batch, seq_len), dtype=np.int64)
    return {"tokens": tokens.astype(np.int32)}


def dataset_stats(trajs: Sequence[Tuple[np.ndarray, np.ndarray]]
                  ) -> Dict[str, float]:
    lens = np.array([len(t) for t, _ in trajs])
    death = np.array([V.DEATH in t for t, _ in trajs])
    last_age = np.array([a[-1] for _, a in trajs])
    n_dis = np.array([(t >= V.DISEASE0).sum() for t, _ in trajs])
    return {"n": float(len(trajs)), "mean_len": float(lens.mean()),
            "max_len": float(lens.max()), "death_frac": float(death.mean()),
            "mean_last_age": float(last_age.mean()),
            "mean_diseases": float(n_dis.mean())}
