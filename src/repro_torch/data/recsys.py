"""Synthetic recsys batches for BST (copy of `repro/data/recsys.py`):
power-law item popularity and a planted sequence -> click correlation.
numpy throughout, so a seed gives the JAX package's arrays exactly;
`to_tensors` moves a batch to a device."""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device


def _zipf_ids(rng, vocab, shape, a: float = 1.2):
    raw = rng.zipf(a, size=shape)
    return np.minimum(raw - 1, vocab - 1).astype(np.int32)


def bst_batch(cfg, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    hist = _zipf_ids(rng, cfg.item_vocab, (batch, cfg.seq_len))
    target = _zipf_ids(rng, cfg.item_vocab, (batch,))
    profile = rng.integers(0, cfg.profile_vocab,
                           (batch, cfg.n_profile_fields)).astype(np.int32)
    multihot = rng.integers(
        -1, cfg.multihot_vocab,
        (batch, cfg.n_multihot_fields, cfg.multihot_len)).astype(np.int32)
    # planted signal: click if the target item appeared in history
    click = (hist == target[:, None]).any(axis=1)
    noise = rng.random(batch) < 0.1
    labels = (click ^ noise).astype(np.float32)
    return {
        "hist_items": hist, "target_item": target,
        "profile_ids": profile, "multihot_ids": multihot,
        "labels": labels,
    }


def retrieval_batch(cfg, batch: int = 1, n_candidates: int = 1_000_000,
                    seed: int = 0):
    rng = np.random.default_rng(seed)
    b = bst_batch(cfg, batch, seed)
    b["candidates"] = rng.integers(
        0, cfg.item_vocab, (batch, n_candidates)).astype(np.int32)
    return b


def to_tensors(batch: dict, device=None) -> dict:
    """A batch's numpy arrays as tensors on `device` (default ``"cuda"``)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
