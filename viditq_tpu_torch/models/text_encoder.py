"""Precomputed text embeds and the class-label encoder (port of
`PrecomputedTextEmbeds` and `ClassEncoder`,
`viditq_tpu/models/text_encoder.py:42-57`, :104-115).

The quant flows run from embeds precomputed by the JAX package's
`get-text-embeds` (reference `t2v/scripts/get_text_embeds.py:75-92`): an
npz with `y` [N, 2, 1, L, C] ([cond, null] pairs) and `mask` [N, L]. The
live T5 and CLIP encoders are not ported (they need weights and
`transformers`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


class PrecomputedTextEmbeds:
    def __init__(self, path: str):
        data = np.load(path)
        self.y = data["y"]
        self.mask = data["mask"]

    def select(self, batch_ids: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The prompts batch_ids in the sampler's [cond; null] batch layout
        (iddpm/__init__.py:70-83): y [2B, 1, L, C], mask [B, L]."""
        ids = np.asarray(batch_ids)
        y = self.y[ids]
        y = np.concatenate([y[:, 0], y[:, 1]], axis=0)
        return {"y": torch.from_numpy(np.ascontiguousarray(y)),
                "mask": torch.from_numpy(np.ascontiguousarray(
                    self.mask[ids]))}


class ClassEncoder:
    """Label conditioning for DiT (reference text_encoder/classes.py:7-20):
    y the int labels, no mask; the CFG's unconditional row is the null
    label num_classes (`LabelEmbedder`'s last row)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def encode(self, labels: List[int]) -> Dict[str, torch.Tensor]:
        return {"y": torch.tensor(labels, dtype=torch.int32), "mask": None}

    def null(self, n: int) -> torch.Tensor:
        return torch.full((n,), self.num_classes, dtype=torch.int32)
