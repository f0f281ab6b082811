"""Precomputed text embeds (port of `PrecomputedTextEmbeds`,
`viditq_tpu/models/text_encoder.py:42-57`).

The quant flows run from embeds precomputed by the JAX package's
`get-text-embeds` (reference `t2v/scripts/get_text_embeds.py:75-92`): an
npz with `y` [N, 2, 1, L, C] ([cond, null] pairs) and `mask` [N, L]. The
live T5 and CLIP encoders are not ported (they need weights and
`transformers`).
"""

from __future__ import annotations

from typing import Dict, Sequence

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
