"""Launch counts of the hand-written kernels.

Each wrapper adds one to `launches` of its counter where it launches its
kernel on CUDA tensors, and nowhere else; each plain version adds one to
`plain_cuda` when it is called on CUDA tensors. A run resets the counts
(`reset`) before the path it wants to audit and reads them (`snapshot`)
after, to show which kernels the path went through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class Counter:
    launches: int = 0
    plain_cuda: int = 0


COUNTERS: Dict[str, Counter] = {
    name: Counter() for name in (
        "ln_modulate_quantize",      # K1
        "int8_consumer_matmul",      # K2
        "attention_bnhd",            # K3
        "attention_bnhd_f32",        # K3's float32 mode
        "quantize_rows",             # K4
        "fused_dynq_int8_matmul",    # K5
        "attention_bnhd_stream",     # K6
        "attention_bnhd_stream_f32",  # K6's float32 mode
        "dynamic_quant_rows",        # K7a
        "int8_matmul",               # K7b
        "qk_headwise_quant",         # K8
    )
}


def reset() -> None:
    for c in COUNTERS.values():
        c.launches = 0
        c.plain_cuda = 0


def snapshot() -> Dict[str, Dict[str, int]]:
    return {k: dataclasses.asdict(v) for k, v in COUNTERS.items()}


def count_plain(name: str, t) -> None:
    if t.is_cuda:
        COUNTERS[name].plain_cuda += 1
