"""The tiling of the wide-head attention kernel (`csrc/attn_wide.cuh`: K3
full/masked and K6 at D = 192 and 256), as far as it can be held on the
CPU: the addresses at which its two consumer warpgroups write the shared
probability (bf16) and code (int8) tiles, replayed from the kernel's
formulas, cover each tile once and put every score where the PV's A
operand reads it (for the codes, the k order of `KV_PERM`, the order of
the v^T codes); and the column split it replaced is gone. The numerics
are held against the JAX package in tests/test_torch_head_dims_wide.py
and on the card by chip_smoke.py.
"""

import numpy as np

from viditq_tpu_torch.kernels import _build
from viditq_tpu_torch.kernels import attention as A

BQW, BKV, HALF = 64, 64, 32  # q rows a block, kv rows a tile, a half's
WIDE = _build.CSRC / "attn_wide.cuh"


def _threads():
    """(warpgroup, row0, t4) of the 256 consumer threads, as the kernel
    derives them from threadIdx.x."""
    for ct in range(256):
        g = (ct & 31) >> 2
        yield ct >> 7, ((ct >> 5) & 3) * 16 + g, ct & 3


def _score(wg, row0, t4, i):
    """(q row, kv column in the tile) of score register i of a thread:
    wgmma m64n32's accumulator layout, the warpgroup's 32 columns."""
    return (row0 + 8 * ((i >> 1) & 1),
            wg * HALF + 8 * (i >> 2) + 2 * t4 + (i & 1))


def test_probability_tile_holds_each_score_once_in_k_order():
    # bf16: element (row, k) of the K-major no-swizzle A operand lies at
    # (k // 8) * (BQW * 16) + row * 16 + (k % 8) * 2; the kernel writes
    # pack_bf16(p[0], p[1]) at base + (4wg + j) * (BQW * 16) and p[2], p[3]
    # eight rows on, base = row0 * 16 + 4 * t4
    src = WIDE.read_text()
    assert "uint8_t* base = pb + row0 * 16 + 4 * t4;" in src
    assert "uint8_t* at = base + (4 * wg + j) * (BQW * 16);" in src
    seen = {}
    for wg, row0, t4 in _threads():
        for j in range(4):
            at = row0 * 16 + 4 * t4 + (4 * wg + j) * (BQW * 16)
            for word, regs in ((at, (4 * j, 4 * j + 1)),
                               (at + 8 * 16, (4 * j + 2, 4 * j + 3))):
                for half, i in enumerate(regs):
                    byte = word + 2 * half
                    chunk, rest = divmod(byte, BQW * 16)
                    row, off = divmod(rest, 16)
                    key = (row, chunk * 8 + off // 2)
                    assert key not in seen
                    seen[key] = _score(wg, row0, t4, i)
    assert len(seen) == BQW * BKV
    assert all(seen[(r, k)] == (r, k) for r, k in seen)


def test_code_tile_holds_each_code_once_in_kv_perm_order():
    # int8: byte (row, k) of the K-major A operand lies at (k // 16) *
    # (BQW * 16) + row * 16 + k % 16; the kernel writes codes4 of score
    # registers (0, 1, 4, 5), (2, 3, 6, 7), (8, 9, 12, 13), (10, 11, 14,
    # 15) at base + c0, + 8 rows, + one chunk, + both; the v^T codes hold
    # kv row KV_PERM[k] at byte k of each 32-row chunk, so the code at k
    # must be that of kv column KV_PERM[k]
    src = WIDE.read_text()
    assert "const int c0 = 2 * wg * (BQW * 16);" in src
    for regs in ("sc[0], sc[1], sc[4], sc[5]", "sc[2], sc[3], sc[6], sc[7]",
                 "sc[8], sc[9], sc[12], sc[13]",
                 "sc[10], sc[11], sc[14], sc[15]"):
        assert f"codes4({regs})" in src
    words = (((0, 1, 4, 5), 0), ((2, 3, 6, 7), 8 * 16),
             ((8, 9, 12, 13), BQW * 16), ((10, 11, 14, 15), BQW * 16 + 8 * 16))
    seen = {}
    for wg, row0, t4 in _threads():
        base = row0 * 16 + 4 * t4 + 2 * wg * (BQW * 16)
        for regs, off in words:
            for b, i in enumerate(regs):
                chunk, rest = divmod(base + off + b, BQW * 16)
                row, byte = divmod(rest, 16)
                key = (row, chunk * 16 + byte)
                assert key not in seen
                seen[key] = _score(wg, row0, t4, i)
    assert len(seen) == BQW * BKV
    for (row, k), (srow, col) in seen.items():
        assert srow == row
        assert col == (k // 32) * 32 + A.KV_PERM[k % 32]


def test_the_column_split_is_gone():
    # no block takes a second q.k of a head for another column half: the
    # core has no `block_cols`, and the wide kernel splits one tile's
    # scores (m64n32) and the PV's columns inside one block, fed by TMA
    core = (_build.CSRC / "attn_core.cuh").read_text()
    assert "block_cols" not in core
    wide = WIDE.read_text()
    assert "m64n32k16.f32.bf16.bf16" in wide
    assert "m64n96k16" in wide and "m64n128k16" in wide
    assert "m64n96k32.s32.s8.s8" in wide and "m64n128k32.s32.s8.s8" in wide
    assert "setmaxnreg" in wide and "tma_load_3d" in wide
    assert "dim3 grid((N + BQW - 1) / BQW, H, B);" in wide
    for name in ("attention.cu", "attention_stream.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "attn_wide.cuh"' in src
        assert "if constexpr (D > 128)" in src
