"""The host-side launch planning of K17 expr_eval and K5's row gather: the
tile K17 takes by the program's registers and the device's shared memory,
its parameter block's layout, K5's thread layout by the source's size
against the L2, and the bytes a gather must move. Plain integer
arithmetic: no card needed, nothing compared with a tolerance."""

import ctypes

import pytest

from datafusion_parallelism_tpu_torch.kernels import expr_eval as k17
from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5

# (opt-in shared memory a block, shared memory an SM) of the H100, and of a
# card with less (an sm_86 part)
H100 = (232_448, 233_472)
SMALL = (101_376, 102_400)


@pytest.mark.parametrize("limits", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("n_regs", range(1, k17.MAX_REGS + 1))
def test_plan_tile_fits_the_device(n_regs, limits):
    """Every register count up to MAX_REGS, at the largest program a launch
    takes: the tile is a multiple of 32 rows (of the block), its shared
    memory is what smem_bytes says and within the block's limit; where not
    even one row a thread fits, planning raises."""
    code, roots = k17.MAX_CODE, k17.MAX_OUTS
    if k17.smem_bytes(n_regs, code, roots, k17.BLOCK) > limits[0]:
        with pytest.raises(ValueError, match="shared memory"):
            k17.plan_tile(n_regs, code, roots, *limits)
        return
    tile, need = k17.plan_tile(n_regs, code, roots, *limits)
    assert tile % 32 == 0 and tile % k17.BLOCK == 0 and k17.BLOCK <= tile <= k17.MAX_TILE
    assert need == k17.smem_bytes(n_regs, code, roots, tile) <= limits[0]
    # the tile is the largest that lets TILE_BLOCKS blocks share an SM,
    # unless it is one row a thread
    budget = min(limits[0], limits[1] // k17.TILE_BLOCKS - k17.BLOCK_RESERVE)
    if tile > k17.BLOCK:
        assert need <= budget
    if tile < k17.MAX_TILE:
        assert k17.smem_bytes(n_regs, code, roots, tile + k17.BLOCK) > budget


def test_plan_tile_raises_past_the_block_limit():
    with pytest.raises(ValueError, match="shared memory"):
        k17.plan_tile(64, k17.MAX_CODE, k17.MAX_OUTS, 100_000, 233_472)


def test_smem_bytes_layout():
    """Values (8 bytes a register and row, one uniform slot per
    instruction, 16-byte aligned), validity and scratch words (4 bytes a
    register and 32 rows, 4 a scratch word per 32 rows, one per
    instruction, 16-byte aligned), one 72-byte decoded instruction per
    instruction and root."""
    assert k17.DEC_BYTES == 72
    assert k17.smem_bytes(5, 29, 2, 2560) == 8 * (5 * 2560 + 29) + 8 + 2048 + 31 * 72
    assert k17.smem_bytes(1, 1, 1, 256) == 8 * 258 + 80 + 2 * 72
    assert k17.smem_bytes(64, 256, 32, 256) == 8 * (64 * 256 + 256) + 3104 + 288 * 72


def test_params_layout():
    """_Params field for field as csrc/expr_eval.cu's Params lays it out
    under the C ABI: five pointers, n, six ints, the scalars, 64 column
    and 32 output references of 24 bytes."""
    P = k17._Params
    offsets = {name: getattr(P, name).offset for name, _ in P._fields_}
    assert offsets == {"code": 0, "tables": 8, "num_rows": 16, "and_mask": 24, "mask_out": 32,
                       "n": 40, "n_code": 48, "n_out": 52, "mask_reg": 56, "n_regs": 60,
                       "tile": 64, "pad": 68, "scalar_bits": 72, "scalar_valid": 136,
                       "cols": 168, "outs": 1704}
    assert ctypes.sizeof(k17._ColRef) == ctypes.sizeof(k17._OutRef) == 24
    assert ctypes.sizeof(P) == 1704 + 32 * 24


L2 = 52_428_800   # the H100's L2


@pytest.mark.parametrize("cap, F, layout", [
    (1 << 22, 0, k5.GATHER_WORD),              # the 4 M-row sort: 16 MB a word row
    (L2 // 4, 0, k5.GATHER_WORD),              # a word row of exactly the L2
    (L2 // 4 + 1, 0, k5.GATHER_WORD4),
    (L2 // 8, 2, k5.GATHER_WORD),              # a float64 sidecar row of the L2
    (L2 // 8 + 1, 2, k5.GATHER_WORD4),
    (1 << 22, 1, k5.GATHER_WORD),
    (67_108_864, 0, k5.GATHER_WORD4),            # Q20's grouping: 268 MB a word row
    (1 << 25, 1, k5.GATHER_WORD4),               # a SORT build of 2^25 rows
    (0, 0, k5.GATHER_WORD),
])
def test_gather_layout(cap, F, layout):
    assert k5.gather_layout(cap, F, L2) == layout


def test_gather_bytes():
    """idx and a source row for each row below min(n, m), never more
    source bytes than there are; m rows written."""
    # Q20's grouping gather: 5 words, 67,108,864 rows, 9,193,894 counted
    row, m, k = 20, 67_108_864, 9_193_894
    assert k5.gather_bytes(5, 0, m, m, None) == 4 * m + row * m + row * m
    assert k5.gather_bytes(5, 0, m, m, k) == 4 * k + row * k + row * m
    assert k5.gather_bytes(2, 1, 100, 50, 0) == 50 * 16
    assert k5.gather_bytes(2, 1, 100, 50, 80) == 4 * 50 + 16 * 50 + 16 * 50
    assert k5.gather_bytes(2, 1, 10, 50, None) == 4 * 50 + 16 * 10 + 16 * 50
    assert k5.gather_bytes(3, 0, 0, 0, None) == 0
