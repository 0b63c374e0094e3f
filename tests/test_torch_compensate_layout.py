"""The layout of the resident compensation kernel, computed on the host,
where the CPU can check it: the grid of ``resident_grid`` covers every
(row, column) of the output exactly once, with at most about one block per
SM, at least two passes of its lane groups per block where it has more
than one, and no empty block; ``slab_cols`` keeps its column width and its
cap.
"""
import numpy as np
import pytest

from repro_torch.kernels.build import resident_grid, slab_cols

H100_SMEM = 232_448          # opt-in shared memory per block
CAP = H100_SMEM // 16        # one 16-byte vector per store row: 14,528 rows
STORE_ROWS = (1, 123, 2880, 4096, 14_000, CAP)


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("n", [1, 7, 2304, 3648])
@pytest.mark.parametrize("d", [50, 130, 256, 520])
@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
def test_layouts_cover_the_output_once(sms, n, d, elt):
    vec = 16 // elt
    for m in STORE_ROWS:
        bd = slab_cols(m, d, elt, H100_SMEM)
        # the widest multiple of the vector that fits, at most D rounded up
        assert bd % vec == 0 and m * bd * elt <= H100_SMEM
        assert bd == -(-d // vec) * vec or m * (bd + vec) * elt > H100_SMEM
        unit = vec if d % vec == 0 else 1   # the element-wise path
        c, p, rows = resident_grid(n, d, bd, unit, sms)
        assert c == -(-d // bd)
        assert 1 <= p <= max(1, sms // c) and p * c <= max(c, sms)
        assert p == -(-n // rows)
        if p > 1:   # every block keeps two passes of its 32 * R lane groups
            assert rows >= 2 * 32 * (32 // min(bd // unit, 32))
        cover = np.zeros((n, d), np.int8)
        for i in range(p):               # block (i, j): rows i, columns j
            share = cover[i * rows:(i + 1) * rows]
            assert share.shape[0] > 0, (m, i)   # no empty block
            for j in range(c):
                share[:, j * bd:(j + 1) * bd] += 1
        assert (cover == 1).all(), m
    with pytest.raises(ValueError, match=f"M={CAP + 1} rows does not fit"):
        slab_cols(CAP + 1, d, elt, H100_SMEM)


def test_layout_at_the_main_paths_shapes():
    """arxiv-cpu (store (4096, 256) f32, 2304 halo rows): 22 column tiles of
    12, lane groups of 3 lanes (320 rows per pass of a block), so 3 shares
    of 768 rows, 66 blocks (measured faster than 6 shares, one block per
    SM, and than 1 share); M = 14,000 leaves 4 columns: 64 tiles of 1-lane
    groups, at most 2 shares."""
    bd = slab_cols(4096, 256, 4, H100_SMEM)
    assert resident_grid(2304, 256, bd, 4, 132) == (22, 3, 768)
    assert resident_grid(2304, 256, bd, 4, 1) == (22, 1, 2304)
    bd = slab_cols(14_000, 256, 4, H100_SMEM)
    assert resident_grid(3648, 256, bd, 4, 132) == (64, 1, 3648)
    assert resident_grid(8192, 256, bd, 4, 132) == (64, 2, 4096)
