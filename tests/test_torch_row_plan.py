"""The split-KV attention kernels' row plan, on the CPU.

A thread block of ``csrc/split_attention.cuh`` holds at most 64 query
rows; ``row_plan(R)`` says how the R = kq·G rows of one (batch row, KV
head) are cut into row tiles, one more grid axis of the same launch.  The
kernel refuses a launch whose tiles differ.  These tests need no card.
"""
import inspect

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import block_attention as ba  # noqa: E402

ROWS = range(1, 4097)


def _tiles(rows):
    tiles, per = ba.row_plan(rows)
    return tiles, per, [(i * per, min(rows, (i + 1) * per))
                        for i in range(tiles)]


@pytest.mark.parametrize("chunk", range(4))
def test_row_plan_tiles_cover_every_row_once(chunk):
    for rows in ROWS[chunk::4]:
        tiles, per, spans = _tiles(rows)
        assert tiles == -(-rows // ba.MAX_ROWS), rows
        assert per % ba.ROW_ALIGN == 0 and per <= ba.MAX_ROWS, rows
        assert spans[0][0] == 0 and spans[-1][1] == rows, rows
        for (_, end), (start, _) in zip(spans, spans[1:]):
            assert end == start, rows               # contiguous, no overlap
        for start, end in spans:
            assert 0 < end - start <= ba.MAX_ROWS, (rows, start, end)


def test_row_plan_at_the_paths_rows():
    assert ba.row_plan(8) == (1, 16)          # granite kq 1 (G 4) .. 2 rows
    assert ba.row_plan(32) == (1, 32)         # granite block_k 8
    assert ba.row_plan(64) == (1, 64)         # the largest single tile
    assert ba.row_plan(72) == (2, 48)         # starcoder2 block_k 8: 48 + 24
    assert ba.row_plan(128) == (2, 64)        # stablelm 32-node tree, G 4
    assert ba.row_plan(288) == (5, 64)        # starcoder2 32-node tree, G 9


def test_row_plan_depends_on_rows_alone():
    """The plan takes the row count and nothing else, so a row's tile
    cannot depend on L or B; every wrapper launches through
    ``launch_attention``, which computes it from q's kq·G."""
    assert list(inspect.signature(ba.row_plan).parameters) == ["rows"]
    src = inspect.getsource(ba.launch_attention)
    assert "row_plan(kq * (h // pointers[0].shape[2]))[0]" in src


def test_row_plan_refuses_no_rows():
    with pytest.raises(ValueError, match="at least one row"):
        ba.row_plan(0)
