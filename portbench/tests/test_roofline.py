"""K1's operation and byte counts against shapes, and the share bounded by 100%."""

import pytest

from portbench import roofline


def test_counts_follow_the_valid_rows_and_columns():
    assert roofline.k1_flops(1000, 2000, 128) == 2 * 1000 * 2000 * 128
    assert roofline.k1_flops(0, 4096) == 0
    b = roofline.k1_bytes(1000, 2000, 128, 4096, 4096)
    assert b == 4 * 128 * 3000 + 8192 + 9 * 1000
    # Doubling the valid rows doubles the cross-term work.
    assert roofline.k1_flops(2000, 2000) == 2 * roofline.k1_flops(1000, 2000)


def test_main_path_shape_is_bound_by_operations():
    t, what = roofline.k1_bound_s([(4096, 4096, 128, 4096, 4096)])
    assert what == "operations"
    assert t == pytest.approx(2 * 4096 ** 2 * 128 / 67e12)  # 64.1 us
    t1, what1 = roofline.k1_bound_s([(1, 1, 128, 4096, 4096)])
    assert what1 == "bytes"


@pytest.mark.parametrize("rows,cols", [(700, 800), (4096, 4096), (1, 4096), (0, 0)])
@pytest.mark.parametrize("slack", [1.0, 1.5, 30.0])
def test_share_of_a_time_no_shorter_than_the_bound_stays_within_100(rows, cols, slack):
    launches = [(rows, cols, 128, 4096, 4096)] * 3
    bound, _ = roofline.k1_bound_s(launches)
    share = roofline.share_percent(bound, bound * slack)
    assert 0.0 <= share <= 100.0
    assert roofline.share_percent(bound, 0.0) is None
