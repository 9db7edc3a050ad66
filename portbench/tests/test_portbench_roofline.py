"""The yardstick's counts reproduce the bounds the port's kernel table
quotes (PERF.md, K1 and K2 rows)."""

import pytest

from portbench.harness import roofline


def test_k1_gram_config4():
    ms, by = roofline.bound_ms(*roofline.k1(1, 16384, 16384, 8, gram=True))
    assert by == "bytes"
    assert ms == pytest.approx(0.3207, abs=5e-5)


def test_k2_config5():
    ms, by = roofline.bound_ms(*roofline.k2(8192, 64))
    assert by == "bytes"
    assert ms == pytest.approx(0.06041, abs=5e-6)


def test_k3_and_trsm_bounds_by_operations():
    assert roofline.bound_ms(*roofline.k3(2, 512))[1] == "operations"
    ms, by = roofline.bound_ms(*roofline.trsm(16384, 8192))
    assert by == "operations"
    assert ms == pytest.approx(16384 * 16384 * 8192 / 67e12 * 1e3)


def test_step_counts_are_cubic():
    n, d, p = 16384, 8, 9
    vg = roofline.lml_vg_flops(n, d, p)
    assert n ** 3 < vg < 1.01 * n ** 3
    assert n ** 3 / 3 < roofline.lml_value_flops(n, d, p) < 1.01 * n ** 3 / 3
    assert roofline.serve_point_flops(n, d, p) > n * n


def test_share_is_none_without_device_time():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 0.002) == pytest.approx(50.0)
