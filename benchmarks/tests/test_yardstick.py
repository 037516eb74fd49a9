"""The frozen counts give the bounds of the kernel table in PERF.md."""

import pytest

from harness import yardstick as Y


@pytest.mark.parametrize("m, d, backward, stash, want", [
    (1000, 10240, False, True, 0.1528),  # K2, the no-kl stress MMD
    (1000, 640, False, False, 0.0097),  # K1, the kl MMD on encodings
    (1000, 640, True, False, 0.0288),  # K3
    (1000, 10240, False, False, 0.1528),  # K1 at the panel fit's width
])
def test_gram_bounds(m, d, backward, stash, want):
    assert round(Y.gram_bound_ms(m, d, backward, stash), 4) == want


def test_knn_bound_of_the_stress_ensemble():
    # 500 masks keeping 2,444,111 columns of 10240; 500 test x 2000 train rows
    assert round(Y.knn_bound_ms(2_444_111, 500, 500, 2000, 10240), 4) == 73.1484


def test_bounds_are_by_operations_at_these_shapes():
    assert Y.bound_ms(Y.gram_ops(1000, 10240), Y.gram_bytes(1000, 10240, stash=True))[1] == \
        "operations"
    assert Y.bound_ms(Y.knn_ops(2_444_111, 500, 500, 2000), Y.knn_bytes(500, 500, 2000, 10240))[1] \
        == "operations"


def test_step_flops_of_the_stress_shape():
    # 6 x 500 x 69.63 M multiply-adds, less the noise's gradient, plus the MMD
    gen_macs = sum(i * o for i, o in Y.generator_layers(10240))
    assert gen_macs == 69_632_000
    assert Y.no_kl_step_flops(500, 10240) == pytest.approx(
        2 * 500 * gen_macs * 2 + 2 * 500 * (gen_macs - 640 * 1280) + Y.gram_ops(1000, 10240, True))
    assert Y.sym_pairs(1000) == 499_500
    assert Y.PEAK_F32_FLOPS == 67e12 and Y.PEAK_BYTES_PER_S == 3.35e12
    assert Y.PEAK_BF16_FLOPS == 989e12 and Y.OPS_PER_ENTRY == 20
