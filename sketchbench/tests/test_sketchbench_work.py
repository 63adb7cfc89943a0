"""The yardstick's counts against numbers worked out by hand."""
import pytest

from sketchbench import work


def test_main_plan_sketch_bytes_and_bound():
    # A: 65 536 x 1 024 fp32 = 268 435 456 B; Y: 4 096 x 1 024 fp32 =
    # 16 777 216 B
    nbytes = work.sketch_bytes(65536, 1024, 4096)
    assert nbytes == 285_212_672
    flops = work.sketch_flops(65536, 1024, 4, 2)
    assert flops == 1_073_741_824
    # memory-bound: 285 212 672 B / 3.35 TB/s = 85.14 us; 1.07 GFLOP at
    # 67 TFLOP/s is 16.0 us
    assert work.least_seconds(nbytes, flops) * 1e6 == pytest.approx(
        85.138111, abs=1e-6)


def test_grass_counts():
    dims = (784, 128, 64, 10)
    # 109 386 parameters: 109 184 weights and 202 biases
    assert work.mlp_weights(dims) == 109_184
    # a chunk of 1 024 examples: 1 024 x (4 096 + 1 024) x 4 B
    assert work.gather_bytes(1024, 4096, 1024) == 20_971_520
    assert work.gather_bytes(1024, 4096, 1024) / work.HBM_BYTES_PER_S \
        * 1e6 == pytest.approx(6.2602, abs=1e-4)
    # 6 flops a weight and 2 kappa s flops a kept coordinate
    assert work.grass_example_flops(dims, 4096, 4, 2) == \
        6 * 109_184 + 2 * 8 * 4096


def test_least_seconds_takes_the_longer_roofline():
    assert work.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert work.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)
