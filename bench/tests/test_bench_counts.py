"""The yardstick's arithmetic against counts worked by hand, two small
shapes each."""

import pytest

from counts import attention, peaks, transformer
import devtrace


@pytest.mark.parametrize("sq,sk,causal,window,n", [
    (4, 4, True, 0, 10), (4, 4, True, 2, 7), (2, 4, True, 0, 7),
    (3, 5, False, 0, 15)])
def test_attention_pairs(sq, sk, causal, window, n):
    assert attention.pairs(sq, sk, causal, window) == n


@pytest.mark.parametrize("scalars,want", [
    ((2, 4, 4, 8, 1, 1, 0, 1), (640, 512, True)),     # bf16, causal
    ((4, 2, 3, 4, 2, 0, 0, 0), (384, 448, False)),    # f32, GQA 2
])
def test_flash_attention(scalars, want):
    assert attention.flash_attention(scalars) == want


def test_transformer_counts():
    c = {"hidden_size": 4, "intermediate_size": 8, "vocab_size": 10,
         "num_hidden_layers": 1,
         "heroes_composition": {"max_width": 2, "rank": 2, "width": 2}}
    assert transformer.factorized_flops(4, 4, 2, 2, 2) == 48
    assert transformer.factorized_flops(4, 8, 2, 2, 2) == 80
    assert transformer.factorized_flops(8, 4, 2, 2, 2) == 64
    assert transformer.forward_flops_per_token(c, 3) == 416 + 32 + 80
    assert transformer.step_flops(c, 1, 3) == 3 * 3 * 528
    c2 = dict(c, num_hidden_layers=2,
              heroes_composition={"max_width": 1, "rank": 2, "width": 1})
    # P = p = 1: (4, 4) 2*(4*2 + 2*4), (4, 8) 2*(4*2 + 2*8),
    # (8, 4) 2*(8*2 + 2*4); attention 4*4*1; head 2*4*10
    assert transformer.forward_flops_per_token(c2, 1) == \
        2 * (4 * 32 + 2 * 48 + 48 + 16) + 80
    with pytest.raises(ValueError):
        transformer.forward_flops_per_token(
            dict(c, heroes_composition={"max_width": 2, "rank": 2,
                                        "width": 1}), 3)


def test_peaks():
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)
    assert peaks.bound_s(989e12, 0, peaks.PEAK_BF16_FLOPS) == \
        pytest.approx(1.0)


def test_union_and_gaps():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert devtrace.union_length(ivs) == pytest.approx(3.0)
    assert devtrace.gaps(ivs, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert devtrace.union_length([(1.0, 2.0), (1.2, 1.4)]) == \
        pytest.approx(1.0)
    assert devtrace.gaps([(1.0, 2.0)], 0.0, 2.0) == [(0.0, 1.0)]


def test_summarize_names_gaps_by_host_activity():
    kernels = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("k1", 3.0, 4.0)]
    host = [("bench.window", 0.0, 5.0), ("plan", 1.9, 3.1),
            ("eval", 3.9, 5.0)]
    s = devtrace.summarize(kernels, host, 0.0, 5.0)
    assert s["busy_s"] == pytest.approx(3.0)
    assert s["window_s"] == pytest.approx(5.0)
    assert s["breakdown"]["device_ops"] == [["k1", 2.0], ["k2", 1.5]]
    assert s["breakdown"]["idle_gaps"] == [["plan", 1.0], ["eval", 1.0]]
