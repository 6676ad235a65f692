"""Attention's backward roofline (``counts/attention_backward.py``,
``metrics/flash_attention_backward_roofline.py``) against counts worked
by hand."""

import pytest

from conftest import BENCH, harness
from counts import attention_backward
from counts.peaks import PEAK_BF16_FLOPS, bound_s


@pytest.mark.parametrize("scalars,want", [
    # bf16, causal 4 x 4: 10 pairs, 10 * 2 rows * 8 * 10 FLOPs; q, out,
    # dout, dq 4 * 2 * 4 * 8 and k, v, dk, dv the same, 2 bytes each, and
    # lse 4 bytes a row
    ((2, 4, 4, 8, 1, 1, 0, 1), (1600, 1056, True)),
    # non-causal Sq 2 < Sk 3, GQA 2: 6 pairs; 4 * 4 * 2 * 4 + 4 * 2 * 3 * 4
    # elements and 4 * 2 lse values
    ((4, 2, 3, 4, 2, 0, 0, 1), (960, 480, True)),
    # causal with a window of 2: 7 pairs
    ((1, 4, 4, 2, 1, 1, 2, 1), (140, 144, True)),
])
def test_flash_attention_backward(scalars, want):
    assert attention_backward.flash_attention_backward(scalars) == want


def _ctx(records, kernels):
    return {"trace": {"kernels": kernels}, "launch_records": records}


def test_share_reads_the_pair_alone():
    reader = harness.load_module(
        BENCH / "metrics" / "flash_attention_backward_roofline.py",
        "bench_metric_flash_attention_backward_roofline")
    fwd = harness.load_module(
        BENCH / "metrics" / "flash_attention_roofline.py",
        "bench_metric_flash_attention_roofline")
    sc = (64, 4096, 4096, 80, 1, 1, 0, 1)
    kernels = [("void flash_bwd_dq_kernel<5>(...)", 0.0, 1e-3),
               ("void flash_bwd_dkdv_kernel<5>(...)", 1e-3, 3e-3),
               ("void flash_mma_kernel<5>(...)", 3e-3, 3.5e-3)]
    ctx = _ctx([("flash_attention", sc), ("flash_attention_bwd", sc)],
               kernels)
    flops, nbytes, _ = attention_backward.flash_attention_backward(sc)
    # 64 * 80 * 10 * 4096 * 4097 / 2 FLOPs: about 0.43 ms at the peak
    assert flops == 10 * 64 * 80 * (4096 * 4097 // 2)
    assert reader.read(ctx) == pytest.approx(
        100 * bound_s(flops, nbytes, PEAK_BF16_FLOPS) / 3e-3)
    # the forward's share still times the forward's kernel alone
    assert fwd.read(ctx) == pytest.approx(
        100 * bound_s(4 * 64 * 80 * (4096 * 4097 // 2), 2 * 4 * 64 * 4096
                      * 80, PEAK_BF16_FLOPS) / 0.5e-3)
    # a program whose backward is a replay launches no pair: no reading
    assert reader.read(_ctx([("flash_attention", sc)], kernels[2:])) is None
