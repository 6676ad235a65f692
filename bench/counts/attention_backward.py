"""Work of attention's backward kernel pair (``csrc/flash_attention_bwd.cu``)
from its launch sizes, in what its data needs: q, k, v, the output, its
gradient and the forward's row log-sum-exp read once, dq, dk and dv
written once (the f32 scratch of each row's delta is left out); five
products of the head size per attended pair (S and dP recomputed, dV, dK
and dQ: the exact softmax gradient), pairs counted as the forward's
(``counts/attention.py``).  A design that computes more than that, as
the pair does by recomputing S and dP in each of its two passes, reads
lower, never over 100 %."""

from counts.attention import DTYPE_BYTES, pairs


def flash_attention_backward(scalars):
    """``(flops, bytes, is_bf16)`` of one launch; ``scalars`` as the
    wrapper passes them, the forward's: BH, Sq, Sk, D, q_per_kv, causal,
    window, dtype code."""
    BH, Sq, Sk, D, q_per_kv, causal, window, code = scalars[:8]
    n = pairs(Sq, Sk, bool(causal), window) if (causal or window) \
        else Sq * Sk
    flops = 10 * BH * D * n
    eb = DTYPE_BYTES[int(code)]
    nbytes = eb * (4 * BH * Sq * D + 4 * (BH // q_per_kv) * Sk * D) \
        + 4 * BH * Sq
    return flops, nbytes, int(code) == 1
