"""Work of the flash-attention forward kernel (``csrc/flash_attention.cu``)
from its launch sizes, in what its inputs need: q, k and v read once and
the output written once in their type; two products of the head size per
attended pair (scores and values), pairs counted under the causal mask
and the window."""

DTYPE_BYTES = {0: 4, 1: 2}  # the launcher's dtype codes: f32, bf16


def pairs(sq, sk, causal, window):
    """Query-key pairs attended: query i sees keys up to i + sk - sq when
    causal, the last ``window`` of them when windowed."""
    if not causal:
        return sq * sk
    total = 0
    for i in range(sq):
        hi = i + sk - sq + 1
        lo = max(hi - window, 0) if window else 0
        total += max(min(hi, sk) - lo, 0)
    return total


def flash_attention(scalars):
    """``(flops, bytes, is_bf16)`` of one launch; ``scalars`` as the
    wrapper passes them: BH, Sq, Sk, D, q_per_kv, causal, window, dtype
    code."""
    BH, Sq, Sk, D, q_per_kv, causal, window, code = scalars[:8]
    n = pairs(Sq, Sk, bool(causal), window) if (causal or window) \
        else Sq * Sk
    flops = 4 * BH * D * n
    eb = DTYPE_BYTES[int(code)]
    nbytes = eb * (2 * BH * Sq * D + 2 * (BH // q_per_kv) * Sk * D)
    return flops, nbytes, int(code) == 1
