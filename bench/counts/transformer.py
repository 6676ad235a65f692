"""Model FLOPs of a training step of the Heroes-composed decoder, from the
configuration's sizes: every projection factorized at the full width p
(x through the basis, I x R per input group, then the p^2 blocks, R x O
each), causal attention's scores and values, the output head; backward
twice the forward; no recomputation, no norms or element-wise work."""


def factorized_flops(din, dout, P, R, p):
    I, O = din // P, dout // P
    return 2 * (p * I * R + p * p * R * O)


def forward_flops_per_token(c, seq):
    d, f = c["hidden_size"], c["intermediate_size"]
    comp = c["heroes_composition"]
    P, R, p = comp["max_width"], comp["rank"], comp["width"]
    if p != P:
        raise ValueError("counted at the full width only (p == P)")
    lin = (4 * factorized_flops(d, d, P, R, p)
           + 2 * factorized_flops(d, f, P, R, p)
           + factorized_flops(f, d, P, R, p))
    # causal: a token attends (seq + 1) / 2 keys on average
    attn = 4 * d * (seq + 1) / 2
    return c["num_hidden_layers"] * (lin + attn) + 2 * d * c["vocab_size"]


def step_flops(c, batch, seq):
    """Forward and backward (3 x forward) of one step of batch x seq."""
    return 3 * batch * seq * forward_flops_per_token(c, seq)
