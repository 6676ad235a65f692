"""Attention's backward: the bf16 kernel pair ``flash_attention_bwd`` on
the card, and the replay of the plain version everywhere else.

On a CUDA card (each such test skips without one, deciding inside its
fixture): the pair's dq, dk and dv against ``torch.autograd.grad`` of
``_flash_math`` in f32 on the same bf16 inputs, over head sizes, GQA,
masks, key counts and ragged lengths; bitwise-equal gradients over two
calls; the forward's row log-sum-exp, which leaves the output bitwise as
it was and is written only when a gradient is recorded; one launch of the
pair per backward through ``kernels.ops``.

On the CPU: ``kernels.ops.flash_attention`` gives bitwise the gradients
of the plain replay (``_PlainBackward``) for f32 and bf16, and
``op_analysis.kernel_cost`` counts the pair's work by hand.
"""

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (_flash_math,
                                                 attention_mask,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.launch import op_analysis

# Tolerance of the pair against the f32 plain gradient, relative to the
# gradient's largest entry (max |got - want| <= GRAD_TOL * max |want|) and
# to its norm (|got - want| <= NORM_TOL |want|).  The inputs are the same
# bf16 values on both sides; the pair rounds to bf16 (unit roundoff 2^-9
# ~ 2e-3) P and dS as tensor-core operands, dq, dk and dv once at the
# end, and the forward's output, from which delta = dO . O is taken,
# while the reference keeps all of them in f32; every sum is f32 on both
# sides.  dS = P (dP - delta) subtracts two terms of like size, so its
# rounding error relative to dS can be a few units: a few times 2^-9
# elementwise, and less over the norm, where the operand roundings of
# many terms average out.
GRAD_TOL = 2e-2
NORM_TOL = 1e-2

# (BKV, G, Sq, Sk, D, causal, window, kv_len): every head size the model
# zoo trains with a 16-chunk instance of its own (64, 80, 128, 256) with
# and without GQA and the causal mask, at 200 positions (a multiple of no
# tile); then windows, key counts with a row of 0, fewer queries than keys,
# head sizes that are not a multiple of 8 or take two warps to a key row
CASES = [(2, g, 200, 200, d, c, 0, None)
         for d in (64, 80, 128, 256) for g in (1, 4) for c in (True, False)]
CASES += [
    (2, 2, 300, 300, 80, True, 70, None),
    (2, 1, 150, 150, 64, False, 40, None),
    (3, 2, 160, 160, 80, False, 0, (160, 0, 37)),
    (3, 1, 160, 160, 64, True, 0, (0, 100, 160)),
    (2, 1, 77, 300, 80, True, 0, None),
    (2, 2, 77, 300, 64, False, 0, (300, 129)),
    (1, 2, 130, 130, 100, True, 0, None),
    (1, 1, 96, 96, 20, True, 0, None),
    (1, 2, 140, 140, 192, True, 0, None),
]


def _case_id(c):
    BKV, G, Sq, Sk, D, causal, window, lens = c
    return (f"kv{BKV}-g{G}-q{Sq}-k{Sk}-d{D}-{'causal' if causal else 'full'}"
            + (f"-w{window}" if window else "")
            + (f"-len{'_'.join(map(str, lens))}" if lens else ""))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the backward kernel pair runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, device, seed=0, dtype=torch.bfloat16):
    BKV, G, Sq, Sk, D, causal, window, lens = case
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g).to(device=device, dtype=dtype)

    q, k, v = rn(BKV * G, Sq, D), rn(BKV, Sk, D), rn(BKV, Sk, D)
    dout = rn(BKV * G, Sq, D)
    kv_len = (None if lens is None else
              torch.tensor(lens, dtype=torch.int32, device=device))
    return q, k, v, dout, dict(causal=causal, window=window, q_per_kv=G,
                               kv_len=kv_len)


def _reference(q, k, v, dout, kw):
    """The f32 gradient of the plain version on the same (bf16) values."""
    xs = [t.float().requires_grad_() for t in (q, k, v)]
    out = _flash_math(*xs, kw["causal"], kw["window"], kw["q_per_kv"],
                      kw["kv_len"])
    return torch.autograd.grad(out, xs, dout.float())


def _pair(q, k, v, dout, kw):
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    return flash_attention_bwd(q, k, v, out, dout, lse, **kw)


def _assert_close(got, want, what):
    err = (got.float() - want).abs()
    scale = float(want.abs().max())
    assert float(err.max()) <= GRAD_TOL * scale + 1e-6, (
        what, float(err.max()), scale)
    assert float(err.norm()) <= NORM_TOL * float(want.norm()) + 1e-6, (
        what, float(err.norm()), float(want.norm()))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_pair_matches_the_plain_gradient(card, case):
    q, k, v, dout, kw = _inputs(case, card)
    got = _pair(q, k, v, dout, kw)
    want = _reference(q, k, v, dout, kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _assert_close(a, b, name)
    lens = kw["kv_len"]
    if lens is not None:  # keys past a row's count, and a row of 0: zeros
        dq, dk, dv = got
        G = kw["q_per_kv"]
        for r, n in enumerate(lens.tolist()):
            assert not dk[r, n:].any() and not dv[r, n:].any()
            if n == 0:
                assert not dq[r * G:(r + 1) * G].any()


def _seen(kw, Sq, Sk, BKV, device):
    """(BH, Sq) bool: the query rows that see some key under kw's masks."""
    mask = attention_mask(Sq, Sk, kw["causal"], kw["window"], device)
    mask = mask.expand(BKV, Sq, Sk)
    if kw["kv_len"] is not None:
        mask = mask & (torch.arange(Sk, device=device)
                       < kw["kv_len"][:, None, None])
    return mask.any(-1).repeat_interleave(kw["q_per_kv"], 0)


# rows that see no key although their KV row has some: causal queries
# before the first key (Sq > Sk), a window wholly past a row's count
# (causal, and non-causal with GQA)
EMPTY_ROW_CASES = [
    (2, 2, 150, 100, 80, True, 0, None),
    (2, 1, 200, 200, 64, True, 30, (200, 60)),
    (1, 2, 160, 160, 128, False, 20, (50,)),
]


@pytest.mark.parametrize("case", EMPTY_ROW_CASES, ids=_case_id)
def test_rows_that_see_no_key_give_zeros(card, case):
    """A query that sees no key gets a zero output from the forward, as a
    row of count 0 does, and so zero dq, and it gives no dk or dv: the
    pair matches the plain gradient with that row's dout left out."""
    q, k, v, dout, kw = _inputs(case, card, seed=6)
    seen = _seen(kw, q.shape[1], k.shape[1], k.shape[0], card)
    assert not seen.all()
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    assert not out[~seen].any()
    got = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert not got[0][~seen].any()
    want = _reference(q, k, v, dout * seen[..., None], kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_close(a, b, name)


def test_pair_is_deterministic(card):
    case = (4, 4, 512, 512, 80, True, 0, None)
    q, k, v, dout, kw = _inputs(case, card, seed=1)
    first = _pair(q, k, v, dout, kw)
    for _ in range(2):
        for a, b in zip(first, _pair(q, k, v, dout, kw)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", [CASES[2], CASES[16], CASES[18]],
                         ids=_case_id)
def test_lse_is_bitwise_neutral(card, dtype, case):
    q, k, v, _, kw = _inputs(case, card, seed=2, dtype=dtype)
    plain = flash_attention(q, k, v, **kw)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    assert torch.equal(plain, out)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    # the row log-sum-exp of the masked, scaled scores (f32 on both sides)
    BKV, Sk = k.shape[:2]
    G, Sq, D = kw["q_per_kv"], q.shape[1], q.shape[2]
    s = torch.einsum("bgqd,bkd->bgqk", q.float().view(BKV, G, Sq, D),
                     k.float()) * D ** -0.5
    mask = attention_mask(Sq, Sk, kw["causal"], kw["window"], card)
    if kw["kv_len"] is not None:
        mask = mask & (torch.arange(Sk, device=card)
                       < kw["kv_len"][:, None, None, None])
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)
    seen = mask.expand_as(s).any(-1).reshape(-1, Sq)
    err = (lse - want.reshape(-1, Sq)).abs()[seen]
    assert float(err.max()) <= 1e-4 * (1 + float(want.abs().max()))


def test_ops_launches_the_pair_once_a_backward(card):
    """Model layout through ``kernels.ops``: a recorded bf16 forward writes
    the log-sum-exp and its backward launches the pair once (no replay);
    a forward alone passes a null log-sum-exp; f32 keeps the replay."""
    B, S, KV, G, D = 2, 192, 2, 2, 80
    g = torch.Generator(device="cpu").manual_seed(3)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(card, dtype)

    q, k, v = rn(B, S, KV, G, D), rn(B, S, KV, D), rn(B, S, KV, D)
    dout = rn(B, S, KV, G, D)
    seen = []

    def hook(name, tensors, scalars):
        if name == "flash_attention":
            seen.append(tensors[5] is not None)

    K.LAUNCH_HOOKS.append(hook)
    try:
        K.reset_launches()
        with torch.no_grad():
            ops.flash_attention(q, k, v)
        assert seen == [False]
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*xs)
        out.backward(dout)
        assert seen == [False, True]
        assert K.LAUNCHES["flash_attention"] == 2
        assert K.LAUNCHES["flash_attention_bwd"] == 1
        qf = q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, S, D)
        kf = k.permute(0, 2, 1, 3).reshape(B * KV, S, D)
        vf = v.permute(0, 2, 1, 3).reshape(B * KV, S, D)
        df = dout.permute(0, 2, 3, 1, 4).reshape(B * KV * G, S, D)
        want = _reference(qf, kf, vf, df, dict(causal=True, window=0,
                                               q_per_kv=G, kv_len=None))
        got = (xs[0].grad.permute(0, 2, 3, 1, 4).reshape(qf.shape),
               xs[1].grad.permute(0, 2, 1, 3).reshape(kf.shape),
               xs[2].grad.permute(0, 2, 1, 3).reshape(vf.shape))
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _assert_close(a, b, f"ops {name}")
        K.reset_launches()
        xs = [t.float().requires_grad_() for t in (q, k, v)]
        ops.flash_attention(*xs).backward(dout.float())
        assert K.LAUNCHES["flash_attention_bwd"] == 0
        assert seen[-1] is False
    finally:
        K.LAUNCH_HOOKS.remove(hook)


def test_pair_backward_runs_in_the_attention_span(card):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import spans
    g = torch.Generator(device="cpu").manual_seed(4)
    xs = [torch.randn(shape, generator=g).to(card, torch.bfloat16)
          .requires_grad_() for shape in ((2, 128, 2, 1, 64),
                                          (2, 128, 2, 64), (2, 128, 2, 64))]
    out = ops.flash_attention(*xs)
    spans.reset()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out.backward(torch.ones_like(out))
    tot = spans.totals()
    assert tot["plain_backward.flash_attention"]["calls"] == 1
    assert tot["plain_backward.flash_attention"]["device_ms"] > 0
    assert K.LAUNCHES["flash_attention_bwd"] == 1


# --------------------------------------------------------------------------
# the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window,lens", [
    (True, 0, None), (False, 0, (9, 0)), (True, 3, None)],
    ids=["causal", "kv_len", "window"])
def test_cpu_gradients_are_the_replays(dtype, causal, window, lens):
    """On the CPU every dtype keeps the replay of the plain version: the
    gradients of ``ops.flash_attention`` are bitwise those of
    ``_PlainBackward`` over the kernel wrapper and ``_flash_math``."""
    B, S, KV, G, D = 2, 9, 1, 2, 8
    g = torch.Generator().manual_seed(5)
    q = torch.randn(B, S, KV, G, D, generator=g).to(dtype)
    k = torch.randn(B, S, KV, D, generator=g).to(dtype)
    v = torch.randn(B, S, KV, D, generator=g).to(dtype)
    dout = torch.randn(B, S, KV, G, D, generator=g).to(dtype)
    kv_len = None if lens is None else torch.tensor(lens)

    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*xs, causal=causal, window=window,
                        kv_len=kv_len).backward(dout)
    got = [x.grad for x in xs]

    flat = [t.clone().requires_grad_() for t in (
        q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, S, D),
        k.permute(0, 2, 1, 3).reshape(B * KV, S, D),
        v.permute(0, 2, 1, 3).reshape(B * KV, S, D))]
    kw = dict(causal=causal, window=window, q_per_kv=G)
    if kv_len is not None:
        kw["kv_len"] = kv_len.to(torch.int32)
    out = ops._PlainBackward.apply(ops.flash_attention_kernel, _flash_math,
                                   kw, *flat)
    out.backward(dout.permute(0, 2, 3, 1, 4).reshape(out.shape))
    want = (flat[0].grad.reshape(B, KV, G, S, D).permute(0, 3, 1, 2, 4),
            flat[1].grad.reshape(B, KV, S, D).permute(0, 2, 1, 3),
            flat[2].grad.reshape(B, KV, S, D).permute(0, 2, 1, 3))
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


def test_lse_is_the_kernels():
    q = torch.randn(2, 4, 8)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention(q, q, q, with_lse=True)


@pytest.mark.parametrize("lens,pairs", [(None, 2 * 10), ((4, 2), 10 + 7)])
def test_kernel_cost_of_the_pair(lens, pairs):
    """Five products of the head size a visible pair (10 D FLOPs), and
    the bytes of q, k, v, out, dout, lse, dq, dk, dv (and the key counts),
    the f32 delta scratch left out."""
    BH, BKV, S, D = 8, 2, 4, 16
    q, kv = torch.empty(BH, S, D), torch.empty(BKV, S, D)
    row = torch.empty(BH, S)
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    # causal 4 x 4 is 10 pairs a row; counts 4 and 2 see 10 and 3 + 4 = 7
    flops, nbytes = op_analysis.kernel_cost(
        "flash_attention_bwd",
        (q, kv, kv, q, q, row, row, q, kv, kv, kv_len),
        (BH, S, S, D, BH // BKV, 1, 0, 0))
    assert flops == 10 * D * (BH // BKV) * pairs
    assert nbytes == 4 * (4 * q.numel() + 4 * kv.numel() + row.numel()) + (
        0 if lens is None else 4 * len(lens))
    # the forward counts the log-sum-exp it writes too
    _, fwd = op_analysis.kernel_cost(
        "flash_attention", (q, kv, kv, q, None, row),
        (BH, S, S, D, BH // BKV, 1, 0, 0))
    assert fwd == 4 * (2 * q.numel() + 2 * kv.numel() + row.numel())
