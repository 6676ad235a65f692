#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It

1. builds the eight CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel), prints the build seconds, the attention and
   SSD-chunk libraries' tensor-core instruction counts and the card's
   name and power limit, and turns TF32 off for matmuls and convolutions;
2. holds every kernel against its plain PyTorch version on the card: the
   four composition kernels at the CNN's shapes for widths p = 1, 2, 3
   (all three composition modes, strides 1 and 2, compose with a client
   axis C = 4 and 10), at the composed transformer's, and at their edges
   (odd and 32x32 images, C = 3, ragged row and column tiles, M up to
   1000, D 6 to 96, ragged m*O, rank 6, tiles past 48 KB, compose_apply's
   weight tile in chunks; the (y, t) pairs of rank_apply and
   compose_apply), forward and gradient through each autograd Function,
   and the fused head's no-grad forward (one compose_apply launch, no
   GEMM beside it) and the t its recorded forward saves; conv_rank,
   rank_apply and compose_apply on a leading client axis C = 1, 3, 4, 10
   at every CNN layer, mode and width, ragged tiles and path (e)'s widest
   call (the y, t pairs too), and each composition Function under
   ``torch.func.vmap`` over 3 and 10 clients, forward and gradient,
   launching its kernel once per call with and without a graph; the
   four at the shapes of paths (k) and (l) (the residual net's square
   stride-1 convs and grow_out stem on 32x32 images, the RNN's wx and
   out over 512 token rows, the composes of its wh, embedding and head;
   also with a client axis C = 4), forward and gradient, and
   ``decompose`` on the card against the CPU; the
   two attention kernels in f32 and bf16, element-wise, at the
   transformer path's shapes, the reference's sweep shapes, head dims 80
   and 256 over several KV tiles, a query group of 8 over uneven key
   splits with ragged lengths down to 0, flash with fewer and more
   queries than keys (non-causal first, then causal) and with a key
   count a row (``kv_len`` 0, 1, inside a tile, a tile edge and every
   key), and in model layout through
   ``kernels.ops``, there also at every call shape of paths (p), (q),
   (r), (t) and (u) (each config's prefill and decode, gemma's windowed
   forward, ring, int8 and training calls, olmoe's training, the step
   checks' forwards and the f32 layers' against the CPU; seamless's
   non-causal encoder, its cross-attention's queries over the memory at
   ragged counts, decode over the memory, filled and unfilled); compose
   at the zoo's compose-then-matmul shapes; rmsnorm at
   those paths' rows and widths and the xLSTM's (768, 1536); rmsnorm
   and ssd_chunk in f32 and
   bf16, element-wise,
   at zamba2's path shapes, the reference's sweep shapes, with ``heads >
   1``, at every width of the zoo's rmsnorm configs and widths the
   one-pass kernel does not take, and at every instance and edge of the
   bf16 ssd_chunk kernel (a gentle decay, N up to 128, Q from 1 to 1024).
   It times kernel, plain version and, where one PyTorch call computes
   the same function, that call (the port never calls it), at the main
   path's widest shapes (conv_rank also at conv1 and on 32x32 images,
   rank_apply also at path (e)'s widest call, compose also at the fc
   layer, path (e)'s up projection and a 10-client cohort stack,
   compose_apply also at the calibration's head and a wide grow_in shape
   no path runs it at; conv_rank, rank_apply and compose_apply also on
   cohorts of 4 and 10 clients at the conv2 and fc shapes) beside
   the device time of an empty launch, each call's host cost
   (``call_ms``), and, for the attention, rmsnorm and ssd_chunk
   kernels, at one realistic shape each over ``BIG_ITERS`` eager calls
   (flash also at path (g)'s own call, decode also through
   ``kernels.ops`` on the model layout, rmsnorm also at path (g)'s
   decode shapes; flash, decode and rmsnorm also at path (p)'s own
   prefill and decode calls on gemma-2b; flash at path (u)'s encoder
   and cross prefill, decode at its cross decode, compose at its
   attention projection);
3. drives the port's main paths, with the launch counts set to 0 just
   before each and read just after, each checked against the same run on
   the CPU (the plain versions, which the CPU tests hold to the JAX
   package) — ``run_scheme``-style runs of 3 rounds on
   ``build_image_setup(num_clients=10)``, 4 clients per round, host merge:
   (a) heroes/materialize, (b) heroes/rank_space, (c) heroes/auto with the
   calibration pinned, (d) fedavg; (e) the composed transformer on
   ``build_text_setup(num_clients=8)``: heroes/rank_space and fedavg for
   3 rounds, then greedy-decode serving of the heroes weights at widths
   1, 2, 3; (f) ``kernels.ops.flash_attention`` / ``decode_attention`` at
   a GQA shape; (g) the model zoo's serving path on zamba2-2.7b at full
   width and depth (bf16 compute): a 4 x 512 prefill held against
   step-by-step ``serve_step``, then ``launch/serve.py``'s loop at its
   defaults; one superblock in f32 held against the CPU; and one
   ``loss_fn`` backward on the smoke config in f32, held against the
   CPU's, with no forward-only kernel launched while it records; (h) the
   paper's scheme comparison under ``FLConfig``'s defaults (the
   ``"collective"`` merge backend): fedavg, adp, heterofl, flanc, fedprox
   and heroes for 3 rounds on the 10-client CNN setup with path (c)'s
   pins, each held against the CPU, with merge milliseconds per round and
   the to-accuracy metrics; flanc and heroes must launch compose and
   conv_rank, the dense schemes nothing; (i) heroes and fedavg with
   ``round_mode="semi_async"`` (4 events, the fastest 2 of 4 in flight,
   at least one merging a stale client) and a sample-weighted heroes run
   on 8 clients of unequal shards, checked as (h); (j) the cohort trainer
   (``trainer="cohort"``): heroes materialize, heroes pinned auto and
   fedavg with 4 clients a round, pinned-auto heroes with all 10, and the
   composed transformer's heroes rank_space, each beside the same run
   with the sequential trainer on the card (fedavg's whole history and
   heroes' first ``train_all`` held to it) and held against the CPU; each
   composition kernel's training launches must equal one per layer per
   forward of each cohort group (its largest τ, 2 loss forwards and 4
   gradient evaluations for schemes that ship estimates), fewer than the
   sequential trainer's where a group holds several clients; (k) the
   residual net on ``cifar10`` (``build_image_setup(model_name="resnet",
   task="cifar10", num_clients=10)``, the loader's synthetic fallback at
   32x32x3): heroes materialize, rank_space and pinned auto, and fedavg;
   (l) the RNN on ``shakespeare`` (``build_text_setup(task=
   "shakespeare", num_clients=10)``, the fallback's 16 speakers under
   the natural partition): Fig. 9's fedavg, flanc and heroes
   (rank_space) and heroes materialize; 3 rounds of 4 clients each, then
   (k)'s pinned auto and (l)'s rank_space heroes with the cohort
   trainer beside the sequential run; each run's composition launches
   must equal the formula (one client at a time, or a group at a time),
   each run is held against the CPU (the RNN's, whose local SGD
   amplifies rounding, in its schedule, round 1 at the shipped weights
   and the card's weights scored on the CPU), and
   ``build_text_setup()`` must resolve the RNN; (k) also runs the
   ROADMAP C.10 experiment (heroes pinned auto and fedavg, twice
   sequential and once cohort, with cuDNN's defaults and under
   ``cudnn.deterministic``); (m) heroes over a virtual population of a
   million clients (``build_setup(population=1_000_000)``, availability
   participation, two edge groups, the cohort trainer, path (c)'s pins,
   a checkpoint every round) under ``cudnn.deterministic``: 4 rounds
   uninterrupted, the same stopped after round 2 and continued by a new
   process (``chip_smoke.py resume ...``) from the checkpoint, semi-async
   events at the million (uniform, rejection-sampled) resumed the same way
   with results in flight, and ``run_until_budget`` at round 2's wall;
   the resumed runs must equal the uninterrupted ones bit for bit, the
   schedule and participation the CPU run's, the edge partials recombine
   to the merged state; (n) the dataset smoke
   (``repro_torch.data.smoke.main([])``, one cohort heroes round per
   loader), each loader's accuracy within 2 test samples of the CPU's;
   (o) telemetry (``telemetry="jsonl"``) under ``cudnn.deterministic`` on
   3 rounds of heroes sequential with a checkpoint every round, heroes
   cohort with all 10 clients a round and fedavg semi-async (path (c)'s
   pins, FLConfig's default merge), each beside the same run with
   telemetry off (5 pairs, alternating which runs first): the log
   validates, its trace export loads back, the history, final weights
   and launch counts equal the off run's bit for bit, the virtual spans
   and traffic counters the CPU run's; it prints the report, the median
   s/round on and off, each round's split into its wall
   spans (trainer, host staging, device step, merge, checkpoint), that
   of a fifth run with the engine's assign, train_all and evaluate timed
   too, and each save's two halves (the state to the host, the write);
   (p) the zoo's dense family on gemma-2b at full width and depth (bf16
   compute): a 4 x 512 prefill held against step-by-step
   ``serve_step``, the sliding-window variant (a ring of 16 slots,
   teacher-forced past its wraps, against the windowed forward, and a
   ring one slot too wide and one with a stale slot, which that check
   must fail), the
   int8 KV cache (within the reference's 5 % of the bf16 cache), 3 AdamW
   steps of the training launcher's step function on the full model
   (the loss falls, flash attention and rmsnorm launch in every
   forward), ``launch/serve.py``'s ``main`` at its defaults (which must
   serve gemma-2b), one layer in f32 against the CPU, and the training
   step on one layer in f32 against the CPU's; (q) stablelm-3b at full
   depth, deepseek-coder-33b and granite-34b at full width and 8 layers
   (one card holds neither's 62 or 88 f32 layers): each a prefill held
   against ``serve_step`` and ``launch/serve.py``'s loop; deepseek must
   launch rmsnorm, the LayerNorm archs none; (r) the MoE family:
   olmoe-1b-7b at full width and depth (f32 params) and kimi-k2-1t-a32b
   at full width with its bf16 params and 2 layers (its first_k_dense
   layer and one MoE layer of 384 experts, drawn in chunks), each a
   prefill, ``serve_step`` held against the forward in the no-drop
   regime with the tokens whose top-k experts flip between the two
   counted and left out, and ``launch/serve.py``'s loop; olmoe's training
   at 4 layers (the loss, aux loss included, falls); each arch's first
   MoE layer in f32 against the CPU at the default capacity, held on the
   tokens whose expert sets agree; (s) xlstm-125m at full size: prefill
   (its mLSTM and sLSTM layers timed apart), ``serve_step`` against it,
   the loop, 3 AdamW steps and one superblock against the CPU; rmsnorm
   launches, the attention kernels never; (t) qwen2-vl-7b at full size:
   prefill and the step check on M-RoPE positions whose t, h and w ids
   differ (a patch grid, then text), the loop, one layer against the CPU
   on such positions; (u) seamless-m4t-medium at full size (the audio
   family: 12 encoder and 12 decoder layers over stub frame embeddings):
   a 4 x 512 prefill over 4 x 4096 frames of ragged valid length, the
   memory prefilled into the cache and ``serve_step`` held against the
   forward, the launches of one prefill (flash, 36) and one step
   (decode, 24) against the formula, the loop, 3 AdamW steps, one
   encoder and one decoder layer in f32 against the CPU, and the same
   two layers with composition on, compose-then-matmul (16 compose
   launches) against the factorized forward; (r)-(u)'s step checks also
   hold the argmax to the
   forward's at 0.9 of positions, and each path launches exactly the
   zoo kernels its family has; (g) and (p)-(u) each trace a prefill and
   4 serve steps; (v) step 9's multi-device part over logical shards of
   the card (``sharding.fl.logical_devices``): (v0) the merge over 8
   shards against the host rule and a trainer stack's hand-off, whole
   and as a fastest-K subset; (v1) fedavg, heterofl, flanc and heroes on
   the JAX package's ENGINE_SCRIPT schedule merged over 4 shards against
   the host rules; (v2) heroes cohort with ``shard_server_state`` on 3
   shards against one shard (coefficients in 3 slices, launches 3 times
   the one-shard formula); (v3) an odd cohort against one shard; (v4)
   fastest-K semi-async against the host rules; (v5) olmoe-1b-7b's MoE
   layer through ``apply_moe_shardmap`` on a 2 x 4 grid against
   ``moe.apply_moe``;
4. traces one round of (c) with ``torch.profiler`` (device busy share,
   top kernels), with the sequential trainer and 4 clients and with the
   cohort trainer and 10, and prints the calibration
   ``core.calibration.measure``
   takes with no pins and the per-layer impls ``auto`` then picks;
5. prints the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result.  Without a CUDA device, or outside a checkout, it exits 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FFMA FLOP/s and
# dense bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

DENSE_TOL = 2e-5  # compose / rank_apply / compose_apply, f32 FFMA sums
CONV_TOL = 2e-4   # conv_rank: k*k*I-term sums, as in the CPU tests
GRAD_TOL = 1e-4   # gradients: the backward is plain PyTorch on both sides
CONV_GRAD_TOL = 5e-4  # conv gradients sum over every output pixel
# attention kernels, held element-wise as (atol, rtol) against their plain
# versions (which round p to v's type as the kernels do): in f32, the
# attention tolerance of tests/test_kernels.py, element by element (the
# kernels sum in another order; worst seen ~1e-6); in bf16, rtol covers
# one bf16 ulp of the output (at most 2^-7 relative), and atol the
# rounding of p against the running max (the kernels) rather than the
# row's max (the plain versions), at most 2^-8 sum p|v| / l and seen up
# to 1.7e-3 on rows of a few keys
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (4e-3, 1e-2)}
# the attention kernels' realistic timing shapes:
# decode: configs/shapes.py decode_32k (batch 128, 32k cache) on
# gemma_2b's attention (8 query heads on 1 KV head, head_dim 256);
# flash: train_4k (4096 tokens, batch cut from 256 to 2) on stablelm_3b's
# attention (32 heads, 32 KV heads, head_dim 80), causal; and path (g)'s
# own call: zamba2-2.7b's shared attention (32 heads, MHA, head_dim 80)
# over the 4 x 512 prefill
DECODE_AT_SCALE = dict(B=128, H=8, KV=1, S=32768, D=256)
FLASH_AT_SCALE = dict(B=2, H=32, S=4096, D=80)
FLASH_PATH_G = dict(B=4, H=32, S=512, D=80)
# rmsnorm / ssd_chunk, held element-wise as (atol, rtol): in f32,
# tests/test_kernels.py's tolerances, times 4 and 16 as that file holds
# them; in bf16 the kernel and its plain version round the same f32 sums
# once, so they may differ by one bf16 ulp (2^-7 relative, under rtol
# 1e-2) and, near zero, by the f32 sums' order (atol 1e-3).  A kernel
# that left w unrounded, or dropped the carry-in, misses these.  So does
# one whose scores round w to bf16 differently: the bf16 ssd_chunk kernel
# sums its scores in the plain version's order, so w is the same bit for
# bit (kernels/ssd_chunk.py).
RMS_TOL = {"float32": (8e-5, 8e-5), "bfloat16": (1e-3, 1e-2)}
SSD_TOL = {"float32": (3.2e-4, 3.2e-4), "bfloat16": (1e-3, 1e-2)}
# their realistic timing shapes: prefill_32k (32768 tokens, batch cut
# from 32 to 2) on zamba2-2.7b's Mamba2 layers (d_inner 5120; 80 heads
# of P = 64, state N = 64, chunk 256 -> 128 chunks)
RMS_AT_SCALE = dict(rows=2 * 32768, d=5120)
SSD_AT_SCALE = dict(B=2, nc=128, H=80, Q=256, N=64, P=64)
# eager calls a realistic ("big") shape is timed over, after 2 warm-ups
BIG_ITERS = 20

DEVICE = "cuda"

KERNEL_META = {
    "compose": ("src/repro_torch/csrc/compose.cu",
                "src/repro/kernels/compose.py:111"),
    "conv_rank": ("src/repro_torch/csrc/conv_rank.cu",
                  "src/repro/kernels/conv_rank.py:206"),
    "rank_apply": ("src/repro_torch/csrc/rank_apply.cu",
                   "src/repro/kernels/compose.py:247"),
    "compose_apply": ("src/repro_torch/csrc/compose_apply.cu",
                      "src/repro/kernels/compose.py:429"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:95"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:98"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:35"),
    "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk.py:56"),
}


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def sass_counts(rt, names=("flash_attention", "decode_attention",
                            "ssd_chunk")) -> dict:
    """Tensor-core (HMMA, HGMMA), ldmatrix (LDSM) and cp.async (LDGSTS)
    instructions in the built attention and SSD-chunk libraries
    (``cuobjdump -sass``); fails unless each library has tensor-core
    instructions (its bf16 kernel)."""
    import re

    cuobjdump = Path(rt._nvcc()).parent / "cuobjdump"
    counts = {}
    for name in names:
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(rt._lib_path(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                        for op in ("HMMA", "HGMMA", "LDSM", "LDGSTS")}
        check(counts[name]["HMMA"] + counts[name]["HGMMA"] > 0,
              f"{name}: no tensor-core instruction in its library")
    print(f"  SASS instruction counts {json.dumps(counts)}")
    return counts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


@contextlib.contextmanager
def deterministic(torch, on: bool):
    """Deterministic algorithms on or off for the block (warn only).  On,
    ``torch.empty`` fills float tensors with NaN
    (``torch.utils.deterministic.fill_uninitialized_memory``), so an output
    a kernel leaves unwritten fails its check, whatever answer the caching
    allocator's recycled buffer held; the timers turn it off, so no fill
    is timed."""
    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic")
            yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=was_warn)


def nan_empty(check_fn):
    """Run a phase-2 check (``check_fn(torch, ...)``) under
    ``deterministic(torch, True)``."""
    @functools.wraps(check_fn)
    def run(torch, *args, **kwargs):
        with deterministic(torch, True):
            return check_fn(torch, *args, **kwargs)
    return run


def device_ms(torch, fn, reps: int = 100, replays: int = 5) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed and timed with CUDA events, so the host's launch cost
    is not in the number."""
    with deterministic(torch, False):
        return _graph_ms(torch, fn, reps, replays)


def _graph_ms(torch, fn, reps: int, replays: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def call_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Per-call time of ``fn()`` issued eagerly back to back (CUDA events),
    host launch cost included: what one call costs the training loop."""
    with deterministic(torch, False):
        return _eager_ms(torch, fn, iters, warmup)


def _eager_ms(torch, fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, flops: int,
          peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time for the work on an H100 at full power: the larger of
    bytes over the memory rate and FLOPs over the peak for their type
    (f32 FFMA by default, ``PEAK_BF16_FLOPS`` for bf16 work), in ms."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_kernel(torch, name, label, shape, fn, plain, library, nbytes,
                flops, peak, big, two_call=None) -> dict:
    """Timing record of one kernel call ``fn`` beside its plain version,
    the one PyTorch call computing the same function (``library``, or
    None) and, where none does, the reference's several calls
    (``two_call``).  ``big`` (ms-scale) calls are timed with events
    around ``BIG_ITERS`` eager calls, small ones by CUDA-graph replay."""
    iters, warmup = (BIG_ITERS, 2) if big else (200, 20)
    if big:
        def t(f):
            return call_ms(torch, f, iters=iters, warmup=warmup)
    else:
        def t(f):
            return device_ms(torch, f)
    rec = {"ms": t(fn), "plain_ms": t(plain),
           "library_ms": t(library) if library else None,
           "call_ms": call_ms(torch, fn, iters=iters, warmup=warmup),
           "plain_call_ms": call_ms(torch, plain, iters=iters,
                                    warmup=warmup)}
    if library:
        rec["library_call_ms"] = call_ms(torch, library, iters=iters,
                                         warmup=warmup)
    if two_call:
        rec["two_call_ms"] = t(two_call)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, peak)
    rec["shape"] = shape
    print(f"  {name} [{label}] kernel_ms {rec['ms']:.5f} plain_ms "
          f"{rec['plain_ms']:.5f} library_ms {rec['library_ms']} "
          + (f"two_call_ms {rec['two_call_ms']:.5f} " if two_call else "")
          + f"bound_ms {rec['bound_ms']:.6f} ({rec['bound_by']}) call_ms "
          f"{rec['call_ms']:.5f} "
          + (f"library_call_ms {rec['library_call_ms']:.5f} " if library
             else "") + f"[{shape}]")
    return rec


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------


def err(torch, got, want, tol: float, what: str) -> float:
    """Max abs error; fails beyond ``tol * max(1, max|want|)``."""
    torch.cuda.synchronize()
    e = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    print(f"  {what}: max_abs_err {e:.3e} max_rel_err {e / scale:.3e} "
          f"tol {tol:.0e}")
    check(math.isfinite(e) and e <= tol * scale, f"{what} disagrees")
    return e


def close(torch, got, want, tol: tuple, what: str) -> float:
    """Max abs error; fails where an element misses ``atol + rtol *
    |want|`` (``tol = (atol, rtol)``), as ``np.testing.assert_allclose``
    holds the reference's kernels."""
    atol, rtol = tol
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    e = float(d.max())
    excess = float((d - atol - rtol * want.float().abs()).max())
    print(f"  {what}: max_abs_err {e:.3e} tol {atol:.0e} + {rtol:.0e}*|ref| "
          f"(worst margin {-excess:.3e})")
    check(math.isfinite(e) and excess <= 0, f"{what} disagrees")
    return e


def grad_check(torch, fn, ref_fn, args, tol, what):
    """Gradients through the autograd Function vs autograd of the plain
    version, on a fixed random cotangent."""
    a1 = [a.detach().clone().requires_grad_() for a in args]
    a2 = [a.detach().clone().requires_grad_() for a in args]
    y1 = fn(*a1)
    w = torch.randn(y1.shape, device=y1.device,
                    generator=torch.Generator(y1.device).manual_seed(0))
    (y1 * w).sum().backward()
    (ref_fn(*a2) * w).sum().backward()
    for i, (g1, g2) in enumerate(zip(a1, a2)):
        err(torch, g1.grad, g2.grad, tol, f"{what} grad[{i}]")


@nan_empty
def check_kernels(torch):
    """Phase 2 of the four composition kernels.  Returns their timing
    records."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.compose import (_compose_apply_math, _fwd_math,
                                             _u2_layout, compose,
                                             compose_apply_kernel,
                                             compose_dense_apply,
                                             compose_kernel,
                                             rank_apply_kernel,
                                             rank_dense_apply)
    from repro_torch.kernels.conv_rank import (_fused_math, _u2_conv_layout,
                                               conv_rank_apply,
                                               conv_rank_kernel)

    gen = torch.Generator().manual_seed(0)
    dev = torch.device(DEVICE)

    def rn(*shape, scale=0.5):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    maxerr = {k: 0.0 for k in KERNEL_META}
    modes = ("square", "grow_out", "grow_in")

    print("phase 2: kernels vs plain versions")
    # compose at every CNN layer shape, p = 1..3, and with a client axis
    for p in (1, 2, 3):
        for layer, (ksq, I, m, O) in {"conv1": (9, 3, p, 8),
                                      "conv2/3": (9, 8, p * p, 8),
                                      "fc": (1, 8, p, 10)}.items():
            v, u = rn(ksq, I, 8), rn(m, 8, O)
            maxerr["compose"] = max(maxerr["compose"], err(
                torch, compose_kernel(v, u), ref.compose_ref(v, u),
                DENSE_TOL, f"compose {layer} p={p} {tuple(v.shape)}x"
                           f"{tuple(u.shape)}"))
    v4, u4 = rn(4, 9, 8, 8), rn(4, 9, 8, 8)
    maxerr["compose"] = max(maxerr["compose"], err(
        torch, compose_kernel(v4, u4), ref.compose_ref(v4, u4), DENSE_TOL,
        "compose C=4 (4,9,8,8)x(4,9,8,8)"))
    # compose's edges: the cohort stack of 10 clients (conv2, and the fc
    # layer's ragged m*O), rank 6 with ragged rows and m*O, and a rank in
    # the thousands (the generic r loop)
    for C, ksq, I, R, m, O in COMPOSE_EDGES:
        lead = (C,) if C > 1 else ()
        v, u = rn(*lead, ksq, I, R), rn(*lead, m, R, O)
        maxerr["compose"] = max(maxerr["compose"], err(
            torch, compose_kernel(v, u), ref.compose_ref(v, u), DENSE_TOL,
            f"compose edge C={C} {tuple(v.shape)}x{tuple(u.shape)}"))

    # compose_apply's edges: ragged row tiles (M 17, 1000, 1), ragged and
    # several column tiles (D 10, 96, 64, 6), rank 6 on rows of 9 floats,
    # a basis past 48 KB (I = 2048) and a weight tile built in chunks (g*I
    # = 1536); each also as the (y, t) pair the training forward takes,
    # against the plain pair
    for M, g, I, R, D in COMPOSE_APPLY_EDGES:
        xg, v, u3 = rn(M, g, I, scale=1.0), rn(I, R), rn(g, R, D)
        what = f"compose_apply edge xg{tuple(xg.shape)} R={R} D={D}"
        maxerr["compose_apply"] = max(maxerr["compose_apply"], err(
            torch, compose_apply_kernel(xg, v, u3),
            _compose_apply_math(xg, v, u3), DENSE_TOL, what))
        y, t = compose_apply_kernel(xg, v, u3, with_t=True)
        y0, t0 = _compose_apply_math(xg, v, u3, with_t=True)
        err(torch, y, y0, DENSE_TOL, f"{what} with t: y")
        maxerr["compose_apply"] = max(maxerr["compose_apply"], err(
            torch, t, t0, DENSE_TOL, f"{what} with t: t"))

    # dense primitives at the classifier head, all modes, p = 1..3
    for mode in modes:
        for p in (1, 2, 3):
            g = 1 if mode == "grow_out" else p
            m = p * p if mode == "square" else p
            xg, v, u = rn(16, g, 8, scale=1.0), rn(8, 8), rn(m, 8, 10)
            u2 = _u2_layout(u, p, mode).contiguous()
            u3 = u2.reshape(g, 8, -1).contiguous()
            maxerr["rank_apply"] = max(maxerr["rank_apply"], err(
                torch, rank_apply_kernel(xg, v, u2), _fwd_math(xg, v, u2),
                DENSE_TOL, f"rank_apply {mode} p={p} xg{tuple(xg.shape)}"))
            maxerr["compose_apply"] = max(maxerr["compose_apply"], err(
                torch, compose_apply_kernel(xg, v, u3),
                _compose_apply_math(xg, v, u3), DENSE_TOL,
                f"compose_apply {mode} p={p} xg{tuple(xg.shape)}"))

    # the composed transformer's layers (d_base 16, ff 32, rank 8, vocab
    # 64) over B*T = 256 rows: square projections and MLP, the grow_in
    # head; its compose shapes too
    for p in (1, 2, 3):
        for layer, (mode, I, O) in {"wq/wk/wv/wo": ("square", 16, 16),
                                    "up": ("square", 16, 32),
                                    "down": ("square", 32, 16),
                                    "head": ("grow_in", 16, 64)}.items():
            m = p * p if mode == "square" else p
            xg, v, u = rn(256, p, I, scale=1.0), rn(I, 8), rn(m, 8, O)
            u2 = _u2_layout(u, p, mode).contiguous()
            u3 = u2.reshape(p, 8, -1).contiguous()
            what = f"transformer {layer} {mode} p={p} xg{tuple(xg.shape)}"
            maxerr["rank_apply"] = max(maxerr["rank_apply"], err(
                torch, rank_apply_kernel(xg, v, u2), _fwd_math(xg, v, u2),
                DENSE_TOL, f"rank_apply {what}"))
            maxerr["compose_apply"] = max(maxerr["compose_apply"], err(
                torch, compose_apply_kernel(xg, v, u3),
                _compose_apply_math(xg, v, u3), DENSE_TOL,
                f"compose_apply {what}"))
            vb = v[None]
            maxerr["compose"] = max(maxerr["compose"], err(
                torch, compose_kernel(vb, u), ref.compose_ref(vb, u),
                DENSE_TOL, f"compose {what}"))

    no_grad = fused_head_forward(torch, rn)

    # rank_apply's edge cases: ragged row tiles (M 17, 1000, 1), a ragged
    # column tile (D 10, 6), path (e)'s widest D (96), a row that is not
    # 16-byte aligned (g*I = 9) with a rank that is not a multiple of 4
    # (R 6), and a basis whose tiles pass 48 KB; the (y, t) pair the
    # training forward takes, against the plain pair
    for M, g, I, R, D in ((17, 3, 8, 8, 10), (1000, 3, 16, 8, 96),
                          (1, 2, 16, 8, 64), (17, 3, 3, 6, 6),
                          (16, 1, 2048, 8, 10)):
        xg, v, u2 = rn(M, g, I, scale=1.0), rn(I, R), rn(g * R, D)
        what = f"rank_apply edge xg{tuple(xg.shape)} D={D}"
        maxerr["rank_apply"] = max(maxerr["rank_apply"], err(
            torch, rank_apply_kernel(xg, v, u2), _fwd_math(xg, v, u2),
            DENSE_TOL, what))
        y, t = rank_apply_kernel(xg, v, u2, with_t=True)
        y0, t0 = _fwd_math(xg, v, u2, with_t=True)
        err(torch, y, y0, DENSE_TOL, f"{what} with t: y")
        maxerr["rank_apply"] = max(maxerr["rank_apply"], err(
            torch, t, t0, DENSE_TOL, f"{what} with t: t"))

    # conv_rank: all modes x p x stride at the 8x8 input, and conv3's 4x4;
    # then odd sizes 7 and 5, the cifar10 task's 32x32 (both strides, C 3
    # and 24), rank 6 (not a multiple of 4) with C = 6, and a basis whose
    # tiles pass 48 KB (C = I = 192)
    conv_cases = []
    for mode in modes:
        for p in (1, 2, 3):
            for stride in (1, 2):
                conv_cases.append((mode, p, stride, 8, 16))
    conv_cases += [("square", p, 2, 4, 16) for p in (1, 2, 3)]
    for hw in (7, 5, 32):
        for stride in (1, 2):
            conv_cases += [("square", 3, stride, hw, 16),
                           ("grow_out", 3, stride, hw, 16)]
    conv_cases += [("grow_in", 2, 1, 7, 3), ("grow_out", 1, 1, 8, 2)]
    for mode, p, stride, hw, N in conv_cases:
        g = 1 if mode == "grow_out" else p
        I = {2: 192, 3: 3}.get(N, 3 if mode == "grow_out" else 8)
        R = 6 if N == 3 else 8
        m = p * p if mode == "square" else p
        x, v, u = rn(N, hw, hw, g * I, scale=1.0), rn(9, I, R), rn(m, R, 8)
        u2 = _u2_conv_layout(u, p, mode).contiguous()
        got = conv_rank_kernel(x, v, u2, p=p, mode=mode, stride=stride)
        maxerr["conv_rank"] = max(maxerr["conv_rank"], err(
            torch, got, _fused_math(x, v, u2, p, mode, stride), CONV_TOL,
            f"conv_rank {mode} p={p} s={stride} x{tuple(x.shape)}"))
        err(torch, got, ref.conv_rank_ref(x, v, u, p, mode, stride),
            CONV_TOL, f"conv_rank {mode} p={p} s={stride} vs compose+conv")

    cohort = check_cohort_kernels(torch, rn, maxerr)
    check_slice_kernels(torch, rn, maxerr)

    print("phase 2: gradients through the autograd Functions")
    for p in (1, 3):
        v, u = rn(9, 8, 8), rn(p * p, 8, 8)
        grad_check(torch, compose, ref.compose_ref, (v, u), GRAD_TOL,
                   f"compose p={p}")
        x, vd, ud = rn(16, 8 * p, scale=1.0), rn(1, 8, 8), rn(p, 8, 10)
        for name, fn in (("rank_dense_apply", rank_dense_apply),
                         ("compose_dense_apply", compose_dense_apply)):
            grad_check(torch,
                       lambda a, b, c, f=fn: f(a, b, c, p, "grow_in"),
                       lambda a, b, c: ref.compose_apply_ref(a, b, c, p,
                                                             "grow_in"),
                       (x, vd, ud), GRAD_TOL, f"{name} grow_in p={p}")
        # path (e)'s MLP up projection (square, 256 rows), and grow_out
        for mode, M, I, O in (("square", 256, 16, 32), ("grow_out", 17, 8,
                                                         10)):
            g = 1 if mode == "grow_out" else p
            m = p * p if mode == "square" else p
            x, vd, ud = rn(M, g * I, scale=1.0), rn(1, I, 8), rn(m, 8, O)
            grad_check(torch,
                       lambda a, b, c, md=mode: rank_dense_apply(a, b, c, p,
                                                                 md),
                       lambda a, b, c, md=mode: ref.compose_apply_ref(
                           a, b, c, p, md),
                       (x, vd, ud), GRAD_TOL,
                       f"rank_dense_apply {mode} p={p} x{tuple(x.shape)}")
        for mode, stride in (("grow_out", 1), ("square", 2)):
            g = 1 if mode == "grow_out" else p
            I = 3 if mode == "grow_out" else 8
            m = p * p if mode == "square" else p
            x, v, u = rn(16, 8, 8, g * I, scale=1.0), rn(9, I, 8), rn(m, 8, 8)
            grad_check(
                torch,
                lambda a, b, c, md=mode, s=stride: conv_rank_apply(
                    a, b, c, p, md, stride=s),
                lambda a, b, c, md=mode, s=stride: ref.conv_rank_ref(
                    a, b, c, p, md, s),
                (x, v, u), CONV_GRAD_TOL, f"conv_rank {mode} p={p} s={stride}")

    print("phase 2: timing at the main path's widest shapes (p=3)")
    records = rank_kernel_times(torch, rn)
    records.update(composition_times(torch, rn))
    records["compose_apply"]["no_grad"] = no_grad
    for name, rows in cohort_times(torch, rn).items():
        records[name]["cohort"] = rows
    print(f"  launches of each vmapped call: {json.dumps(cohort)}")
    for name, rec in records.items():
        rec["max_abs_err"] = maxerr[name]
    return records


# client counts the client-batched kernels are held at in phase 2: one
# client, the smoke's 4-client rounds (3 and 4 clients a group) and a
# whole-fleet round of 10
COHORT_CS = (1, 3, 4, 10)
# ... and timed at
COHORT_TIMED_CS = (4, 10)


def _stacked(rn, C, *shapes, scale=0.5):
    return [rn(C, *s, scale=scale) for s in shapes]


def check_cohort_kernels(torch, rn, maxerr) -> dict:
    """Phase 2 of the client-batched conv_rank, rank_apply and
    compose_apply: each launch on a leading client axis C in
    ``COHORT_CS`` against the plain version on the same operands, at
    every CNN layer, mode and width (conv1 grow_out, conv2/conv3 square
    at stride 2, a grow_in conv; the head in all three modes), at ragged
    row and column tiles and path (e)'s widest dense call, with the (y, t)
    pairs; then each public Function under ``torch.func.vmap`` over C
    clients, forward and gradient, against ``vmap`` of the reference
    oracle, launching its kernel once per call whatever C (with and
    without a graph).  Returns the vmapped calls' launches."""
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    from repro_torch.kernels.compose import (_compose_apply_math, _fwd_math,
                                             _u2_layout, compose,
                                             compose_apply_kernel,
                                             compose_dense_apply,
                                             rank_apply_kernel,
                                             rank_dense_apply)
    from repro_torch.kernels.conv_rank import (_fused_math, _u2_conv_layout,
                                               conv_rank_apply,
                                               conv_rank_kernel)

    print("phase 2: client-batched kernels (leading client axis C)")
    for C in COHORT_CS:
        for p in (1, 2, 3):
            for label, mode, I, hw, stride in (
                    ("conv1", "grow_out", 3, 8, 1),
                    ("conv2", "square", 8, 8, 2),
                    ("conv3", "square", 8, 4, 2),
                    ("grow_in", "grow_in", 8, 8, 1)):
                if label == "grow_in" and C != 3:
                    continue
                g = 1 if mode == "grow_out" else p
                m = p * p if mode == "square" else p
                x, v, u = _stacked(rn, C, (16, hw, hw, g * I), (9, I, 8),
                                   (m, 8, 8))
                u2 = _u2_conv_layout(u, p, mode).contiguous()
                maxerr["conv_rank"] = max(maxerr["conv_rank"], err(
                    torch, conv_rank_kernel(x, v, u2, p=p, mode=mode,
                                            stride=stride),
                    _fused_math(x, v, u2, p, mode, stride), CONV_TOL,
                    f"conv_rank cohort C={C} {label} {mode} p={p} "
                    f"s={stride} x{tuple(x.shape)}"))
    # (C, M, p, I, D, mode): the head's modes at every width (D = 10
    # grow_in, 8p otherwise), ragged rows (M 17) and columns (D 6), and
    # path (e)'s up projection
    dense = [(C, 16, p, 8, 8 * p if mode != "grow_in" else 10, mode)
             for C in COHORT_CS for mode in ("grow_in", "square", "grow_out")
             for p in (1, 2, 3)]
    dense += [(3, 17, 3, 8, 6, "grow_in"), (4, 256, 3, 16, 96, "square")]
    for C, M, p, I, D, mode in dense:
        g = 1 if mode == "grow_out" else p
        m = p * p if mode == "square" else p
        O = D // (p if mode != "grow_in" else 1)
        xg, v, u = _stacked(rn, C, (M, g, I), (I, 8), (m, 8, O))
        xg = xg * 2
        u2 = _u2_layout(u, p, mode).contiguous()
        u3 = u2.reshape(C, g, 8, -1).contiguous()
        what = f"C={C} {mode} p={p} xg{tuple(xg.shape)} D={D}"
        maxerr["rank_apply"] = max(maxerr["rank_apply"], err(
            torch, rank_apply_kernel(xg, v, u2), _fwd_math(xg, v, u2),
            DENSE_TOL, f"rank_apply cohort {what}"))
        maxerr["compose_apply"] = max(maxerr["compose_apply"], err(
            torch, compose_apply_kernel(xg, v, u3),
            _compose_apply_math(xg, v, u3), DENSE_TOL,
            f"compose_apply cohort {what}"))
        if C == 3 and M == 17:
            for name, kernel, plain, w in (
                    ("rank_apply", rank_apply_kernel, _fwd_math, u2),
                    ("compose_apply", compose_apply_kernel,
                     _compose_apply_math, u3)):
                y, t = kernel(xg, v, w, with_t=True)
                y0, t0 = plain(xg, v, w, with_t=True)
                err(torch, y, y0, DENSE_TOL, f"{name} cohort {what} with t: y")
                maxerr[name] = max(maxerr[name], err(
                    torch, t, t0, DENSE_TOL,
                    f"{name} cohort {what} with t: t"))

    print("phase 2: the Functions under torch.func.vmap over clients")
    vmap = torch.func.vmap
    launches = {}
    for C in (3, 10):
        for label, name, fn, ref_fn, args, tol in (
                ("conv2 square p=3", "conv_rank",
                 lambda a, b, c: conv_rank_apply(a, b, c, 3, "square",
                                                 stride=2),
                 lambda a, b, c: ref.conv_rank_ref(a, b, c, 3, "square", 2),
                 _stacked(rn, C, (16, 8, 8, 24), (9, 8, 8), (9, 8, 8)),
                 CONV_GRAD_TOL),
                ("conv1 grow_out p=2", "conv_rank",
                 lambda a, b, c: conv_rank_apply(a, b, c, 2, "grow_out"),
                 lambda a, b, c: ref.conv_rank_ref(a, b, c, 2, "grow_out",
                                                   1),
                 _stacked(rn, C, (16, 8, 8, 3), (9, 3, 8), (2, 8, 8)),
                 CONV_GRAD_TOL),
                ("fc grow_in p=3", "rank_apply",
                 lambda a, b, c: rank_dense_apply(a, b, c, 3, "grow_in"),
                 lambda a, b, c: ref.compose_apply_ref(a, b, c, 3,
                                                       "grow_in"),
                 _stacked(rn, C, (16, 24), (1, 8, 8), (3, 8, 10)), GRAD_TOL),
                ("fc grow_in p=3", "compose_apply",
                 lambda a, b, c: compose_dense_apply(a, b, c, 3, "grow_in"),
                 lambda a, b, c: ref.compose_apply_ref(a, b, c, 3,
                                                       "grow_in"),
                 _stacked(rn, C, (16, 24), (1, 8, 8), (3, 8, 10)), GRAD_TOL),
                ("conv2 p=3", "compose", compose, ref.compose_ref,
                 _stacked(rn, C, (9, 8, 8), (9, 8, 8)), GRAD_TOL)):
            what = f"vmap C={C} {name} {label}"
            with torch.no_grad():
                reset_launches()
                y = vmap(fn)(*args)
                got = dict(LAUNCHES)
            maxerr[name] = max(maxerr[name], err(
                torch, y, vmap(ref_fn)(*args),
                CONV_TOL if name == "conv_rank" else DENSE_TOL,
                f"{what} no_grad"))
            check(got[name] == 1 and sum(got.values()) == 1,
                  f"{what}: no-grad launches {got}, not one {name}")
            reset_launches()
            grad_check(torch, vmap(fn), vmap(ref_fn), args, tol, what)
            check(LAUNCHES[name] == 1,
                  f"{what}: recorded launches {dict(LAUNCHES)}, not one "
                  f"{name}")
            launches[what] = LAUNCHES[name]
    return launches


# the shapes paths (k) and (l) put the composition kernels on, at p = 3
# and the training batch of 16: the residual net's square stride-1 convs
# and its grow_out stem on 32x32 images (label, mode, I), x (16, 32, 32,
# g*I) -> (16, 32, 32, 24); the RNN's input projection wx (square, 16 ->
# 48) and head out (grow_in, 48 -> vocab 64) on its (16, 32, 48) hidden
# states, M = 512 rows (label, mode, I, O); and the composes of its
# recurrence weight wh, embedding and head (label, ksq, I, m, O)
SLICE_CONV = (("(k) b1a square s=1", "square", 8),
              ("(k) stem grow_out", "grow_out", 3))
SLICE_DENSE = (("(l) wx square", "square", 16, 16),
               ("(l) out grow_in", "grow_in", 16, 64))
SLICE_COMPOSE = (("(l) wh", 1, 16, 9, 16), ("(l) embed", 1, 64, 3, 16),
                 ("(l) out", 1, 16, 3, 64))
# decompose solves a least-squares system in f32 (cuSOLVER's gels on the
# card, LAPACK's on the CPU), as tests/test_torch_composition.py holds it
DECOMPOSE_TOL = 1e-4


def check_slice_kernels(torch, rn, maxerr) -> None:
    """Phase 2 at the shapes paths (k) and (l) put the four composition
    kernels on (``SLICE_CONV``, ``SLICE_DENSE``, ``SLICE_COMPOSE``):
    each kernel against its plain version, with a client axis C = 4 as
    the cohort runs launch them, the (y, t) pairs, and the gradient
    through each autograd Function on the layer's own input layout (the
    RNN's dense layers take (B, T, pI)); then ``decompose`` on the card
    against the CPU, and ``compose(decompose(w))`` against w for a weight
    in the basis's span."""
    from repro_torch.core.composition import (CompositionSpec, compose,
                                              decompose)
    from repro_torch.kernels import ref
    from repro_torch.kernels.compose import (_compose_apply_math, _fwd_math,
                                             _u2_layout, compose_apply_kernel,
                                             compose_dense_apply,
                                             compose_kernel,
                                             rank_apply_kernel,
                                             rank_dense_apply)
    from repro_torch.kernels.compose import compose as compose_fn
    from repro_torch.kernels.conv_rank import (_fused_math, _u2_conv_layout,
                                               conv_rank_apply,
                                               conv_rank_kernel)

    print("phase 2: the shapes of paths (k) and (l)")
    for label, mode, I in SLICE_CONV:
        g, m = (1, 3) if mode == "grow_out" else (3, 9)
        for C in (1, 4):
            lead = (C,) if C > 1 else ()
            x, v, u = (rn(*lead, 16, 32, 32, g * I, scale=1.0),
                       rn(*lead, 9, I, 8), rn(*lead, m, 8, 8))
            u2 = _u2_conv_layout(u, 3, mode).contiguous()
            got = conv_rank_kernel(x, v, u2, p=3, mode=mode, stride=1)
            maxerr["conv_rank"] = max(maxerr["conv_rank"], err(
                torch, got, _fused_math(x, v, u2, 3, mode, 1), CONV_TOL,
                f"conv_rank {label} C={C} x{tuple(x.shape)}"))
            if C == 1:
                err(torch, got, ref.conv_rank_ref(x, v, u, 3, mode, 1),
                    CONV_TOL, f"conv_rank {label} vs compose+conv")
                grad_check(
                    torch,
                    lambda a, b, c, md=mode: conv_rank_apply(a, b, c, 3, md),
                    lambda a, b, c, md=mode: ref.conv_rank_ref(a, b, c, 3,
                                                               md, 1),
                    (x, v, u), CONV_GRAD_TOL, f"conv_rank {label}")
    for label, mode, I, O in SLICE_DENSE:
        m = 9 if mode == "square" else 3
        for C in (1, 4):
            lead = (C,) if C > 1 else ()
            xg, v, u = (rn(*lead, 512, 3, I, scale=1.0), rn(*lead, I, 8),
                        rn(*lead, m, 8, O))
            u2 = _u2_layout(u, 3, mode).contiguous()
            u3 = u2.reshape(*lead, 3, 8, -1).contiguous()
            what = f"{label} C={C} xg{tuple(xg.shape)}"
            for name, kernel, plain, w in (
                    ("rank_apply", rank_apply_kernel, _fwd_math, u2),
                    ("compose_apply", compose_apply_kernel,
                     _compose_apply_math, u3)):
                maxerr[name] = max(maxerr[name], err(
                    torch, kernel(xg, v, w), plain(xg, v, w), DENSE_TOL,
                    f"{name} {what}"))
                y, t = kernel(xg, v, w, with_t=True)
                y0, t0 = plain(xg, v, w, with_t=True)
                err(torch, y, y0, DENSE_TOL, f"{name} {what} with t: y")
                maxerr[name] = max(maxerr[name], err(
                    torch, t, t0, DENSE_TOL, f"{name} {what} with t: t"))
        x, vd, ud = rn(16, 32, 3 * I, scale=1.0), rn(1, I, 8), rn(m, 8, O)
        for name, fn in (("rank_dense_apply", rank_dense_apply),
                         ("compose_dense_apply", compose_dense_apply)):
            grad_check(torch,
                       lambda a, b, c, f=fn, md=mode: f(a, b, c, 3, md),
                       lambda a, b, c, md=mode: ref.compose_apply_ref(
                           a, b, c, 3, md),
                       (x, vd, ud), GRAD_TOL,
                       f"{name} {label} x{tuple(x.shape)}")
    for label, ksq, I, m, O in SLICE_COMPOSE:
        for C in (1, 4):
            lead = (C,) if C > 1 else ()
            v, u = rn(*lead, ksq, I, 8), rn(*lead, m, 8, O)
            maxerr["compose"] = max(maxerr["compose"], err(
                torch, compose_kernel(v, u), ref.compose_ref(v, u),
                DENSE_TOL, f"compose {label} C={C} {tuple(v.shape)}x"
                           f"{tuple(u.shape)}"))
        grad_check(torch, compose_fn, ref.compose_ref, (v[0], u[0]),
                   GRAD_TOL, f"compose {label}")

    # decompose: the residual net's square conv, a weight off and in the
    # basis's span
    spec = CompositionSpec(3, 8, 8, 8, ksq=9)
    v, u = rn(9, 8, 8), rn(9, 8, 8)
    for what, w in (("off the span", rn(9, 24, 24)),
                    ("in the span", compose(v, u, 3, spec))):
        got = decompose(w, v, 3, spec)
        err(torch, got, decompose(w.cpu(), v.cpu(), 3, spec).to(got.device),
            DECOMPOSE_TOL, f"decompose {what}: card vs CPU")
    err(torch, got, u, DECOMPOSE_TOL, "decompose in the span: blocks back")
    err(torch, compose(v, got, 3, spec), w, DECOMPOSE_TOL,
        "compose(decompose(w)) vs w")


def cohort_times(torch, rn) -> dict:
    """Timing records of the client-batched conv_rank, rank_apply and
    compose_apply at C in ``COHORT_TIMED_CS`` at the CNN's conv2 (square,
    p = 3, stride 2) and fc head (grow_in, p = 3) shapes, through the
    wrappers' public calls, beside the plain version and the batched
    3-operand ``einsum`` (the library call computing the dense kernels'
    function; no single call computes conv_rank's)."""
    from repro_torch.kernels.compose import (_compose_apply_math, _fwd_math,
                                             compose_apply_kernel,
                                             rank_apply_kernel)
    from repro_torch.kernels.conv_rank import _fused_math, conv_rank_kernel

    f32 = 4
    out = {"conv_rank": [], "rank_apply": [], "compose_apply": []}
    for C in COHORT_TIMED_CS:
        x, v, u2 = _stacked(rn, C, (16, 8, 8, 24), (9, 8, 8), (24, 24))
        shape = (f"cohort C={C} conv2 square p=3: x {tuple(x.shape)} s=2 -> "
                 f"({C},16,4,4,24)")
        out["conv_rank"].append(time_kernel(
            torch, "conv_rank", f"cohort C={C} conv2", shape,
            lambda x=x, v=v, u2=u2: conv_rank_kernel(x, v, u2, p=3,
                                                     mode="square", stride=2),
            lambda x=x, v=v, u2=u2: _fused_math(x, v, u2, 3, "square", 2),
            None, f32 * (x.numel() + v.numel() + u2.numel()
                         + C * 16 * 4 * 4 * 24),
            2 * C * 16 * 4 * 4 * (3 * 9 * 8 * 8 + 24 * 24), PEAK_F32_FLOPS,
            False))
        xg, v, u3 = _stacked(rn, C, (16, 3, 8), (8, 8), (3, 8, 10))
        u2 = u3.reshape(C, 24, 10)
        shape = (f"cohort C={C} fc grow_in p=3: xg {tuple(xg.shape)} -> "
                 f"({C},16,10)")
        nbytes = f32 * (xg.numel() + v.numel() + u3.numel() + C * 16 * 10)
        for name, kernel, plain, w, flops in (
                ("rank_apply", rank_apply_kernel, _fwd_math, u2,
                 2 * C * (16 * 3 * 8 * 8 + 16 * 24 * 10)),
                ("compose_apply", compose_apply_kernel, _compose_apply_math,
                 u3, 2 * C * (3 * 8 * 8 * 10 + 16 * 24 * 10))):
            out[name].append(time_kernel(
                torch, name, f"cohort C={C} fc", shape,
                lambda k=kernel, xg=xg, v=v, w=w: k(xg, v, w),
                lambda pl=plain, xg=xg, v=v, w=w: pl(xg, v, w),
                lambda xg=xg, v=v, u3=u3: torch.einsum(
                    "cmai,cir,card->cmd", xg, v, u3),
                nbytes, flops, PEAK_F32_FLOPS, False))
    return out


# conv_rank's timed shapes (p = 3, batch 16): the CNN's two convs on its
# 8x8 inputs, and on the cifar10 task's 32x32 images
# (src/repro/data/cifar10.py) at the CNN's widths: (label, mode, g, I,
# hw, stride); D = 24 each
CONV_TIMED = (("conv2 square", "square", 3, 8, 8, 2),
              ("conv1 grow_out", "grow_out", 1, 3, 8, 1),
              ("conv1 grow_out 32x32 = path (k) stem", "grow_out", 1, 3, 32,
               1),
              ("conv2 square 32x32", "square", 3, 8, 32, 2),
              ("path (k) b1a square 32x32", "square", 3, 8, 32, 1))
# rank_apply's: the CNN's classifier head, path (e)'s MLP up projection
# and path (l)'s input projection wx and head out over its 16 x 32 token
# rows, at p = 3: (label, mode, M, g, I, D)
RANK_TIMED = (("fc grow_in", "grow_in", 16, 3, 8, 10),
              ("path (e) up square", "square", 256, 3, 16, 96),
              ("path (l) wx square", "square", 512, 3, 16, 48),
              ("path (l) out grow_in", "grow_in", 512, 3, 16, 64))


def rank_kernel_times(torch, rn) -> dict:
    """Timing records of conv_rank and rank_apply at every timed shape
    (``CONV_TIMED``, ``RANK_TIMED``), through the wrappers' public
    calls: the first shape's record, with the others under
    ``more_shapes``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.compose import (_fwd_math, _u2_layout,
                                             rank_apply_kernel)
    from repro_torch.kernels.conv_rank import (_fused_math, _u2_conv_layout,
                                               conv_rank_kernel)

    f32 = 4
    recs = {"conv_rank": [], "rank_apply": []}
    for label, mode, g, I, hw, stride in CONV_TIMED:
        m = 9 if mode == "square" else 3
        x, v, u = rn(16, hw, hw, g * I, scale=1.0), rn(9, I, 8), rn(m, 8, 8)
        u2 = _u2_conv_layout(u, 3, mode).contiguous()
        Ho = -(-hw // stride)
        y_elems = 16 * Ho * Ho * u2.shape[1]
        shape = (f"{label} p=3: x {tuple(x.shape)} s={stride} -> "
                 f"(16,{Ho},{Ho},{u2.shape[1]})")
        recs["conv_rank"].append(time_kernel(
            torch, "conv_rank", label, shape,
            lambda x=x, v=v, u2=u2, md=mode, s=stride: conv_rank_kernel(
                x, v, u2, p=3, mode=md, stride=s),
            lambda x=x, v=v, u2=u2, md=mode, s=stride: _fused_math(
                x, v, u2, 3, md, s),
            # no single PyTorch call takes (x, basis, coeff): the two-call
            # reference is compose (einsum) + F.conv2d on the composed
            # weight
            None, f32 * (x.numel() + v.numel() + u2.numel() + y_elems),
            2 * 16 * Ho * Ho * (g * 9 * I * 8 + g * 8 * u2.shape[1]),
            PEAK_F32_FLOPS, False,
            two_call=lambda x=x, v=v, u=u, md=mode, s=stride:
                ref.conv_rank_ref(x, v, u, 3, md, s)))
    for label, mode, M, g, I, D in RANK_TIMED:
        m = 9 if mode == "square" else 3
        xg, v, u = rn(M, g, I, scale=1.0), rn(I, 8), rn(m, 8, D // g
                                                       if m == 9 else D)
        u2 = _u2_layout(u, 3, mode).contiguous()
        u3 = u2.reshape(g, 8, D).contiguous()
        shape = (f"{label} p=3: xg {tuple(xg.shape)} v {tuple(v.shape)} u2 "
                 f"{tuple(u2.shape)} -> ({M},{D})")
        recs["rank_apply"].append(time_kernel(
            torch, "rank_apply", label, shape,
            lambda xg=xg, v=v, u2=u2: rank_apply_kernel(xg, v, u2),
            lambda xg=xg, v=v, u2=u2: _fwd_math(xg, v, u2),
            lambda xg=xg, v=v, u3=u3: torch.einsum("mai,ir,ard->md", xg, v,
                                                   u3),
            f32 * (xg.numel() + v.numel() + u2.numel() + M * D),
            2 * (M * g * I * 8 + M * g * 8 * D), PEAK_F32_FLOPS, False))
    out = {}
    for name, rows in recs.items():
        out[name] = dict(rows[0], more_shapes=rows[1:])
    return out


# compose's phase-2 edges: (C, ksq, I, R, m, O), C = 1 as a 3-d call
COMPOSE_EDGES = ((10, 9, 8, 8, 9, 8), (10, 1, 8, 8, 3, 10),
                 (1, 9, 3, 6, 3, 10), (3, 4, 7, 6, 1, 5),
                 (1, 1, 4, 3000, 1, 8))
# compose_apply's: (M, g, I, R, D)
COMPOSE_APPLY_EDGES = ((17, 3, 8, 8, 10), (1000, 3, 16, 8, 96),
                       (1, 2, 16, 8, 64), (17, 3, 3, 6, 6),
                       (16, 1, 2048, 8, 10), (5, 3, 512, 8, 40))
# compose's timed shapes at p = 3: the CNN's conv2 and fc layer (m*O =
# 30, not a multiple of 4), path (e)'s MLP up projection, the cohort
# stack of conv2 over 10 clients, and path (l)'s recurrence weight wh
# (composed on every forward, whatever the impl), embedding and head:
# (label, C, ksq, I, m, O), rank 8
COMPOSE_TIMED = (("conv2", 1, 9, 8, 9, 8), ("fc", 1, 1, 8, 3, 10),
                 ("path (e) up", 1, 1, 16, 9, 32),
                 ("cohort C=10 conv2", 10, 9, 8, 9, 8),
                 ("path (l) wh", 1, 1, 16, 9, 16),
                 ("path (l) embed", 1, 1, 64, 3, 16),
                 ("path (l) out", 1, 1, 16, 3, 64))
# compose_apply's: the CNN's head (grow_in, p = 3), the calibration's head
# (core/calibration.py _DENSE_SHAPE: grow_in, p = 2, 32 rows) and a wide
# shape that no path runs compose_apply at, path (e)'s head shape (grow_in,
# p = 3, vocab 64; path (e) runs rank_apply there), on the generic
# instance, and path (l)'s wx and out over its 512 token rows (``auto``
# takes rank_apply there, so compose_apply runs them only where a caller
# fuses the layer): (label, M, g, I, D), rank 8
COMPOSE_APPLY_TIMED = (("fc grow_in", 16, 3, 8, 10),
                       ("calibration grow_in p=2", 32, 2, 8, 10),
                       ("wide grow_in, no path", 256, 3, 16, 64),
                       ("path (l) wx square shape", 512, 3, 16, 48),
                       ("path (l) out grow_in shape", 512, 3, 16, 64))
# kernel names a GEMM or contraction launches, none of which the fused
# head's no-grad forward may run
CONTRACTION_NAMES = ("gemm", "einsum", "matmul", "bmm", "dot", "xmma",
                     "cutlass", "splitk")


def launch_floor_ms(torch) -> float:
    """Device time of an empty launch (``torch.cuda._sleep(0)``), timed as
    ``device_ms`` times the kernels: 100 launches in a CUDA graph."""
    return device_ms(torch, lambda: torch.cuda._sleep(0))


def composition_times(torch, rn) -> dict:
    """Timing records of compose and compose_apply at every timed shape
    (``COMPOSE_TIMED``, ``COMPOSE_APPLY_TIMED``) through the wrappers'
    public calls, each the first shape's record with the others under
    ``more_shapes``; compose's also carries the launch floor measured in
    the same run (``launch_floor_ms``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.compose import (_compose_apply_math,
                                             compose_apply_kernel,
                                             compose_kernel)

    f32 = 4
    floor = launch_floor_ms(torch)
    print(f"  launch floor (empty kernel, CUDA graph): {floor:.7f} ms")
    recs = {"compose": [], "compose_apply": []}
    for label, C, ksq, I, m, O in COMPOSE_TIMED:
        lead = (C,) if C > 1 else ()
        v, u = rn(*lead, ksq, I, 8), rn(*lead, m, 8, O)
        # the one-matmul library call: (C,) ksq*I x R times R x m*O
        vf = v.reshape(*lead, ksq * I, 8)
        uf = u.transpose(-3, -2).reshape(*lead, 8, m * O).contiguous()
        shape = (f"{label} p=3: basis {tuple(v.shape)} x coeff "
                 f"{tuple(u.shape)} -> {(*lead, ksq, I, m * O)}")
        recs["compose"].append(time_kernel(
            torch, "compose", label, shape,
            lambda v=v, u=u: compose_kernel(v, u),
            lambda v=v, u=u: ref.compose_ref(v, u),
            lambda vf=vf, uf=uf: torch.matmul(vf, uf),
            f32 * (v.numel() + u.numel() + C * ksq * I * m * O),
            2 * C * ksq * I * 8 * m * O, PEAK_F32_FLOPS, False))
    for label, M, g, I, D in COMPOSE_APPLY_TIMED:
        xg, v, u3 = rn(M, g, I, scale=1.0), rn(I, 8), rn(g, 8, D)
        shape = (f"{label}: xg {tuple(xg.shape)} v {tuple(v.shape)} u3 "
                 f"{tuple(u3.shape)} -> ({M},{D})")
        recs["compose_apply"].append(time_kernel(
            torch, "compose_apply", label, shape,
            lambda xg=xg, v=v, u3=u3: compose_apply_kernel(xg, v, u3),
            lambda xg=xg, v=v, u3=u3: _compose_apply_math(xg, v, u3),
            lambda xg=xg, v=v, u3=u3: torch.einsum("mai,ir,ard->md", xg, v,
                                                   u3),
            f32 * (xg.numel() + v.numel() + u3.numel() + M * D),
            2 * (g * I * 8 * D + M * g * I * D), PEAK_F32_FLOPS, False))
    out = {name: dict(rows[0], more_shapes=rows[1:])
           for name, rows in recs.items()}
    out["compose"]["launch_floor_ms"] = floor
    return out


def fused_head_forward(torch, rn) -> dict:
    """The fused head's two forwards on the card.  Under
    ``torch.no_grad()`` ``compose_dense_apply`` launches compose_apply
    once and nothing else of the port, and the profiler sees no GEMM or
    contraction kernel beside it (layout copies of u may run); with a
    graph recorded, in every mode, the t it saves for the backward is the
    kernel's and within ``DENSE_TOL`` of the reference's residual
    ``einsum("mgi,ir->mgr")``.  Returns the no-grad run's launches and
    device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.compose import _ComposeDense, compose_dense_apply

    print("phase 2: the fused head's forwards (no-grad launches, saved t)")
    seen = {}
    for mode in ("grow_in", "square", "grow_out"):
        g = 1 if mode == "grow_out" else 3
        m = 9 if mode == "square" else 3
        x, vd, ud = rn(16, g * 8, scale=1.0), rn(1, 8, 8), rn(m, 8, 10)
        with torch.no_grad():
            compose_dense_apply(x, vd, ud, 3, mode)  # built and bound
        torch.cuda.synchronize()
        reset_launches()
        # no NaN fill of the output: the trace holds the port's kernels only
        with deterministic(torch, False), torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            compose_dense_apply(x, vd, ud, 3, mode)
            torch.cuda.synchronize()
        counts = {k: n for k, n in LAUNCHES.items() if n}
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        contractions = [k for k in names
                        if any(w in k.lower() for w in CONTRACTION_NAMES)]
        print(f"  compose_dense_apply {mode} p=3 no_grad: launches {counts}; "
              f"device kernels {names}")
        check(counts == {"compose_apply": 1},
              f"fused head {mode}: no-grad launches {counts}")
        check(any("compose_apply" in k for k in names) and not contractions,
              f"fused head {mode}: no-grad device kernels {names}")
        seen[mode] = {"launches": counts, "device_kernels": names}

        x2, v2 = x.clone().requires_grad_(), vd[0].clone().requires_grad_()
        reset_launches()
        y = _ComposeDense.apply(x2, v2, ud, 3, mode)
        check(LAUNCHES["compose_apply"] == 1 and LAUNCHES["rank_apply"] == 0,
              f"fused head {mode}: recorded forward launches {dict(LAUNCHES)}")
        t = torch.einsum("mgi,ir->mgr", x.reshape(16, g, 8), vd[0])
        err(torch, y.grad_fn.saved_tensors[3],
            t[:, 0] if mode == "grow_out" else t, DENSE_TOL,
            f"compose_dense_apply {mode} p=3 saved t vs the reference's "
            "residual")
    return seen


def calibration_record(torch) -> dict:
    """``core.calibration.measure`` on the card (both knobs, no pins) and
    the impl ``prepare_weights`` then picks for each CNN layer under
    ``forward_impl="auto"`` at widths 1-3 (a training batch of 16)."""
    from repro_torch.core.calibration import measure
    from repro_torch.fl import build_image_setup

    cal = measure(DEVICE)
    model, px, _, _ = build_image_setup(num_clients=10, device=DEVICE)
    shape = (16,) + tuple(px[0].shape[1:])
    impls = {p: model.layer_impls(p, 16, "auto", shape, cal)
             for p in (1, 2, 3)}
    return {"conv_rank_overhead": cal.conv_rank_overhead,
            "fused_compose_gain": cal.fused_compose_gain,
            "layer_impls": impls}


def _flat_decode(q, k, v, lengths):
    """Model layout -> the decode kernel's rows (q (B,1,KV,G,D), caches
    (B,S,KV,D), lengths (B,)), for the plain version."""
    B, _, KV, G, D = q.shape
    S = k.shape[1]
    return (q[:, 0].reshape(B * KV * G, D).contiguous(),
            k.permute(0, 2, 1, 3).reshape(B * KV, S, D).contiguous(),
            v.permute(0, 2, 1, 3).reshape(B * KV, S, D).contiguous(),
            lengths.repeat_interleave(KV * G), G)


def _flat_flash(q, k, v):
    """Model layout -> the flash kernel's rows (q (B,Sq,KV,G,D), k/v
    (B,Sk,KV,D)), for the plain version."""
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    return (q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, Sq, D).contiguous(),
            k.permute(0, 2, 1, 3).reshape(B * KV, Sk, D).contiguous(),
            v.permute(0, 2, 1, 3).reshape(B * KV, Sk, D).contiguous(), G)


def _causal_pairs(sq: int, sk: int, window: int = 0) -> int:
    """Unmasked (query, key) pairs of one causal head: the work the
    kernel's data needs."""
    off = sk - sq
    n = 0
    for i in range(sq):
        hi = min(sk, i + off + 1)
        lo = max(0, i + off - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


@nan_empty
def check_attention(torch):
    """Phase 2 for the two attention kernels, f32 and bf16, element-wise
    against their plain versions.  The first case of each kernel and
    type is the one a broken tile loop, mask edge or split merge fails:
    flash over several KV tiles, decode over several uneven splits.
    Returns their timing records."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import (GROUP_ROWS,
                                                      _decode_math,
                                                      _sm_count,
                                                      _split_math,
                                                      decode_attention,
                                                      split_plan)
    from repro_torch.kernels.flash_attention import (_flash_math,
                                                     flash_attention)

    gen = torch.Generator().manual_seed(1)
    dev = torch.device(DEVICE)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen).to(dev,
                                                              torch.int32)

    def splits_of(BKV, G, S):
        return split_plan(BKV * -(-G // GROUP_ROWS), S, _sm_count(dev))[0]

    maxerr = {"decode_attention": 0.0, "flash_attention": 0.0}

    def keep(name, e):
        maxerr[name] = max(maxerr[name], e)

    print("phase 2: attention kernels vs plain versions (f32 and bf16)")
    for dtype in (torch.float32, torch.bfloat16):
        tn = str(dtype).split(".")[1]
        tol = ATTN_TOL[tn]
        # G = 8 (gemma_2b's group) over uneven splits, ragged lengths
        # from 0 to the full cache; then lengths all within the first
        # split (the other splits see no key)
        for BKV, S, D, lo, hi, what in ((3, 3000, 256, 0, 3001, "ragged"),
                                        (2, 3000, 64, 1, 200, "short")):
            q, k, v = (rn(BKV * 8, D, dtype=dtype),
                       rn(BKV, S, D, dtype=dtype), rn(BKV, S, D, dtype=dtype))
            lens = ri(lo, hi, (BKV * 8,))
            lens[0] = 0
            if what == "ragged":
                lens[-1] = S
            got = decode_attention(q, k, v, lens, q_per_kv=8)
            keep("decode_attention", close(
                torch, got, _decode_math(q, k, v, lens, 8), tol,
                f"decode_attention {tn} q({BKV * 8},{D}) kv({BKV},{S},{D}) "
                f"G=8 {what} lengths, {splits_of(BKV, 8, S)} splits"))
            # and against the plain model of the same splits and merge
            keep("decode_attention", close(
                torch, got, _split_math(q, k, v, lens, 8, *split_plan(
                    BKV * -(-8 // GROUP_ROWS), S, _sm_count(dev))), tol,
                f"decode_attention {tn} G=8 {what} vs _split_math"))
        # the transformer path's decode: batch 4, 2p heads of head_dim 8,
        # a 40-slot cache (prompt 8 + 32 steps), lengths 1..40
        for p in (1, 2, 3):
            BH = 4 * 2 * p
            q, k, v = (rn(BH, 8, dtype=dtype), rn(BH, 40, 8, dtype=dtype),
                       rn(BH, 40, 8, dtype=dtype))
            lens = ri(1, 41, (BH,))
            keep("decode_attention", close(
                torch, decode_attention(q, k, v, lens),
                _decode_math(q, k, v, lens), tol,
                f"decode_attention {tn} transformer p={p} q({BH},8) "
                "cache 40"))
        # the reference's sweep, a G = 8 cache over 2 KV heads, and path
        # (g)'s own decode calls (zamba2's shared block: 32 heads of 80,
        # MHA, batch 4; serve's 64-slot cache and the 8-slot step check),
        # in model layout through kernels.ops (the caches read in place)
        for b, S, kv, g, d in ((2, 64, 2, 2, 32), (1, 500, 1, 8, 64),
                               (4, 33, 4, 1, 16), (3, 2000, 2, 8, 80),
                               (4, 64, 32, 1, 80), (4, 8, 32, 1, 80)):
            q, k, v = (rn(b, 1, kv, g, d, dtype=dtype),
                       rn(b, S, kv, d, dtype=dtype),
                       rn(b, S, kv, d, dtype=dtype))
            lens = ri(1, S + 1, (b,))
            lens[0] = S
            got = ops.decode_attention(q, k, v, lens)
            want = _decode_math(*_flat_decode(q, k, v, lens))
            keep("decode_attention", close(
                torch, got, want.reshape(got.shape), tol,
                f"ops.decode_attention {tn} b={b} S={S} kv={kv} g={g} "
                f"d={d}, {splits_of(b * kv, g, S)} splits"))
            if dtype == torch.float32:
                qf, kf, vf, lf, _ = _flat_decode(q, k, v, lens)
                close(torch, got, ref.decode_attention_ref(
                    qf, kf.repeat_interleave(g, 0),
                    vf.repeat_interleave(g, 0), lf).reshape(got.shape),
                    tol, f"ops.decode_attention {tn} b={b} S={S} vs oracle")
        # head_dim 256 (the kernel's widest) and lengths down to 0; an odd
        # head_dim (rows not a whole number of 16 bytes in bf16: plain
        # loads)
        for D, S in ((256, 1000), (100, 700)):
            q, k, v = (rn(8, D, dtype=dtype), rn(2, S, D, dtype=dtype),
                       rn(2, S, D, dtype=dtype))
            lens = ri(0, S + 1, (8,))
            keep("decode_attention", close(
                torch, decode_attention(q, k, v, lens, q_per_kv=4),
                _decode_math(q, k, v, lens, 4), tol,
                f"decode_attention {tn} q(8,{D}) kv(2,{S},{D}) G=4 ragged"))

        # D 80 (stablelm_3b, zamba2) and 256 (gemma_2b), Sq not a
        # multiple of the 128-query tile, several KV tiles; Sq < Sk at
        # D 256 (the widest shared memory), non-causal with and without
        # a window; an odd D (plain loads)
        for BKV, G, Sq, Sk, D, causal, w in ((1, 2, 300, 300, 80, True, 0),
                                             (2, 1, 257, 257, 256, True, 0),
                                             (2, 1, 70, 130, 256, True, 0),
                                             (2, 2, 64, 64, 80, False, 0),
                                             (1, 1, 50, 50, 80, False, 16),
                                             (1, 2, 150, 150, 100, True, 0)):
            q, k, v = (rn(BKV * G, Sq, D, dtype=dtype),
                       rn(BKV, Sk, D, dtype=dtype),
                       rn(BKV, Sk, D, dtype=dtype))
            keep("flash_attention", close(
                torch, flash_attention(q, k, v, causal=causal, window=w,
                                       q_per_kv=G),
                _flash_math(q, k, v, causal, w, G), tol,
                f"flash_attention {tn} q({BKV * G},{Sq},{D}) "
                f"kv({BKV},{Sk},{D}) causal={causal} window={w}"))
        # Sq != Sk: non-causal first (the cross-attention's alignment:
        # every query sees every key), fewer and more queries than keys,
        # then causal, queries aligned to the end of the keys
        for BKV, G, Sq, Sk, D, causal in ((2, 2, 70, 300, 64, False),
                                          (1, 2, 300, 70, 64, False),
                                          (2, 1, 130, 257, 80, False),
                                          (2, 2, 70, 300, 64, True)):
            q, k, v = (rn(BKV * G, Sq, D, dtype=dtype),
                       rn(BKV, Sk, D, dtype=dtype),
                       rn(BKV, Sk, D, dtype=dtype))
            keep("flash_attention", close(
                torch, flash_attention(q, k, v, causal=causal, q_per_kv=G),
                _flash_math(q, k, v, causal, 0, G), tol,
                f"flash_attention {tn} Sq!=Sk q({BKV * G},{Sq},{D}) "
                f"kv({BKV},{Sk},{D}) causal={causal}"))
        # a key count a KV row: 0 (zeros), 1, inside a tile, a tile edge
        # (64: the bf16 kernel's tile, two of the f32 kernel's) and every
        # key; non-causal at Sq != Sk (the cross-attention's call), then
        # causal at Sq == Sk
        for BKV, G, Sq, Sk, D, causal in ((5, 2, 100, 300, 64, False),
                                          (5, 1, 150, 150, 80, True)):
            q, k, v = (rn(BKV * G, Sq, D, dtype=dtype),
                       rn(BKV, Sk, D, dtype=dtype),
                       rn(BKV, Sk, D, dtype=dtype))
            counts = torch.tensor([0, 1, 37, 64, Sk], dtype=torch.int32,
                                  device=dev)
            got = flash_attention(q, k, v, causal=causal, q_per_kv=G,
                                  kv_len=counts)
            keep("flash_attention", close(
                torch, got, _flash_math(q, k, v, causal, 0, G, counts), tol,
                f"flash_attention {tn} kv_len {counts.tolist()} "
                f"q({BKV * G},{Sq},{D}) kv({BKV},{Sk},{D}) "
                f"causal={causal}"))
            check(float(got[:G].float().abs().max()) == 0.0,
                  f"flash_attention {tn}: a row of kv_len 0 is not zeros")
        for b, S, kv, g, d, w in ((1, 64, 1, 1, 32, 0), (2, 100, 2, 3, 32, 0),
                                  (1, 128, 4, 1, 64, 32),
                                  (2, 33, 1, 4, 16, 8)):
            q, k, v = (rn(b, S, kv, g, d, dtype=dtype),
                       rn(b, S, kv, d, dtype=dtype),
                       rn(b, S, kv, d, dtype=dtype))
            got = ops.flash_attention(q, k, v, window=w)
            qf, kf, vf, G = _flat_flash(q, k, v)
            want = _flash_math(qf, kf, vf, True, w, G)
            want = want.reshape(b, kv, g, S, d).permute(0, 3, 1, 2, 4)
            keep("flash_attention", close(
                torch, got, want, tol,
                f"ops.flash_attention {tn} b={b} S={S} kv={kv} g={g} d={d} "
                f"window={w}"))
            if dtype == torch.float32:
                o = ref.attention_ref(qf, kf.repeat_interleave(G, 0),
                                      vf.repeat_interleave(G, 0), window=w)
                close(torch, got,
                      o.reshape(b, kv, g, S, d).permute(0, 3, 1, 2, 4), tol,
                      f"ops.flash_attention {tn} b={b} S={S} vs oracle")
        # paths (p) and (q)'s own calls, in model layout through
        # kernels.ops: gemma's MQA (G 8, D 256), stablelm's MHA (D 80),
        # deepseek's G 7 (padded to the decode kernel's 16-row group, D
        # 128) and granite's MQA of 48 (3 row groups a key); decode
        # lengths ragged
        flash_calls, decode_calls = dense_attention_shapes()
        for label, b, S, kv, g, d, w in flash_calls:
            q, k, v = (rn(b, S, kv, g, d, dtype=dtype),
                       rn(b, S, kv, d, dtype=dtype),
                       rn(b, S, kv, d, dtype=dtype))
            got = ops.flash_attention(q, k, v, window=w)
            qf, kf, vf, G = _flat_flash(q, k, v)
            want = _flash_math(qf, kf, vf, True, w, G)
            keep("flash_attention", close(
                torch, got, want.reshape(b, kv, g, S, d).permute(
                    0, 3, 1, 2, 4), tol,
                f"ops.flash_attention {tn} {label}: b={b} S={S} kv={kv} "
                f"g={g} d={d} window={w}"))
            del q, k, v, got, want, qf, kf, vf
        for label, b, S, kv, g, d, _ in decode_calls:
            q, k, v = (rn(b, 1, kv, g, d, dtype=dtype),
                       rn(b, S, kv, d, dtype=dtype),
                       rn(b, S, kv, d, dtype=dtype))
            lens = ri(1, S + 1, (b,))
            lens[0] = S
            got = ops.decode_attention(q, k, v, lens)
            want = _decode_math(*_flat_decode(q, k, v, lens))
            keep("decode_attention", close(
                torch, got, want.reshape(got.shape), tol,
                f"ops.decode_attention {tn} {label}: b={b} S={S} kv={kv} "
                f"g={g} d={d}, {splits_of(b * kv, g, S)} splits"))
        # path (u)'s calls, in model layout through kernels.ops: the
        # encoder's non-causal flash, the decoder's causal one, the
        # cross-attention's queries over the memory with a frame count a
        # row, and decode over the self cache and over the memory
        flash_calls, decode_calls = audio_attention_shapes()
        for label, b, sq, sk, kv, g, d, causal, counts in flash_calls:
            q = rn(b, sq, kv, g, d, dtype=dtype)
            k, v = rn(b, sk, kv, d, dtype=dtype), rn(b, sk, kv, d,
                                                     dtype=dtype)
            n = (None if counts is None else torch.tensor(
                counts, dtype=torch.int32, device=dev))
            got = ops.flash_attention(q, k, v, causal=causal, kv_len=n)
            qf, kf, vf, G = _flat_flash(q, k, v)
            want = _flash_math(qf, kf, vf, causal, 0, G,
                               None if n is None
                               else n.repeat_interleave(kv))
            keep("flash_attention", close(
                torch, got, want.reshape(b, kv, g, sq, d).permute(
                    0, 3, 1, 2, 4), tol,
                f"ops.flash_attention {tn} {label}: b={b} Sq={sq} Sk={sk} "
                f"kv={kv} g={g} d={d} causal={causal} kv_len={counts}"))
            del q, k, v, got, want, qf, kf, vf
        for label, b, S, kv, g, d, lengths in decode_calls:
            q = rn(b, 1, kv, g, d, dtype=dtype)
            k, v = rn(b, S, kv, d, dtype=dtype), rn(b, S, kv, d, dtype=dtype)
            lens = (ri(1, S + 1, (b,)) if lengths is None else torch.tensor(
                lengths, dtype=torch.int32, device=dev))
            got = ops.decode_attention(q, k, v, lens)
            want = _decode_math(*_flat_decode(q, k, v, lens))
            keep("decode_attention", close(
                torch, got, want.reshape(got.shape), tol,
                f"ops.decode_attention {tn} {label}: b={b} S={S} kv={kv} "
                f"g={g} d={d} lengths {lens.tolist()}, "
                f"{splits_of(b * kv, g, S)} splits"))
        torch.cuda.empty_cache()

    # no backward, as in the reference: asking for one raises
    for name, fn in (("decode_attention", lambda a: decode_attention(
            a, rn(4, 40, 8), rn(4, 40, 8), ri(1, 41, (4,)))),
                     ("flash_attention", lambda a: flash_attention(
            a[:, None].expand(4, 40, 8).contiguous(), rn(4, 40, 8),
            rn(4, 40, 8)))):
        try:
            fn(rn(4, 8).requires_grad_())
        except RuntimeError as e:
            check("no backward" in str(e), f"{name}: wrong error {e}")
        else:
            raise SmokeFailure(f"{name} accepted an input that needs grad")
    print("  both refuse inputs that require grad")

    print("phase 2: attention timing (main-path shapes and one realistic "
          "shape each)")
    records = {}

    # decode, main path (e)'s widest call: width 3, batch 4 -> 24 rows,
    # head_dim 8, the last step (all 40 cache slots valid), f32
    B, H, S, D = 4, 6, 40, 8
    q, k, v = rn(B * H, D), rn(B * H, S, D), rn(B * H, S, D)
    lens = torch.full((B * H,), S, dtype=torch.int32, device=dev)
    path = time_kernel(
        torch, "decode_attention", "path (e)", "q (24,8) kv (24,40,8) f32, "
        "lengths 40", lambda: decode_attention(q, k, v, lens),
        lambda: _decode_math(q, k, v, lens),
        lambda: F.scaled_dot_product_attention(
            q.view(B, H, 1, D), k.view(B, H, S, D), v.view(B, H, S, D)),
        4 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lens.numel(),
        4 * D * int(lens.sum()), PEAK_F32_FLOPS, big=False)
    # decode, realistic (DECODE_AT_SCALE), bf16, every length full: the
    # kernel layout, then kernels.ops on the model layout (B, S, KV, D)
    B, H, KV, S, D = (DECODE_AT_SCALE[x] for x in ("B", "H", "KV", "S", "D"))
    G = H // KV
    bf = torch.bfloat16
    q = rn(B * H, D, dtype=bf)
    k = torch.randn((B, S, KV, D), device=dev, dtype=bf)
    v = torch.randn((B, S, KV, D), device=dev, dtype=bf)
    lens = torch.full((B * H,), S, dtype=torch.int32, device=dev)
    kr = k.permute(0, 2, 1, 3).reshape(B * KV, S, D)  # a view while KV = 1
    vr = v.permute(0, 2, 1, 3).reshape(B * KV, S, D)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lens.numel()
    flops = 4 * D * int(lens.sum())
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.view(B, H, 1, D), kr.view(B, KV, S, D), vr.view(B, KV, S, D),
        enable_gqa=True)
    keep("decode_attention", close(
        torch, decode_attention(q, kr, vr, lens, q_per_kv=G),
        _decode_math(q, kr, vr, lens, G), ATTN_TOL["bfloat16"],
        f"decode_attention bf16 decode_32k gemma_2b, "
        f"{splits_of(B * KV, G, S)} splits"))
    real = time_kernel(
        torch, "decode_attention", "decode_32k x gemma_2b",
        f"q ({B * H},{D}) kv ({B * KV},{S},{D}) bf16 G={G}, lengths {S}",
        lambda: decode_attention(q, kr, vr, lens, q_per_kv=G),
        lambda: _decode_math(q, kr, vr, lens, G), sdpa, nbytes, flops,
        PEAK_BF16_FLOPS, big=True)
    qm, lb = q.view(B, 1, KV, G, D), lens[::H].contiguous()
    om = ops.decode_attention(qm, k, v, lb)
    keep("decode_attention", close(
        torch, om.reshape(B * H, D), _decode_math(q, kr, vr, lens, G),
        ATTN_TOL["bfloat16"], "ops.decode_attention bf16 decode_32k gemma_2b "
        "model layout"))
    del om
    model = time_kernel(
        torch, "decode_attention", "decode_32k x gemma_2b, kernels.ops",
        f"q ({B},1,{KV},{G},{D}) caches ({B},{S},{KV},{D}) bf16, lengths "
        f"({B},) {S}", lambda: ops.decode_attention(qm, k, v, lb),
        lambda: _decode_math(q, kr, vr, lens, G), sdpa, nbytes, flops,
        PEAK_BF16_FLOPS, big=True)
    # decode at path (p)'s own call: serve's last step on gemma_2b (batch
    # 4, a 64-slot cache, every slot valid), model layout, bf16
    g2 = dense_attention_shapes()[1][0]
    _, B, S, KV, G, D, _ = g2
    qg = rn(B, 1, KV, G, D, dtype=bf)
    kg, vg = rn(B, S, KV, D, dtype=bf), rn(B, S, KV, D, dtype=bf)
    lg = torch.full((B,), S, dtype=torch.int32, device=dev)
    flat = _flat_decode(qg, kg, vg, lg)
    gemma = time_kernel(
        torch, "decode_attention", "path (p) serve, gemma_2b",
        f"q ({B},1,{KV},{G},{D}) caches ({B},{S},{KV},{D}) bf16, lengths "
        f"{S}", lambda: ops.decode_attention(qg, kg, vg, lg),
        lambda: _decode_math(*flat),
        lambda: F.scaled_dot_product_attention(
            qg.view(B, KV * G, 1, D), kg.permute(0, 2, 1, 3),
            vg.permute(0, 2, 1, 3), enable_gqa=True),
        2 * (2 * qg.numel() + kg.numel() + vg.numel()) + 4 * B,
        4 * D * B * KV * G * S, PEAK_BF16_FLOPS, big=False)
    # decode at path (u)'s cross-attention: seamless's 4 serve rows over
    # the encoder memory (16 heads of 64, 4096 frames) at the prefill's
    # ragged valid lengths, model layout, bf16; the bound counts the
    # frames these lengths read
    B, S, KV, G, D = 4, AUDIO_FRAMES, 16, 1, 64
    qa = rn(B, 1, KV, G, D, dtype=bf)
    ka, va = rn(B, S, KV, D, dtype=bf), rn(B, S, KV, D, dtype=bf)
    la = torch.tensor(AUDIO_VALID, dtype=torch.int32, device=dev)
    flat = _flat_decode(qa, ka, va, la)
    keep("decode_attention", close(
        torch, ops.decode_attention(qa, ka, va, la).reshape(B * KV * G, D),
        _decode_math(*flat), ATTN_TOL["bfloat16"],
        "ops.decode_attention bf16 path (u) cross decode"))
    amask = (torch.arange(S, device=dev)[None, :] < la[:, None])[:, None,
                                                                 None]
    valid = int(la.sum())
    cross_decode = time_kernel(
        torch, "decode_attention", "path (u) cross decode, seamless",
        f"q ({B},1,{KV},{G},{D}) memory ({B},{S},{KV},{D}) bf16, lengths "
        f"{list(AUDIO_VALID)}", lambda: ops.decode_attention(qa, ka, va, la),
        lambda: _decode_math(*flat),
        lambda: F.scaled_dot_product_attention(
            qa.view(B, KV * G, 1, D), ka.permute(0, 2, 1, 3),
            va.permute(0, 2, 1, 3), attn_mask=amask),
        2 * (2 * qa.numel() + 2 * valid * KV * D) + 4 * B,
        4 * D * KV * G * valid, PEAK_BF16_FLOPS, big=False)
    del qa, ka, va, flat
    records["decode_attention"] = dict(path, at_scale=real,
                                       ops_model_layout=model, gemma=gemma,
                                       cross_decode=cross_decode)
    del q, k, v, kr, vr, qm
    torch.cuda.empty_cache()

    # flash, main path (f)'s call: batch 2, 256 tokens, 2 KV heads x 4
    # query heads, head_dim 64, causal, f32
    B, S, KV, G, D = 2, 256, 2, 4, 64
    q, k, v = rn(B * KV * G, S, D), rn(B * KV, S, D), rn(B * KV, S, D)
    pairs = B * KV * G * _causal_pairs(S, S)
    path = time_kernel(
        torch, "flash_attention", "path (f)",
        "q (16,256,64) kv (4,256,64) f32 G=4 causal",
        lambda: flash_attention(q, k, v, q_per_kv=G),
        lambda: _flash_math(q, k, v, True, 0, G),
        lambda: F.scaled_dot_product_attention(
            q.view(B, KV * G, S, D), k.view(B, KV, S, D),
            v.view(B, KV, S, D), is_causal=True, enable_gqa=True),
        4 * (2 * q.numel() + k.numel() + v.numel()), 4 * D * pairs,
        PEAK_F32_FLOPS, big=False)
    extra = {}
    # flash at path (p)'s own call: gemma_2b's 4 x 512 prefill (8 query
    # heads on 1 KV head, head_dim 256), bf16, causal
    _, B, S, KV, G, D, _ = dense_attention_shapes()[0][0]
    q = rn(B * KV * G, S, D, dtype=bf)
    k, v = rn(B * KV, S, D, dtype=bf), rn(B * KV, S, D, dtype=bf)
    keep("flash_attention", close(
        torch, flash_attention(q, k, v, q_per_kv=G),
        _flash_math(q, k, v, True, 0, G), ATTN_TOL["bfloat16"],
        "flash_attention bf16 path (p) prefill, gemma_2b"))
    extra["gemma"] = time_kernel(
        torch, "flash_attention", "path (p) prefill, gemma_2b",
        f"q ({B * KV * G},{S},{D}) kv ({B * KV},{S},{D}) bf16 G={G} causal",
        lambda: flash_attention(q, k, v, q_per_kv=G),
        lambda: _flash_math(q, k, v, True, 0, G),
        lambda: F.scaled_dot_product_attention(
            q.view(B, KV * G, S, D), k.view(B, KV, S, D),
            v.view(B, KV, S, D), is_causal=True, enable_gqa=True),
        2 * (2 * q.numel() + k.numel() + v.numel()),
        4 * D * B * KV * G * _causal_pairs(S, S), PEAK_BF16_FLOPS,
        big=False)
    del q, k, v
    # flash, bf16 causal: path (g)'s own call, then realistic
    for key, label, shape, big in (
            ("path_g", "path (g) prefill, zamba2", FLASH_PATH_G, False),
            ("at_scale", "train_4k x stablelm_3b", FLASH_AT_SCALE, True)):
        B, H, S, D = (shape[x] for x in ("B", "H", "S", "D"))
        q, k, v = (rn(B * H, S, D, dtype=bf), rn(B * H, S, D, dtype=bf),
                   rn(B * H, S, D, dtype=bf))
        keep("flash_attention", close(
            torch, flash_attention(q, k, v), _flash_math(q, k, v),
            ATTN_TOL["bfloat16"], f"flash_attention bf16 {label}"))
        pairs = B * H * _causal_pairs(S, S)
        extra[key] = time_kernel(
            torch, "flash_attention", label,
            f"q/k/v ({B * H},{S},{D}) bf16 causal",
            lambda: flash_attention(q, k, v),
            lambda: _flash_math(q, k, v),
            lambda: F.scaled_dot_product_attention(
                q.view(B, H, S, D), k.view(B, H, S, D), v.view(B, H, S, D),
                is_causal=True),
            2 * 4 * q.numel(), 4 * D * pairs, PEAK_BF16_FLOPS, big=big)
        del q, k, v
        torch.cuda.empty_cache()
    # flash at path (u)'s two new calls, bf16, kernel layout: the
    # encoder's non-causal 4096 x 4096 (batch 4, 16 heads of 64), and the
    # cross-attention's 512 decoder queries over the 4096-frame memory
    # at the prefill's ragged valid lengths (a count a KV row); the
    # bound counts the pairs and frames these lengths need
    B, H, D = 4, 16, 64
    for key, label, sq, counts in (
            ("encoder", "path (u) encoder, seamless", AUDIO_FRAMES, None),
            ("cross_prefill", "path (u) cross prefill, seamless",
             PREFILL_LEN, AUDIO_VALID)):
        sk = AUDIO_FRAMES
        q = rn(B * H, sq, D, dtype=bf)
        k, v = rn(B * H, sk, D, dtype=bf), rn(B * H, sk, D, dtype=bf)
        n = (None if counts is None else torch.tensor(
            counts, dtype=torch.int32, device=dev).repeat_interleave(H))
        keys = B * H * sk if n is None else int(n.sum())
        mask = (None if n is None else (torch.arange(sk, device=dev)[None]
                                        < n[:, None]).view(B, H, 1, sk))
        keep("flash_attention", close(
            torch, flash_attention(q, k, v, causal=False, kv_len=n),
            _flash_math(q, k, v, False, 0, 1, n), ATTN_TOL["bfloat16"],
            f"flash_attention bf16 {label}"))
        extra[key] = time_kernel(
            torch, "flash_attention", label,
            f"q ({B * H},{sq},{D}) kv ({B * H},{sk},{D}) bf16 non-causal"
            + ("" if counts is None else f", kv_len {list(counts)} a row"),
            lambda: flash_attention(q, k, v, causal=False, kv_len=n),
            lambda: _flash_math(q, k, v, False, 0, 1, n),
            lambda: F.scaled_dot_product_attention(
                q.view(B, H, sq, D), k.view(B, H, sk, D), v.view(B, H, sk, D),
                attn_mask=mask),
            2 * (2 * q.numel() + 2 * keys * D) + (0 if n is None else 4 *
                                                  n.numel()),
            4 * D * sq * keys, PEAK_BF16_FLOPS, big=key == "encoder")
        del q, k, v, mask
        torch.cuda.empty_cache()
    records["flash_attention"] = dict(path, **extra)
    for name in records:
        records[name]["max_abs_err"] = maxerr[name]
    records["compose_zoo"] = zoo_compose(torch, rn)
    return records


# the zoo's compose-then-matmul shapes: seamless-m4t-medium's factorized
# linears at max width 2, rank d / 4 (d 1024): basis (1, I, 256) x coeff
# (4, 256, O) for the attention projections (I = O = 512), the MLP's up
# (512 -> 2048) and down (2048 -> 512)
ZOO_COMPOSE = (("attention projection", 512, 512), ("mlp up", 512, 2048),
               ("mlp down", 2048, 512))


def zoo_compose(torch, rn) -> dict:
    """compose at the zoo's compose-then-matmul shapes (``ZOO_COMPOSE``,
    f32), held against its plain version within ``DENSE_TOL`` and timed
    at the attention projection's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.compose import compose_kernel

    print("phase 2: compose at the zoo's compose-then-matmul shapes")
    worst, rec = 0.0, None
    for label, I, O in ZOO_COMPOSE:
        v, u = rn(1, I, 256), rn(4, 256, O)
        worst = max(worst, err(
            torch, compose_kernel(v, u), ref.compose_ref(v, u), DENSE_TOL,
            f"compose zoo {label}: basis (1,{I},256) coeff (4,256,{O})"))
        if rec is None:
            uf = u.transpose(0, 1).reshape(256, 4 * O).contiguous()
            rec = time_kernel(
                torch, "compose", f"zoo {label}",
                f"basis (1,{I},256) x coeff (4,256,{O}) -> (1,{I},{4 * O})",
                lambda v=v, u=u: compose_kernel(v, u),
                lambda v=v, u=u: ref.compose_ref(v, u),
                lambda v=v, uf=uf: torch.matmul(v, uf),
                4 * (v.numel() + u.numel() + I * 4 * O), 2 * I * 256 * 4 * O,
                PEAK_F32_FLOPS, big=False)
    rec["max_abs_err"] = worst
    return rec


@nan_empty
def check_ssd_rmsnorm(torch):
    """Phase 2 for the SSD-chunk and RMSNorm kernels, f32 and bf16, at
    path (g)'s shapes, the reference's sweep shapes and with ``heads >
    1``.  Returns their timing records."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmsnorm import _rmsnorm_math, rmsnorm
    from repro_torch.kernels.ssd_chunk import _ssd_math, ssd_chunk

    gen = torch.Generator().manual_seed(3)
    dev = torch.device(DEVICE)

    def rn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev, dtype)

    def cum_of(R, Q, steep=1.0):
        # a cumulative log-decay as the model makes it: -cumsum(dt * A)
        la = F.softplus(torch.randn((R, Q), generator=gen)) * steep
        return (-torch.cumsum(la, 1)).to(dev)

    def ssd_args(G, heads, Q, N, P, dtype, steep=1.0):
        R = G * heads
        return (rn(G, Q, N, dtype=dtype), rn(G, Q, N, dtype=dtype),
                rn(R, Q, P, dtype=dtype), cum_of(R, Q, steep),
                rn(R, N, P, dtype=dtype))

    maxerr = {"rmsnorm": 0.0, "ssd_chunk": 0.0}

    def keep(name, e):
        maxerr[name] = max(maxerr[name], e)

    print("phase 2: rmsnorm and ssd_chunk vs plain versions (f32 and bf16)")
    for dtype in (torch.float32, torch.bfloat16):
        tn = str(dtype).split(".")[1]
        # path (g)'s rows (prefill 4 x 512, decode batch 4) at d_model and
        # d_inner, the reference's sweep, an unaligned width (scalar
        # loads) and a wide one (one-pass kernel); then every other width
        # of the zoo's rmsnorm configs (one-pass, few rows), widths that
        # no one-pass instance takes (generic kernel: 1000, 65536) and a
        # row start that is not 16-byte aligned (generic, scalar loads);
        # then paths (p)-(t)'s rows: prefill, decode, training and the
        # f32 layers against the CPU, at d_model (gemma and olmoe 2048,
        # kimi 7168, qwen2-vl 3584) and the xLSTM's out_norm (1536) and
        # gn (768)
        for shape in ((2048, 2560), (2048, 5120), (4, 2560), (4, 5120),
                      (4, 64), (2, 7, 96), (1, 130, 32), (3, 100),
                      (8, 8192), (3, 128), (5, 256), (6, 2048), (7, 3584),
                      (4, 7168), (5, 1000), (2, 65536), "misaligned",
                      (2048, 2048), (4, 2048), (512, 2048), (2048, 7168),
                      (2048, 3584), (4, 3584), (256, 3584), (2048, 1536),
                      (4, 1536), (2048, 768), (4, 768), (512, 768)):
            if shape == "misaligned":  # a contiguous view at element 1
                x = rn(3 * 2560 + 1, dtype=dtype)[1:].view(3, 2560)
            else:
                x = rn(*shape, dtype=dtype)
            sc = rn(x.shape[-1], scale=0.1) + 1.0
            keep("rmsnorm", close(torch, rmsnorm(x, sc),
                                  _rmsnorm_math(x, sc, 1e-6), RMS_TOL[tn],
                                  f"rmsnorm {tn} {shape}"))
            if dtype == torch.float32:
                close(torch, ops.rmsnorm(x, sc), ref.rmsnorm_ref(x, sc),
                      RMS_TOL[tn], f"ops.rmsnorm {tn} {shape} vs oracle")
        # a gentle decay (exp(cum_i) still ~0.1 at the chunk's end, so the
        # carry-in of every query tile counts: under the model's usual
        # decay it vanishes past the first rows), path (g)'s prefill call
        # (batch 4 x 512 tokens: 2 chunks of 256, 80 heads of P = 64
        # sharing B/C of N = 64), the smoke config's
        # (chunk 32, N 8, P 16, 16 heads), the reference's sweep
        # (replicated rows), a group of 5 heads over a ragged chunk, the
        # widest state the kernel takes (N = 128), and a steep decay
        # whose upper triangle overflows exp; then the bf16 kernel's other
        # instances (N = P = 32; N = 48 and P = 24 zero-padded), a chunk
        # of one step, a long one that still fits shared memory (Q = 512)
        # and one that does not (Q = 1024: the FFMA kernel, by shape)
        cases = [("gentle decay", (2, 8, 256, 64, 64, 0.01)),
                 ("path (g) prefill", (8, 80, 256, 64, 64, 1.0)),
                 ("smoke config", (6, 16, 32, 8, 16, 1.0)),
                 ("G=3 heads=5 Q=100", (3, 5, 100, 64, 64, 1.0)),
                 ("N=128", (2, 3, 96, 128, 64, 1.0)),
                 ("steep decay", (2, 4, 64, 16, 32, 40.0)),
                 ("N=32 P=32", (2, 3, 64, 32, 32, 1.0)),
                 ("N=48 P=24", (2, 2, 80, 48, 24, 1.0)),
                 ("Q=1", (2, 2, 1, 16, 16, 1.0)),
                 ("Q=512", (1, 2, 512, 64, 64, 1.0)),
                 ("Q=1024", (1, 2, 1024, 64, 64, 1.0))]
        cases += [(f"sweep b={b} q={q} n={n} p={p}", (b, 1, q, n, p, 1.0))
                  for b, q, n, p in ((4, 32, 8, 16), (2, 64, 16, 32),
                                     (1, 16, 4, 8), (3, 24, 4, 12))]
        for label, (G, heads, Q, N, P, steep) in cases:
            a = ssd_args(G, heads, Q, N, P, dtype, steep)
            got = ssd_chunk(*a, heads=heads)
            check(bool(torch.isfinite(got).all()),
                  f"ssd_chunk {tn} {label}: non-finite output")
            keep("ssd_chunk", close(torch, got, _ssd_math(*a, heads),
                                    SSD_TOL[tn], f"ssd_chunk {tn} {label}"))
            if heads > 1 and dtype == torch.float32:
                rep = [t.repeat_interleave(heads, 0) for t in a[:2]]
                close(torch, ops.ssd_chunk(*rep, *a[2:]), got, SSD_TOL[tn],
                      f"ops.ssd_chunk {tn} {label} replicated vs heads")
                close(torch, got, ref.ssd_chunk_ref(*rep, *a[2:]),
                      SSD_TOL[tn], f"ssd_chunk {tn} {label} vs oracle")
    for name, fn in (("rmsnorm", lambda t: rmsnorm(t, rn(8))),
                     ("ssd_chunk", lambda t: ssd_chunk(
                         t, rn(1, 8, 8), rn(1, 8, 8), cum_of(1, 8),
                         rn(1, 8, 8)))):
        try:
            fn(rn(1, 8, 8).requires_grad_() if name == "ssd_chunk"
               else rn(4, 8).requires_grad_())
        except RuntimeError as e:
            check("no backward" in str(e), f"{name}: wrong error {e}")
        else:
            raise SmokeFailure(f"{name} accepted an input that needs grad")
    print("  both refuse inputs that require grad")

    print("phase 2: rmsnorm / ssd_chunk timing (path (g)'s widest shape and "
          "prefill_32k x zamba2, batch cut from 32 to 2)")
    bf = torch.bfloat16
    records = {}

    def rms_case(rows, d, label, big):
        x, sc = rn(rows, d, dtype=bf), rn(d, scale=0.1) + 1.0
        keep("rmsnorm", close(torch, rmsnorm(x, sc),
                              _rmsnorm_math(x, sc, 1e-6),
                              RMS_TOL["bfloat16"], f"rmsnorm bf16 {label}"))
        scb = sc.to(bf)
        return time_kernel(
            torch, "rmsnorm", label, f"x ({rows},{d}) bf16, scale ({d},) f32",
            lambda: rmsnorm(x, sc), lambda: _rmsnorm_math(x, sc, 1e-6),
            lambda: F.rms_norm(x, (d,), scb, 1e-6),
            2 * 2 * x.numel() + 4 * d, 4 * x.numel(), PEAK_BF16_FLOPS, big)

    path = rms_case(2048, 5120, "path (g) prefill d_inner", big=False)
    decode = {f"(4,{d})": rms_case(4, d, f"path (g) decode d={d}", big=False)
              for d in (2560, 5120)}
    real = rms_case(RMS_AT_SCALE["rows"], RMS_AT_SCALE["d"],
                    "prefill_32k x zamba2", big=True)
    # path (p)'s own calls: gemma_2b's 4 x 512 prefill and a decode step
    gemma = {"prefill (2048,2048)": rms_case(2048, 2048,
                                             "path (p) prefill, gemma_2b",
                                             big=False),
             "decode (4,2048)": rms_case(4, 2048, "path (p) decode, gemma_2b",
                                         big=False)}
    records["rmsnorm"] = dict(path, at_scale=real, decode=decode,
                              gemma=gemma)
    torch.cuda.empty_cache()

    def ssd_case(G, heads, Q, N, P, label, big):
        a = ssd_args(G, heads, Q, N, P, bf)
        R = G * heads
        got = ssd_chunk(*a, heads=heads)
        keep("ssd_chunk", close(torch, got, _ssd_math(*a, heads),
                                SSD_TOL["bfloat16"],
                                f"ssd_chunk bf16 {label}"))
        del got
        # no single PyTorch call computes the block: the two-call
        # reference is the einsum oracle on B/C replicated per head
        rep = [t.repeat_interleave(heads, 0) for t in a[:2]]
        pairs = Q * (Q + 1) // 2  # the causal half this data needs
        # the scores once per group (the heads share them), w . xw and
        # the carry per head
        flops = 2 * G * pairs * N + R * (2 * pairs * P + 2 * Q * N * P)
        nbytes = (2 * (2 * G * Q * N + 2 * R * Q * P + R * N * P)
                  + 4 * R * Q)
        rec = time_kernel(
            torch, "ssd_chunk", label,
            f"cb/bb ({G},{Q},{N}) xw ({R},{Q},{P}) h_in ({R},{N},{P}) "
            f"bf16, cum f32, heads {heads}",
            lambda: ssd_chunk(*a, heads=heads),
            lambda: _ssd_math(*a, heads), None, nbytes, flops,
            PEAK_BF16_FLOPS, big,
            two_call=lambda: ref.ssd_chunk_ref(*rep, *a[2:]))
        del a, rep
        torch.cuda.empty_cache()
        return rec

    path = ssd_case(8, 80, 256, 64, 64, "path (g) prefill", big=False)
    s = SSD_AT_SCALE
    real = ssd_case(s["B"] * s["nc"], s["H"], s["Q"], s["N"], s["P"],
                    "prefill_32k x zamba2", big=True)
    records["ssd_chunk"] = dict(path, at_scale=real)
    for name in records:
        records[name]["max_abs_err"] = maxerr[name]
    return records


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

PATHS = {
    "a": ("heroes", dict(forward_impl="materialize", agg_backend="host"),
          {"compose"}),
    "b": ("heroes", dict(forward_impl="rank_space", agg_backend="host"),
          {"compose", "conv_rank", "rank_apply"}),
    "c": ("heroes", dict(forward_impl="auto", fused_compose_gain=0.5,
                         conv_rank_overhead=1.0, agg_backend="host"),
          {"compose", "conv_rank", "compose_apply"}),
    "d": ("fedavg", dict(forward_impl="materialize", agg_backend="host"),
          set()),
}
# path (e): the composed transformer trains, then serves
TEXT_RUNS = {
    "heroes": dict(forward_impl="rank_space", agg_backend="host"),
    "fedavg": dict(forward_impl="materialize", agg_backend="host"),
}
TEXT_EXPECT = {"decode_attention", "compose", "rank_apply"}
ROUNDS = 3
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 8, 32
# path (h): the paper's scheme comparison (Figs. 4-6) under FLConfig's
# default merge backend (collective).  Every scheme takes path (c)'s
# pinned calibration, so flanc's and heroes' kernel mix does not move
# with the host and no run measures one; the dense schemes ignore it.
SCHEMES = ("fedavg", "adp", "heterofl", "flanc", "fedprox", "heroes")
SCHEME_KNOBS = dict(forward_impl="auto", fused_compose_gain=0.5,
                    conv_rank_overhead=1.0)
SCHEME_KERNELS = {"flanc": {"compose", "conv_rank"},
                  "heroes": {"compose", "conv_rank"}}
# the accuracy the to-accuracy metrics are read at: what 3 rounds of
# this setup reach (examples/federated_training.py reads 0.5 after 30)
TTA_TARGET = 0.2
# path (i): semi-async events (4 each, the fastest 2 of 4 in flight per
# event) and a sample-weighted sync run, on 8 clients, whose shards
# differ in size (the 10-client setup's are equal, so its weights are
# all 1): (scheme, knobs, events, clients)
ASYNC_RUNS = (
    ("heroes", dict(round_mode="semi_async", async_k=2), 4, 10),
    ("fedavg", dict(round_mode="semi_async", async_k=2), 4, 10),
    ("heroes", dict(sample_weighted=True), ROUNDS, 8),
)


def timed_merges(torch, runner, device) -> list:
    """Wrap ``runner.aggregator.aggregate`` to append each call's host
    seconds, synchronised before and after, to the returned list."""
    merge = runner.aggregator.aggregate
    secs = []

    def timed(*args, **kw):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = merge(*args, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return out

    runner.aggregator.aggregate = timed
    return secs


def run_path(torch, setup, scheme, knobs, device, rounds=ROUNDS,
             clients=10, per_round=4, hook=None):
    """``rounds`` rounds of ``scheme`` on the image (CNN, ``clients``
    clients), text (transformer, 8 clients), resnet (``cifar10``,
    ``clients`` clients) or rnn (``shakespeare``, ``clients`` clients)
    setup, ``per_round`` clients per round; ``hook(runner)``, if given,
    runs before the first round.  Returns (runner, seconds per round,
    summary, merge seconds per round)."""
    from repro_torch.fl import (FLConfig, build_image_setup, build_runner,
                                build_text_setup, summarize)

    if setup in ("image", "resnet", "rnn"):
        if setup == "rnn":
            model, px, py, tb = build_text_setup(
                task="shakespeare", num_clients=clients, device=device)
        else:
            model, px, py, tb = build_image_setup(
                num_clients=clients, device=device,
                **(dict(model_name="resnet", task="cifar10")
                   if setup == "resnet" else {}))
        cfg = FLConfig(num_clients=clients, clients_per_round=per_round,
                       eval_every=1, **knobs)
    else:
        model, px, py, tb = build_text_setup(
            num_clients=8, max_width=3, seed=0, model_name="transformer",
            device=device)
        cfg = FLConfig(num_clients=8, clients_per_round=per_round,
                       batch_size=8, eval_every=1, **knobs)
    runner = build_runner(scheme, model, px, py, tb, cfg=cfg, device=device)
    merges = timed_merges(torch, runner, device)
    if hook is not None:
        hook(runner)
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        runner.run_round()
        if device != "cpu":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return runner, secs, summarize(runner.history), merges


def check_run(torch, label, runner) -> None:
    """Finite accuracy every round, finite loss and params."""
    from repro_torch.core.estimator import tree_leaves

    accs = [h.accuracy for h in runner.history]
    check(all(a is not None and math.isfinite(a) for a in accs),
          f"({label}) non-finite accuracy")
    check(math.isfinite(runner.bound_state.loss0),
          f"({label}) non-finite loss")
    check(all(bool(torch.isfinite(t).all())
              for t in tree_leaves(runner.params)),
          f"({label}) non-finite params")


def vs_cpu(torch, label, runner, cpu) -> float:
    """Hold a card run against the same run on the CPU (plain versions,
    same data and weights): schedule equal, accuracy within 2 test
    samples, params within 1e-3.  Returns the largest param difference."""
    from repro_torch.convert import to_numpy
    from repro_torch.core.estimator import tree_leaves

    import numpy as np

    n_test = int(cpu.test_batch["labels"].shape[0])
    check(len(runner.history) == len(cpu.history),
          f"({label}) round count differs from CPU")
    for a, b in zip(runner.history, cpu.history):
        check((a.traffic_bytes, a.makespan, a.mean_tau, a.stale) ==
              (b.traffic_bytes, b.makespan, b.mean_tau, b.stale),
              f"({label}) round {a.round} schedule differs from CPU")
        check(abs(a.accuracy - b.accuracy) <= 2.0 / n_test,
              f"({label}) round {a.round} accuracy differs from CPU")
    gp, cp = to_numpy(runner.params), to_numpy(cpu.params)
    diff = max(float(np.abs(x - y).max())
               for x, y in zip(tree_leaves(gp), tree_leaves(cp)))
    print(f"      vs the CPU run: schedule equal, accuracy "
          f"{[h.accuracy for h in cpu.history]}, max param diff "
          f"{diff:.3e}")
    check(diff <= 1e-3, f"({label}) params differ from the CPU run")
    return diff


def train_path(torch, label, setup, scheme, knobs, expect):
    """Drive one training run on the card with the launch counts set to 0
    just before it, check it, and hold it against the same run on the
    CPU.  Returns (runner, launch counts)."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runner, secs, summ, _ = run_path(torch, setup, scheme, knobs, DEVICE)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    accs = [h.accuracy for h in runner.history]
    print(f"  ({label}) {scheme} {knobs}: seconds per round "
          f"{[round(s, 4) for s in secs]} mean {sum(secs) / ROUNDS:.4f}; "
          f"peak memory above the run's start {peak} B")
    print(f"      summarize {json.dumps(summ)}")
    print(f"      accuracy per round {accs}; loss0 "
          f"{runner.bound_state.loss0}; launches {counts}")
    check_run(torch, label, runner)
    for k in expect:
        check(counts[k] > 0, f"({label}) never launched {k}")
    cpu, _, _, _ = run_path(torch, setup, scheme, knobs, "cpu")
    vs_cpu(torch, label, runner, cpu)
    return runner, counts


def merge_path(torch, label, scheme, knobs, rounds, expect, clients=10):
    """One CNN run of path (h) or (i) on the card under FLConfig's default
    merge backend, launch counts set to 0 just before it, held against
    the same run on the CPU.  Returns (launch counts, record)."""
    from repro_torch.fl import (FLConfig, time_to_accuracy,
                                traffic_to_accuracy)
    from repro_torch.kernels import LAUNCHES, reset_launches

    check(FLConfig().agg_backend == "collective",
          "FLConfig's default merge backend is not collective")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runner, secs, summ, merges = run_path(torch, "image", scheme, knobs,
                                          DEVICE, rounds, clients)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    hist = runner.history
    rec = {
        "s_per_round": secs, "merge_ms": [1e3 * t for t in merges],
        "peak_bytes": peak, "stale": [h.stale for h in hist],
        "accuracy": [h.accuracy for h in hist],
        "time_to_accuracy": time_to_accuracy(hist, TTA_TARGET),
        "traffic_to_accuracy": traffic_to_accuracy(hist, TTA_TARGET),
        "launches": {k: n for k, n in counts.items() if n},
        "sample_counts": [runner.data.num_samples(n)
                          for n in range(clients)],
    }
    print(f"  ({label}) {scheme} {knobs}: {json.dumps(rec)}")
    print(f"      summarize {json.dumps(summ)}")
    check_run(torch, label, runner)
    if expect:
        for k in expect:
            check(counts[k] > 0, f"({label}) never launched {k}")
    else:
        check(not any(counts.values()),
              f"({label}) a dense scheme launched a kernel: {counts}")
    cpu, _, _, _ = run_path(torch, "image", scheme, knobs, "cpu", rounds,
                            clients)
    rec["max_param_diff_cpu"] = vs_cpu(torch, label, runner, cpu)
    return counts, rec


def schemes_path(torch) -> tuple:
    """Path (h): every scheme of the paper's comparison, then path (i):
    semi-async and sample-weighted runs.  Returns (counts by path,
    records)."""
    from repro_torch.kernels import KERNELS

    print(f"  (h) the scheme comparison, default merge backend, {ROUNDS} "
          f"rounds each; to-accuracy metrics at {TTA_TARGET}")
    by_path = {"h": {k: 0 for k in KERNELS}, "i": {k: 0 for k in KERNELS}}
    recs = {"h": {}, "i": {}}
    for scheme in SCHEMES:
        counts, recs["h"][scheme] = merge_path(
            torch, f"h {scheme}", scheme, SCHEME_KNOBS, ROUNDS,
            SCHEME_KERNELS.get(scheme, set()))
        for k, n in counts.items():
            by_path["h"][k] += n
    print("  (i) semi-async events and sample weights")
    for scheme, knobs, rounds, clients in ASYNC_RUNS:
        label = f"i {scheme} {'async' if 'round_mode' in knobs else 'sw'}"
        counts, rec = merge_path(torch, label, scheme,
                                 dict(SCHEME_KNOBS, **knobs), rounds,
                                 SCHEME_KERNELS.get(scheme, set()), clients)
        if "round_mode" in knobs:
            check(any(s > 0 for s in rec["stale"]),
                  f"({label}) no event merged a stale client")
        else:
            check(len(set(rec["sample_counts"])) > 1,
                  f"({label}) every shard has one size: all weights 1")
        recs["i"][label] = rec
        for k, n in counts.items():
            by_path["i"][k] += n
    return by_path, recs


# path (j): the cohort trainer (trainer="cohort"), 3 rounds on the
# 10-client CNN setup and the composed transformer's text setup:
# (label, setup, scheme, knobs, clients a round)
COHORT_RUNS = (
    ("heroes materialize", "image", "heroes",
     dict(forward_impl="materialize", agg_backend="host"), 4),
    ("heroes auto", "image", "heroes", dict(PATHS["c"][1]), 4),
    ("fedavg", "image", "fedavg",
     dict(forward_impl="materialize", agg_backend="host"), 4),
    ("heroes auto, 10 a round", "image", "heroes", dict(PATHS["c"][1]), 10),
    ("transformer heroes rank_space", "text", "heroes",
     dict(TEXT_RUNS["heroes"]), 4),
)
COMPOSITION = ("compose", "conv_rank", "rank_apply", "compose_apply")
# cohort vs sequential on the card, heroes' first train_all: the JAX
# package's own tolerances (tests/test_engine.py)
COHORT_PARAM_TOL = (1e-5, 1e-4)  # (atol, rtol)
COHORT_LOSS_TOL = 1e-4
COHORT_EST_TOL = (1e-3, 1e-2)


def layer_kernels(runner, width: int, batch: int) -> dict:
    """The composition kernel each layer's forward launches at ``width``
    and training batch ``batch``, as ``prepare_weights`` picks its impl:
    compose for a materialised layer, conv_rank or rank_apply in rank
    space (an embedding's rank path is a gather: none), compose_apply
    for ``fused_compose``.  Counts of layers per kernel."""
    from repro_torch.core.calibration import for_dispatch

    model, cfg = runner.model, runner.cfg
    if not runner.factorized:
        return {}
    shape = (batch,) + tuple(runner.data.parts_x[0].shape[1:])
    impls = model.layer_impls(width, batch, cfg.forward_impl, shape,
                              for_dispatch(cfg, runner.device),
                              runner.device)
    out = {}
    for name, impl in impls.items():
        kind = model.layers[name].kind
        kernel = {"materialize": "compose",
                  "fused_compose": "compose_apply",
                  "rank_space": {"conv": "conv_rank", "dense": "rank_apply",
                                 "embed": None}[kind]}[impl]
        if kernel:
            out[kernel] = out.get(kernel, 0) + 1
    return out


def expected_training_launches(runner, rounds_assigns, cohort: bool) -> dict:
    """The composition launches the training of these rounds takes: each
    forward launches every layer's kernel once (backwards launch none),
    and a client or, under the cohort trainer, a whole group (one width,
    one effective batch) takes τ forwards (τ_pad, the group's largest),
    the loss before and after (2) and, for schemes that ship estimates,
    4 gradient evaluations."""
    per = 2 + (4 if runner.estimate else 0)
    out = {k: 0 for k in COMPOSITION}
    for assigns in rounds_assigns:
        groups = {}
        for n, a in assigns.items():
            b = min(runner.cfg.batch_size, runner.data.num_samples(n))
            key = (a["width"], b) if cohort else (a["width"], b, n)
            groups.setdefault(key, []).append(max(a["tau"], 1))
        for key, taus in groups.items():
            for k, layers in layer_kernels(runner, key[0], key[1]).items():
                out[k] += (max(taus) + per) * layers
    return out


def record_training(runner):
    """Wrap the runner's trainer and evaluation: returns a dict that
    collects each round's assignments, the first round's client results
    and the launches its evaluations took."""
    from repro_torch.kernels import LAUNCHES

    rec = {"assigns": [], "first": None,
           "eval": {k: 0 for k in COMPOSITION}}
    train_all, evaluate = runner.trainer.train_all, runner.aggregator.evaluate

    def train(state, assigns):
        rec["assigns"].append({n: dict(a) for n, a in assigns.items()})
        results = train_all(state, assigns)
        if rec["first"] is None:
            rec["first"] = results
        return results

    def ev(*args, **kw):
        before = dict(LAUNCHES)
        out = evaluate(*args, **kw)
        for k in COMPOSITION:
            rec["eval"][k] += LAUNCHES[k] - before[k]
        return out

    runner.trainer.train_all = train
    runner.aggregator.evaluate = ev
    return rec


def first_results_close(torch, label, got, want,
                        param_tol=COHORT_PARAM_TOL) -> float:
    """The cohort run's first ``train_all`` against the sequential run's
    on the card: params within ``param_tol`` (atol, rtol; the JAX
    package's tolerances by default), losses and estimates at the JAX
    package's tolerances.  Returns the largest param difference."""
    from repro_torch.core.estimator import tree_leaves

    check(list(got) == list(want), f"({label}) first round's clients differ")
    worst = 0.0
    atol, rtol = param_tol
    for n, a in want.items():
        b = got[n]
        for la, lb in zip(tree_leaves(a.params), tree_leaves(b.params)):
            d = (lb - la).abs()
            worst = max(worst, float(d.max()))
            check(bool((d <= atol + rtol * la.abs()).all()),
                  f"({label}) client {n} params differ from sequential "
                  f"(max {float(d.max()):.3e})")
        check(abs(a.loss_before - b.loss_before) < COHORT_LOSS_TOL
              and abs(a.loss_after - b.loss_after) < COHORT_LOSS_TOL,
              f"({label}) client {n} losses differ from sequential")
        check(a.estimates.keys() == b.estimates.keys(),
              f"({label}) client {n} estimate keys differ")
        for k, v in a.estimates.items():
            check(abs(b.estimates[k] - v) <= COHORT_EST_TOL[0]
                  + COHORT_EST_TOL[1] * abs(v),
                  f"({label}) client {n} estimate {k} differs from "
                  "sequential")
    print(f"      first train_all vs the sequential trainer's on the card: "
          f"max param diff {worst:.3e}, losses and estimates within "
          "tolerance")
    return worst


def cohort_path(torch) -> tuple:
    """Path (j): each ``COHORT_RUNS`` run with ``trainer="cohort"`` on
    the card, launch counts set to 0 just before it; the same run with
    the sequential trainer on the card, and with the cohort trainer on
    the CPU.  Each composition kernel's training launches (the run's less
    its evaluations') must equal ``expected_training_launches``, and be
    fewer than the sequential trainer takes for the same assignments
    wherever a group holds more than one client.  Held against the CPU
    run (``vs_cpu``) and against the sequential card run: fedavg's whole
    history, heroes' first ``train_all``.  Returns (launch counts,
    records)."""
    from repro_torch.convert import to_numpy
    from repro_torch.core.estimator import tree_leaves
    from repro_torch.kernels import KERNELS, LAUNCHES, reset_launches

    import numpy as np

    counts_j = {k: 0 for k in KERNELS}
    recs = {}
    for label, setup, scheme, knobs, per_round in COHORT_RUNS:
        label = f"j {label}"
        runs = {}
        for trainer in ("sequential", "cohort"):
            hooked = {}
            reset_launches()
            runner, secs, summ, _ = run_path(
                torch, setup, scheme, dict(knobs, trainer=trainer), DEVICE,
                per_round=per_round,
                hook=lambda r: hooked.update(rec=record_training(r)))
            counts = dict(LAUNCHES)
            runs[trainer] = (runner, secs, summ, counts, hooked["rec"])
        runner, secs, summ, counts, rec = runs["cohort"]
        seq_runner, seq_secs, _, seq_counts, seq_rec = runs["sequential"]
        for k, n in counts.items():
            counts_j[k] += n
        train = {k: counts[k] - rec["eval"][k] for k in COMPOSITION}
        seq_train = {k: seq_counts[k] - seq_rec["eval"][k]
                     for k in COMPOSITION}
        want = expected_training_launches(runner, rec["assigns"], True)
        per_client = expected_training_launches(runner, rec["assigns"],
                                                False)
        seq_want = expected_training_launches(seq_runner, seq_rec["assigns"],
                                              False)
        sizes = [len({(a["width"], min(runner.cfg.batch_size,
                                       runner.data.num_samples(n)))
                      for n, a in assigns.items()})
                 for assigns in rec["assigns"]]
        shared = any(n_groups < len(assigns) for n_groups, assigns
                     in zip(sizes, rec["assigns"]))
        r = {"s_per_round": secs, "sequential_s_per_round": seq_secs,
             "launches": {k: n for k, n in counts.items() if n},
             "sequential_launches": {k: n for k, n in seq_counts.items()
                                     if n},
             "training_launches": train, "expected": want,
             "sequential_training_launches": seq_train,
             "sequential_expected": seq_want,
             "per_client_on_these_assignments": per_client,
             "groups_per_round": sizes,
             "clients_per_round": [len(a) for a in rec["assigns"]],
             "accuracy": [h.accuracy for h in runner.history]}
        print(f"  ({label}) {scheme} {knobs}, {per_round} a round: "
              f"{json.dumps(r)}")
        print(f"      summarize {json.dumps(summ)}")
        check_run(torch, label, runner)
        check(train == want, f"({label}) training launches {train}, the "
              f"groups take {want}: the vmap rules do not batch")
        check(seq_train == seq_want,
              f"({label}) sequential training launches {seq_train}, "
              f"expected {seq_want}")
        cut = sum(train.values()) < sum(per_client.values())
        check(all(train[k] <= per_client[k] for k in COMPOSITION)
              and (cut or not shared or not any(per_client.values())),
              f"({label}) the groups did not cut the launches: {train} "
              f"against {per_client} a client at a time")
        if scheme == "fedavg":
            r["max_param_diff_sequential"] = vs_cpu(
                torch, f"{label} vs sequential", runner, seq_runner)
        else:
            r["first_round_diff_sequential"] = first_results_close(
                torch, label, rec["first"], seq_rec["first"])
        cpu, _, _, _ = run_path(torch, setup, scheme,
                                dict(knobs, trainer="cohort"), "cpu",
                                per_round=per_round)
        r["max_param_diff_cpu"] = vs_cpu(torch, label, runner, cpu)
        recs[label] = r
    return counts_j, recs


# paths (k) and (l): the paper's other two experiments, the residual net
# on cifar10 and the RNN on shakespeare (Fig. 9's text task: fedavg, flanc
# and heroes), each on 10 clients, 3 rounds of 4, with the loaders'
# synthetic fallbacks at their defaults (32x32x3 images, 2000 + 400; T 32,
# vocab 64, 16 speakers, the natural partition) and the models at full
# width (P = 3): (path, setup, scheme, knobs, kernels it must launch).
# Heroes evaluates a composed model, so every heroes run launches compose
SLICE_RUNS = (
    ("k", "resnet", "heroes", dict(forward_impl="materialize",
                                   agg_backend="host"), {"compose"}),
    ("k", "resnet", "heroes", dict(forward_impl="rank_space",
                                   agg_backend="host"),
     {"compose", "conv_rank", "rank_apply"}),
    ("k", "resnet", "heroes", dict(PATHS["c"][1]),
     {"compose", "conv_rank", "compose_apply"}),
    ("k", "resnet", "fedavg", dict(forward_impl="materialize",
                                   agg_backend="host"), set()),
    ("l", "rnn", "fedavg", dict(forward_impl="materialize",
                                agg_backend="host"), set()),
    ("l", "rnn", "flanc", dict(forward_impl="rank_space",
                               agg_backend="host"),
     {"compose", "rank_apply"}),
    ("l", "rnn", "heroes", dict(forward_impl="rank_space",
                                agg_backend="host"),
     {"compose", "rank_apply"}),
    ("l", "rnn", "heroes", dict(forward_impl="materialize",
                                agg_backend="host"), {"compose"}),
)
# each path's cohort run, beside the sequential run of SLICE_RUNS at this
# index: (k) heroes pinned auto, (l) heroes rank_space
SLICE_COHORT = {"k": 2, "l": 6}
# (k)'s cohort run is held to its sequential run under
# cudnn_deterministic, at path (j)'s tolerance: with cuDNN's defaults two
# identical sequential runs of the residual net differ by ~2e-5 after
# round 1 (cuDNN picks non-deterministic algorithms for its 32x32 convs'
# backward), under cudnn.deterministic by nothing (ROADMAP C.10,
# spread_k).  A card run against the CPU's stays within vs_cpu's 1e-3:
# those runs take cuDNN's defaults, as a user's do.
# the RNN's local SGD amplifies float rounding: the JAX package's own run
# from weights moved by 1e-7 relative is 3.6e-5 away after 2 steps and
# 6e-2 after 10 (tests/test_torch_resnet_rnn.py), so a card run and a CPU
# run of path (l) agree in what is evaluated at round 1's shipped weights,
# not in the weights they train to
AT_SHIPPED_WEIGHTS = ("loss_before", "sigma_sq", "grad_sq")


def _plain_assigns(assigns) -> dict:
    """One round's assignments with block ids as lists, comparable with
    ``==``."""
    return {int(n): {k: (None if v is None else [int(i) for i in v])
                     if k.endswith("_ids") else v for k, v in a.items()}
            for n, a in assigns.items()}


def _est_close(a: float, b: float) -> bool:
    return abs(a - b) <= COHORT_EST_TOL[0] + COHORT_EST_TOL[1] * abs(a)


def shipped_close(label, got, want) -> None:
    """Round 1's client results of two runs from the same shipped weights:
    the same clients, and ``AT_SHIPPED_WEIGHTS`` within
    ``COHORT_EST_TOL``."""
    check(list(got) == list(want), f"({label}) first round's clients differ")
    for n, a in want.items():
        b = got[n]
        vals = dict(a.estimates, loss_before=a.loss_before)
        other = dict(b.estimates, loss_before=b.loss_before)
        for k in AT_SHIPPED_WEIGHTS:
            if k in vals:
                check(_est_close(vals[k], other[k]),
                      f"({label}) client {n} {k} {other[k]} against "
                      f"{vals[k]}")


def rnn_vs_cpu(torch, label, runner, rec, cpu, cpu_rec) -> float:
    """Hold a path-(l) card run against the same run on the CPU: schedule
    and round 1's assignments equal, round 1's results at the shipped
    weights within tolerance (``shipped_close``), and the card's final
    weights, evaluated on the CPU, give the card's final accuracy within 2
    test samples.  Returns that accuracy difference."""
    import dataclasses

    from repro_torch.convert import from_jax_params, to_numpy

    n_test = int(cpu.test_batch["labels"].shape[0])
    check(len(runner.history) == len(cpu.history),
          f"({label}) round count differs from CPU")
    for a, b in zip(runner.history, cpu.history):
        check((a.traffic_bytes, a.makespan, a.mean_tau, a.stale) ==
              (b.traffic_bytes, b.makespan, b.mean_tau, b.stale),
              f"({label}) round {a.round} schedule differs from CPU")
    check(_plain_assigns(rec["assigns"][0])
          == _plain_assigns(cpu_rec["assigns"][0]),
          f"({label}) round 1's assignments differ from CPU")
    shipped_close(f"{label} vs CPU", rec["first"], cpu_rec["first"])
    acc = cpu.aggregator.evaluate(dataclasses.replace(
        cpu.state, params=from_jax_params(to_numpy(runner.params), "cpu")))
    diff = abs(acc - runner.history[-1].accuracy)
    print(f"      vs the CPU run: schedule equal, round 1 at the shipped "
          f"weights within tolerance; CPU accuracy "
          f"{[h.accuracy for h in cpu.history]}; the card's weights on the "
          f"CPU: accuracy {acc} (card {runner.history[-1].accuracy})")
    check(diff <= 2.0 / n_test,
          f"({label}) the card's weights score {acc} on the CPU")
    return diff


def slice_run(torch, label, setup, scheme, knobs, expect, trainer):
    """One run of path (k) or (l) on the card with ``trainer``, launch
    counts set to 0 just before it: each composition kernel's training
    launches (the run's less its evaluations') must equal
    ``expected_training_launches``, the run must launch ``expect`` (a
    dense scheme nothing); then the same run on the CPU holds it
    (``vs_cpu``, or ``rnn_vs_cpu`` on the RNN).  Returns (runner, its
    record, launch counts, printed record)."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    knobs = dict(knobs, trainer=trainer)
    hooked = {}
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runner, secs, summ, _ = run_path(
        torch, setup, scheme, knobs, DEVICE,
        hook=lambda r: hooked.update(rec=record_training(r)))
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    rec = hooked["rec"]
    train = {k: counts[k] - rec["eval"][k] for k in COMPOSITION}
    want = expected_training_launches(runner, rec["assigns"],
                                      trainer == "cohort")
    r = {"s_per_round": secs, "peak_bytes": peak,
         "launches": {k: n for k, n in counts.items() if n},
         "training_launches": train, "expected": want,
         "eval_launches": rec["eval"],
         "accuracy": [h.accuracy for h in runner.history],
         "mean_tau": [h.mean_tau for h in runner.history]}
    if trainer == "cohort":
        r["groups_per_round"] = [
            len({(a["width"], min(runner.cfg.batch_size,
                                  runner.data.num_samples(n)))
                 for n, a in assigns.items()})
            for assigns in rec["assigns"]]
    print(f"  ({label}) {scheme} {knobs}: {json.dumps(r)}")
    print(f"      summarize {json.dumps(summ)}")
    check_run(torch, label, runner)
    check(train == want, f"({label}) training launches {train}, expected "
          f"{want}")
    if expect:
        for k in expect:
            check(counts[k] > 0, f"({label}) never launched {k}")
    else:
        check(not any(counts.values()),
              f"({label}) a dense scheme launched a kernel: {counts}")
    hooked_cpu = {}
    cpu, _, _, _ = run_path(
        torch, setup, scheme, knobs, "cpu",
        hook=lambda c: hooked_cpu.update(rec=record_training(c)))
    if setup == "rnn":
        r["card_weights_cpu_accuracy_diff"] = rnn_vs_cpu(
            torch, label, runner, rec, cpu, hooked_cpu["rec"])
    else:
        r["max_param_diff_cpu"] = vs_cpu(torch, label, runner, cpu)
    return runner, rec, counts, r


def slice_path(torch) -> tuple:
    """Paths (k) and (l): every ``SLICE_RUNS`` run with the sequential
    trainer, the C.10 experiment (``spread_k``), then each path's
    ``SLICE_COHORT`` run with the cohort trainer, held against its
    sequential run on the card (round 1's results: all of them on the
    residual net, both runs under ``cudnn_deterministic``,
    ``AT_SHIPPED_WEIGHTS`` on the RNN) and against the CPU; and
    ``build_text_setup()`` with no model name resolves the RNN.  Returns
    (launch counts by path, records)."""
    from repro_torch.fl import build_text_setup
    from repro_torch.kernels import KERNELS

    model = build_text_setup(device=DEVICE)[0]
    check(model.name == "rnn",
          f"build_text_setup()'s default model is {model.name}")
    print(f"  build_text_setup() resolves {model.name!r} "
          f"(vocab {model.num_classes})")
    by_path = {"k": {k: 0 for k in KERNELS}, "l": {k: 0 for k in KERNELS}}
    recs = {"k": {}, "l": {}}
    seq = {}
    for i, (path, setup, scheme, knobs, expect) in enumerate(SLICE_RUNS):
        label = f"{path} {scheme} {knobs['forward_impl']}"
        runner, rec, counts, recs[path][label] = slice_run(
            torch, label, setup, scheme, knobs, expect, "sequential")
        seq[i] = (runner, rec)
        for k, n in counts.items():
            by_path[path][k] += n
    recs["k"]["C.10 spread"] = spread_k(torch)
    for path, i in SLICE_COHORT.items():
        _, setup, scheme, knobs, expect = SLICE_RUNS[i]
        label = f"{path} {scheme} {knobs['forward_impl']} cohort"
        det = setup == "resnet"
        with (cudnn_deterministic(torch) if det
              else contextlib.nullcontext()):
            runner, rec, counts, r = slice_run(torch, label, setup, scheme,
                                               knobs, expect, "cohort")
            if det:
                hooked = {}
                run_path(torch, setup, scheme,
                         dict(knobs, trainer="sequential"), DEVICE,
                         rounds=1,
                         hook=lambda s: hooked.update(
                             rec=record_training(s)))
                seq_rec = hooked["rec"]
            else:
                seq_rec = seq[i][1]
        check(_plain_assigns(rec["assigns"][0])
              == _plain_assigns(seq_rec["assigns"][0]),
              f"({label}) round 1's assignments differ from sequential")
        if setup == "rnn":
            shipped_close(f"{label} vs sequential", rec["first"],
                          seq_rec["first"])
        else:
            r["first_round_diff_sequential_deterministic"] = (
                first_results_close(torch, label, rec["first"],
                                    seq_rec["first"]))
        r["sequential_training_launches"] = recs[path][
            label.replace(" cohort", "")]["training_launches"]
        recs[path][label] = r
        for k, n in counts.items():
            by_path[path][k] += n
    return by_path, recs


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN's deterministic algorithms and no autotuning for the block
    (``torch.backends.cudnn.deterministic = True``, ``benchmark =
    False``), restored after it."""
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = was


def max_param_diff(a, b) -> float:
    """The largest absolute difference of two params trees."""
    from repro_torch.convert import to_numpy
    from repro_torch.core.estimator import tree_leaves

    import numpy as np

    return max(float(np.abs(x - y).max()) for x, y in
               zip(tree_leaves(to_numpy(a)), tree_leaves(to_numpy(b))))


# ROADMAP C.10: the residual net's card runs spread.  Path (k)'s heroes
# pinned auto and fedavg (no port kernel), each run with the sequential
# trainer twice and the cohort trainer once, with cuDNN's defaults and
# deterministic; the weights after round 1 compared
SPREAD_RUNS = (("heroes auto", "heroes", dict(PATHS["c"][1])),
               ("fedavg", "fedavg", dict(forward_impl="materialize",
                                         agg_backend="host")))


def spread_k(torch) -> dict:
    """The C.10 experiment: for each ``SPREAD_RUNS`` run and each cuDNN
    mode, the largest weight difference after round 1 between two
    sequential runs and between the cohort and the sequential run."""
    out = {}
    for label, scheme, knobs in SPREAD_RUNS:
        for mode in ("default", "deterministic"):
            ctx = (cudnn_deterministic(torch) if mode == "deterministic"
                   else contextlib.nullcontext())
            params = {}
            with ctx:
                for run, trainer in (("sequential", "sequential"),
                                     ("again", "sequential"),
                                     ("cohort", "cohort")):
                    runner, _, _, _ = run_path(
                        torch, "resnet", scheme,
                        dict(knobs, trainer=trainer), DEVICE, rounds=1)
                    params[run] = runner.params
            r = {"sequential_vs_again": max_param_diff(
                     params["again"], params["sequential"]),
                 "cohort_vs_sequential": max_param_diff(
                     params["cohort"], params["sequential"])}
            out[f"{label}, {mode}"] = r
            if mode == "deterministic":
                check(r["sequential_vs_again"] == 0.0,
                      f"(k) {label}: two sequential runs differ under "
                      "cudnn.deterministic")
            print(f"  (k) C.10 spread, {label}, cuDNN {mode}: weights after "
                  f"round 1, sequential vs sequential "
                  f"{r['sequential_vs_again']:.3e}, cohort vs sequential "
                  f"{r['cohort_vs_sequential']:.3e}")
    return out


# path (m): a virtual population of a million clients on the CNN at full
# width, the calibration pinned as on path (c) so a new process picks the
# same impls; every round checkpointed, keeping two
M_POPULATION = 1_000_000
M_SETUP = dict(partition_kw={"samples_per_client": 32})
M_KNOBS = dict(clients_per_round=10, participation="availability",
               edge_groups=2, trainer="cohort", forward_impl="auto",
               conv_rank_overhead=1.0, fused_compose_gain=0.5, eval_every=1,
               checkpoint_every=1, checkpoint_keep=2)
# (m3): semi-async events at the million, uniform (the rejection path)
M_ASYNC = dict(round_mode="semi_async", clients_per_round=4, async_k=2,
               participation="uniform")
M_ROUNDS, M_STOP = 4, 2
M_EXPECT = ("compose", "conv_rank", "compose_apply")
M_PARTIAL_TOL = 1e-5


def m_runner(torch, device, ckpt_dir, population=M_POPULATION, **over):
    """A fresh path-(m) setup and runner (each runner binds its own
    registry) on ``device``; returns (runner, setup seconds)."""
    from repro_torch.fl import FLConfig, build_runner, build_setup

    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup = build_setup("synthetic_image", "cnn", max_width=3, seed=0,
                        population=population, device=device, **M_SETUP)
    cfg = FLConfig(num_clients=population, checkpoint_dir=str(ckpt_dir),
                   **dict(M_KNOBS, **over))
    runner = build_runner("heroes", *setup, cfg=cfg, device=device)
    return runner, time.perf_counter() - t0


def timed_saves(runner) -> list:
    """Wrap ``runner.save_checkpoint`` to append each save's seconds (it
    copies the state to the host, which waits for the card)."""
    save = runner.save_checkpoint
    secs = []

    def timed():
        t0 = time.perf_counter()
        out = save()
        secs.append(time.perf_counter() - t0)
        return out

    runner.save_checkpoint = timed
    return secs


def history_dicts(runner) -> list:
    import dataclasses

    return [dataclasses.asdict(h) for h in runner.history]


def resume_worker(argv) -> int:
    """``chip_smoke.py resume MODE DEVICE CKPT_DIR OUT_DIR``, the new
    process of (m2) and (m3): restore the newest checkpoint of a path-(m)
    run (``MODE`` m2 or m3) on ``DEVICE``, run it to ``M_ROUNDS``, and
    write its history, restore time and final params under ``OUT_DIR``.
    It imports nothing but torch and ``repro_torch``."""
    import torch

    mode, device, ckpt_dir, out_dir = argv
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as rt
    from repro_torch.checkpoint import npz_ckpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device != "cpu":
        rt.build()  # built by the parent: loads them
    with cudnn_deterministic(torch):
        runner, _ = m_runner(torch, device, ckpt_dir,
                             **(M_ASYNC if mode == "m3" else {}))
        t0 = time.perf_counter()
        check(runner.restore_latest(), f"({mode}) no checkpoint to resume")
        if device != "cpu":
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rec = {"restored_round": runner.state.round,
               "restored_in_flight": len(runner.state.in_flight),
               "restore_ms": 1e3 * restore_s}
        runner.run(M_ROUNDS - runner.state.round)
        runner.close()
    rec["history"] = history_dicts(runner)
    rec["participation"] = {str(k): v for k, v in
                            runner.state.participation.items()}
    npz_ckpt.save_checkpoint(out_dir, M_ROUNDS, runner.params)
    (Path(out_dir) / "run.json").write_text(json.dumps(rec))
    return 0


def resume_in_new_process(torch, label, mode, ckpt_dir, ref) -> dict:
    """Run ``resume_worker`` in a new Python process and hold what it
    continued against the uninterrupted run ``ref``: history, final
    params and participation bit for bit."""
    import tempfile

    from repro_torch.checkpoint import npz_ckpt
    from repro_torch.convert import to_numpy
    from repro_torch.core.estimator import tree_leaves

    import numpy as np

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "resume", mode,
             DEVICE, str(ckpt_dir), out], capture_output=True, text=True,
            timeout=300)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"({label}) the resuming process failed:\n{proc.stdout}\n"
              f"{proc.stderr[-4000:]}")
        rec = json.loads((Path(out) / "run.json").read_text())
        _, params = npz_ckpt.restore_latest(out)
    want = to_numpy(ref.params)
    got = [np.asarray(params[name][key]) for name in want
           for key in sorted(want[name])]
    same = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in
               zip(tree_leaves(want), got))
    check(rec["restored_round"] == M_STOP,
          f"({label}) resumed at round {rec['restored_round']}")
    check(rec["history"] == history_dicts(ref),
          f"({label}) the resumed history differs from the uninterrupted "
          "run's")
    check(same, f"({label}) the resumed run's final params differ from the "
          "uninterrupted run's")
    check({int(k): v for k, v in rec["participation"].items()}
          == ref.state.participation,
          f"({label}) participation differs after the resume")
    out = {"restore_ms": rec["restore_ms"],
           "restored_in_flight": rec["restored_in_flight"],
           "new_process_s": wall}
    print(f"      ({label}) a new process restored round {M_STOP} "
          f"({rec['restore_ms']:.2f} ms, {rec['restored_in_flight']} in "
          f"flight) and ran to round {M_ROUNDS} in {wall:.1f} s: history, "
          f"params and participation equal the uninterrupted run's bit for "
          f"bit")
    return out


def partials_close(runner, k: int) -> float:
    """The edge groups' partials of the last merge (a cohort of ``k``)
    recombine to the merged state: summed over the groups, the bases over
    K give the merged basis and the coefficient blocks over their counts
    the merged blocks.  Returns the largest difference."""
    worst = 0.0
    for name, p in runner.merger.last_partials.items():
        basis = p["bases"].sum(0) / k
        cnt = p["mask"].sum(0)
        trained = cnt > 0
        coeff = p["dense"].sum(0)[trained] / cnt[trained][:, None, None]
        for got, want in ((basis, runner.params[name]["basis"]),
                          (coeff, runner.params[name]["coeff"][trained])):
            worst = max(worst, float((got - want).abs().max()))
    check(worst <= M_PARTIAL_TOL,
          f"(m) edge partials recombine {worst:.3e} from the merged state")
    return worst


def population_path(torch) -> tuple:
    """Path (m): a Heroes run over a virtual population of a million
    clients, checkpointed every round, under ``cudnn_deterministic``:
    (m1) 4 rounds uninterrupted; (m2) the same stopped after round 2 and
    continued by a new process from the checkpoint; (m3) semi-async events
    at the million (uniform, rejection-sampled) stopped after event 2 with
    results in flight, continued the same way; (m4) ``run_until_budget``
    at (m1)'s wall after round 2.  (m2) and (m3) must equal their
    uninterrupted runs bit for bit, (m1)'s schedule and participation the
    CPU run's (weights as ``vs_cpu`` holds them), and the edge partials
    must recombine to the merged state.  Returns (launch counts, record).
    """
    import tempfile

    from repro_torch.kernels import LAUNCHES, reset_launches

    rec = {}
    with tempfile.TemporaryDirectory() as tmp, cudnn_deterministic(torch):
        tmp = Path(tmp)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        # (m1) uninterrupted, timed, its cohorts recorded
        m1, setup_s = m_runner(torch, DEVICE, tmp / "m1")
        saves = timed_saves(m1)
        hooked = record_training(m1)
        secs = []
        for _ in range(M_ROUNDS):
            t0 = time.perf_counter()
            m1.run_round()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        step = sorted((tmp / "m1").glob("step_*"))[-1]
        ckpt_bytes = sum(f.stat().st_size for f in step.iterdir())
        rec["m1"] = {
            "setup_s": setup_s, "s_per_round": secs,
            "save_ms": [1e3 * s for s in saves],
            "s_per_round_without_save": [a - b for a, b in zip(secs, saves)],
            "checkpoint_bytes": ckpt_bytes, "peak_bytes": peak,
            "accuracy": [h.accuracy for h in m1.history],
            "participants": m1.population.participants(),
            "partials_max_diff": partials_close(
                m1, len(hooked["assigns"][-1]))}
        check_run(torch, "m1", m1)
        check(len(saves) == M_ROUNDS, f"(m1) {len(saves)} saves")
        check(sorted(p.name for p in (tmp / "m1").glob("step_*"))
              == [f"step_{r:08d}" for r in (M_ROUNDS - 1, M_ROUNDS)],
              "(m1) keep-2 pruning")

        # (m2) stopped after round 2, continued by a new process
        m2, _ = m_runner(torch, DEVICE, tmp / "m2")
        m2.run(M_STOP)
        check(history_dicts(m2) == history_dicts(m1)[:M_STOP],
              "(m2) its first rounds differ from (m1)'s")
        m2.close()
        rec["m2"] = resume_in_new_process(torch, "m2", "m2", tmp / "m2", m1)

        # (m3) semi-async at the million, uninterrupted and resumed
        m3, _ = m_runner(torch, DEVICE, tmp / "m3ref", **M_ASYNC)
        m3.run(M_ROUNDS)
        check(any(h.stale for h in m3.history),
              "(m3) no event merged a stale result")
        stopped, _ = m_runner(torch, DEVICE, tmp / "m3", **M_ASYNC)
        stopped.run(M_STOP)
        in_flight = len(stopped.state.in_flight)
        check(in_flight >= 1, "(m3) nothing in flight at the checkpoint")
        stopped.close()
        rec["m3"] = resume_in_new_process(torch, "m3", "m3", tmp / "m3", m3)
        check(rec["m3"]["restored_in_flight"] == in_flight,
              "(m3) the restored run lost its in-flight results")
        rec["m3"]["stale"] = [h.stale for h in m3.history]

        # (m4) Alg. 1's outer loop at (m1)'s wall after round 2
        m4, _ = m_runner(torch, DEVICE, tmp / "m4")
        m4.run_until_budget(time_budget=m1.history[M_STOP - 1].wall_time)
        check(history_dicts(m4) == history_dicts(m1)[:M_STOP],
              "(m4) run_until_budget did not stop after round 2")
        counts = dict(LAUNCHES)
        for r in (m1, m3, m4):
            r.close()

        # the same (m1) run on the CPU: schedule, participation, weights
        cpu, _ = m_runner(torch, "cpu", tmp / "cpu")
        cpu_rec = record_training(cpu)
        cpu.run(M_ROUNDS)
        for rnd, (a, b) in enumerate(zip(hooked["assigns"],
                                         cpu_rec["assigns"])):
            check(_plain_assigns(a) == _plain_assigns(b),
                  f"(m1) round {rnd + 1}'s cohort differs from the CPU's")
        check(m1.state.participation == cpu.state.participation,
              "(m1) participation differs from the CPU run's")
        rec["m1"]["max_param_diff_cpu"] = vs_cpu(torch, "m1", m1, cpu)
        cpu.close()

        # setup and one round's peak memory at 10^4 clients, beside (m1)'s
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        small, small_s = m_runner(torch, DEVICE, tmp / "small",
                                  population=10_000)
        small.run_round()
        torch.cuda.synchronize()
        rec["setup_s_by_population"] = {"10000": small_s,
                                        str(M_POPULATION): setup_s}
        rec["round1_peak_bytes_at_10000"] = (
            torch.cuda.max_memory_allocated() - base)
        small.close()
    for k in M_EXPECT:
        check(counts[k] > 0, f"(m) never launched {k}")
    print(f"  (m) {json.dumps(rec)}")
    print(f"      launches {counts}")
    return counts, rec


def _smoke_accuracies(smoke, argv) -> tuple:
    """Run ``smoke.main(argv)``, echo its lines, and return (exit code,
    accuracy by loader) from them."""
    import io
    import re

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = smoke.main(argv)
    accs = {}
    for line in buf.getvalue().splitlines():
        print(f"      {line}")
        m = re.match(r"ok\s+(\S+): acc=(\S+) ", line)
        if m:
            accs[m.group(1)] = float(m.group(2))
    return rc, accs


def smoke_path(torch) -> tuple:
    """Path (n): the dataset smoke, ``repro_torch.data.smoke.main([])``,
    on the card (one cohort heroes round per loader), as CI's
    dataset-smoke leg runs the JAX package's: it must return 0 with a
    finite accuracy on every loader, each within 2 test samples of the
    same smoke on the CPU.  Returns (launch counts, accuracies)."""
    from repro_torch.data import smoke
    from repro_torch.fl.simulation import build_image_setup, build_text_setup
    from repro_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    rc, accs = _smoke_accuracies(smoke, [])
    secs = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    check(rc == 0, f"(n) the dataset smoke exited {rc}")
    check(sorted(accs) == sorted(smoke.setups()),
          f"(n) loaders that passed: {sorted(accs)}")
    rc_cpu, cpu_accs = _smoke_accuracies(smoke, ["--device", "cpu"])
    check(rc_cpu == 0, f"(n) the dataset smoke on the CPU exited {rc_cpu}")
    for name, (kind, kw) in smoke.setups().items():
        tb = (build_image_setup if kind == "image" else build_text_setup)(
            device="cpu", **kw)[3]
        n_test = int(tb["labels"].shape[0])
        check(abs(accs[name] - cpu_accs[name]) <= 2.0 / n_test,
              f"(n) {name}: accuracy {accs[name]} on the card, "
              f"{cpu_accs[name]} on the CPU")
    check(sum(counts.values()) > 0, "(n) launched no kernel")
    rec = {"s": secs, "accuracy": accs, "cpu_accuracy": cpu_accs,
           "launches": {k: n for k, n in counts.items() if n}}
    print(f"  (n) {json.dumps(rec)}")
    return counts, rec



# path (o): telemetry on the card.  Three runs of 3 rounds on the
# 10-client CNN setup with path (c)'s pins under FLConfig's default merge
# backend, each writing telemetry="jsonl": (label, scheme, knobs)
O_RUNS = (
    ("heroes sequential, a save every round", "heroes",
     dict(checkpoint_every=1)),
    ("heroes cohort, 10 a round", "heroes",
     dict(trainer="cohort", clients_per_round=10)),
    ("fedavg semi-async", "fedavg", dict(round_mode="semi_async",
                                         async_k=2)),
)
O_EXPECT = {"heroes": ("compose", "conv_rank", "compose_apply"),
            "fedavg": ()}
# the wall spans a round's time splits into
O_STAGES = ("trainer.local_train", "trainer.host_stage",
            "trainer.device_step", "aggregate.merge", "checkpoint.save")
O_TIME_RTOL = 1e-9
# runs with telemetry off and on in pairs of alternating order (off, on),
# (on, off), ...: telemetry's cost is the median of its rounds 2-3
O_PAIRS = 5
# the engine calls a fifth run of each times on the host clock, so the
# round's rest (what no span covers) splits further
O_TIMED = (("assignment", "assign"), ("trainer", "train_all"),
           ("aggregator", "evaluate"))


def timed_calls(torch, runner, calls: list) -> None:
    """Wrap the ``O_TIMED`` methods of ``runner``'s components to append
    each call, synchronised at both ends, to ``calls`` as a wall span in
    the log's form (named ``component.method``)."""
    for comp, meth in O_TIMED:
        obj = getattr(runner, comp)

        def timed(*args, _fn=getattr(obj, meth), _name=f"{comp}.{meth}",
                  **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            calls.append({"type": "span", "name": _name, "clock": "wall",
                          "t0": t0, "t1": time.perf_counter()})
            return out

        setattr(obj, meth, timed)


def o_run(torch, scheme, knobs, device, tmp, telemetry, hook=None):
    """One path-(o) run of ``ROUNDS`` rounds on ``device`` with
    ``telemetry`` ("off", "memory", or "jsonl" into a new directory under
    ``tmp``), launch counts set to 0 just before it; ``hook(runner)``,
    if given, runs before the first round.  Returns (runner,
    [(t0, t1)] of each round on the host clock, synchronised, launches,
    the events: the sink's, or the log read back)."""
    import tempfile

    from repro_torch.fl import FLConfig, build_image_setup, build_runner
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import load_events

    over = dict(SCHEME_KNOBS, clients_per_round=4, eval_every=1)
    over.update(knobs, telemetry=telemetry)
    if telemetry == "jsonl":
        over["telemetry_dir"] = tempfile.mkdtemp(dir=tmp)
    if over.get("checkpoint_every"):
        over["checkpoint_dir"] = tempfile.mkdtemp(dir=tmp)
    setup = build_image_setup(num_clients=10, device=device)
    runner = build_runner(scheme, *setup, device=device,
                          cfg=FLConfig(num_clients=10, **over))
    if hook is not None:
        hook(runner)
    rounds = []
    with runner:
        if device != "cpu":
            torch.cuda.synchronize()
        reset_launches()
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            runner.run_round()
            if device != "cpu":
                torch.cuda.synchronize()
            rounds.append((t0, time.perf_counter()))
        counts = dict(LAUNCHES)
    events = None
    if telemetry == "memory":
        events = runner.obs.sinks[0].events
    elif telemetry == "jsonl":
        events = load_events(Path(over["telemetry_dir"]) / "events.jsonl")
    return runner, rounds, counts, events


def stage_split(events, rounds, stages=O_STAGES) -> list:
    """For each round: its seconds and, for each wall span of
    ``O_STAGES``, the total seconds of its spans that start in the round
    and that total's share of the round; ``rest`` is what the spans
    leave uncovered."""
    out = []
    for t0, t1 in rounds:
        row = {"s": t1 - t0}
        for name in stages:
            total = sum(e["t1"] - e["t0"] for e in events
                        if e.get("type") == "span" and e["name"] == name
                        and t0 <= e["t0"] <= t1)
            if total:
                row[name] = {"s": total, "share": total / (t1 - t0)}
        if stages == O_STAGES:
            # what no span covers (sampling, planning, the clients'
            # views, evaluation); host staging overlaps the device steps
            rest = row["s"] - sum(v["s"] for k, v in row.items()
                                  if k not in ("s", "trainer.host_stage"))
            row["rest"] = {"s": rest, "share": rest / (t1 - t0)}
        out.append(row)
    return out


def virtual_match(label, got, want) -> None:
    """The virtual-clock spans and events and the ``traffic.*`` counters
    of two logs: names and attrs equal, times within ``O_TIME_RTOL``."""
    gv = [e for e in got if e.get("clock") == "virtual"]
    wv = [e for e in want if e.get("clock") == "virtual"]
    check(len(gv) == len(wv) > 0,
          f"(o) {label}: {len(gv)} virtual spans and events on the card, "
          f"{len(wv)} on the CPU")
    for a, b in zip(gv, wv):
        check((a["type"], a["name"], a["attrs"]) ==
              (b["type"], b["name"], b["attrs"]),
              f"(o) {label}: virtual {a['name']} {a['attrs']} on the card, "
              f"{b['name']} {b['attrs']} on the CPU")
        for k in ("t0", "t1", "t"):
            if k in b:
                check(abs(a[k] - b[k]) <= O_TIME_RTOL * abs(b[k]),
                      f"(o) {label}: {a['name']} {k} {a[k]} on the card, "
                      f"{b[k]} on the CPU")

    def traffic(events):
        return {k: v for k, v in events[-1]["counters"].items()
                if k.startswith("traffic.")}

    check(traffic(got) == traffic(want) and traffic(want),
          f"(o) {label}: traffic counters {traffic(got)} on the card, "
          f"{traffic(want)} on the CPU")


@contextlib.contextmanager
def save_parts(parts: dict):
    """Time the two halves of each checkpoint save inside the block: the
    state's copy to host arrays (``state_to_payload``, which waits for the
    card) and the npz write (``npz_ckpt.save_checkpoint``), in seconds
    appended to ``parts["payload"]`` and ``parts["write"]``."""
    from repro_torch.checkpoint import npz_ckpt
    from repro_torch.fl.engine import state as state_lib

    saved = state_lib.state_to_payload, npz_ckpt.save_checkpoint

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            parts[key].append(time.perf_counter() - t0)
            return out
        return call

    state_lib.state_to_payload = timed("payload", saved[0])
    npz_ckpt.save_checkpoint = timed("write", saved[1])
    try:
        yield parts
    finally:
        state_lib.state_to_payload, npz_ckpt.save_checkpoint = saved


def telemetry_path(torch) -> tuple:
    """Path (o): each ``O_RUNS`` run with ``telemetry="jsonl"`` on the
    card under ``cudnn_deterministic``, beside the same run with telemetry
    off (``O_PAIRS`` pairs, alternating which runs first): the log must
    validate with the port's
    validator and its trace export load back; every run's history and
    final weights and launch counts must equal the first off run's bit
    for bit; the virtual spans and ``traffic.*`` counters must equal the
    same run's on the CPU.  Prints the port's report, the median s/round
    of rounds 2-3 with telemetry on and off, and each round's split into the wall spans of
    ``O_STAGES``, and that of a fifth run (telemetry in memory, equal to
    the others too) with its ``O_TIMED`` engine calls timed.  Returns (launch counts of the first on run of each,
    record)."""
    import tempfile

    from repro_torch.kernels import KERNELS
    from repro_torch.obs import export_trace, validate_file
    from repro_torch.obs.report import render_report

    total = {k: 0 for k in KERNELS}
    rec = {}
    with tempfile.TemporaryDirectory() as tmp, cudnn_deterministic(torch):
        tmp = Path(tmp)
        for label, scheme, knobs in O_RUNS:
            parts = {"payload": [], "write": []}
            order = [tel for i in range(O_PAIRS)
                     for tel in (("off", "jsonl"), ("jsonl", "off"))[i % 2]]
            runs = []
            for i, tel in enumerate(order):
                # the first on run's saves are split into their halves
                with (save_parts(parts) if knobs.get("checkpoint_every")
                      and i == order.index("jsonl")
                      else contextlib.nullcontext()):
                    runs.append(o_run(torch, scheme, knobs, DEVICE, tmp,
                                      tel))
            calls = []
            runs.append(o_run(torch, scheme, knobs, DEVICE, tmp, "memory",
                              hook=lambda r: timed_calls(torch, r, calls)))
            off, on = runs[order.index("off")], runs[order.index("jsonl")]
            for r in runs:
                check(history_dicts(r[0]) == history_dicts(off[0]),
                      f"(o) {label}: a history differs with telemetry on")
                check(max_param_diff(r[0].params, off[0].params) == 0.0,
                      f"(o) {label}: final weights differ with telemetry "
                      "on")
                check(r[2] == off[2], f"(o) {label}: launches {r[2]} with "
                      f"telemetry on, {off[2]} off")
            for k in O_EXPECT[scheme]:
                check(on[2][k] > 0, f"(o) {label}: never launched {k}")
            for k, n in on[2].items():
                total[k] += n
            log = Path(on[0].cfg.telemetry_dir) / "events.jsonl"
            counts = validate_file(log)
            check(counts.get("metrics") == 1 and counts.get("span", 0) > 0,
                  f"(o) {label}: event counts {counts}")
            trace = json.loads(export_trace(on[3], tmp / "trace.json")
                               .read_text(encoding="utf-8"))
            n_x = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
            check(n_x == counts["span"],
                  f"(o) {label}: {n_x} complete events in the trace, "
                  f"{counts['span']} spans in the log")
            if knobs.get("checkpoint_every"):
                saves = [e for e in on[3] if e.get("type") == "span"
                         and e["name"] == "checkpoint.save"]
                check(len(saves) == ROUNDS,
                      f"(o) {label}: {len(saves)} checkpoint.save spans")
            _, _, _, cpu = o_run(torch, scheme, knobs, "cpu", tmp, "memory")
            virtual_match(label, on[3], cpu)
            secs = {tel: [[t1 - t0 for t0, t1 in r[1]]
                          for r, t in zip(runs, order) if t == want]
                    for tel, want in (("on", "jsonl"), ("off", "off"))}
            steady = {tel: [sum(r[1:]) / len(r[1:]) for r in v]
                      for tel, v in secs.items()}
            cost = {"median_on_s": statistics.median(steady["on"]),
                    "median_off_s": statistics.median(steady["off"]),
                    "pairs_on_slower": sum(
                        a > b for a, b in zip(steady["on"], steady["off"])),
                    "pairs": O_PAIRS}
            cost["ratio"] = cost["median_on_s"] / cost["median_off_s"]
            split = stage_split(on[3], on[1])
            names = [f"{c}.{m}" for c, m in O_TIMED]
            calls_split = stage_split(calls + runs[-1][3], runs[-1][1],
                                      tuple(names) + O_STAGES)
            rec[label] = {"s_per_round": secs, "cost": cost,
                          "stages": split,
                          "engine_calls": calls_split,
                          "events": counts, "launches": {
                              k: n for k, n in on[2].items() if n}}
            if parts["write"]:
                ms = {k: [1e3 * t for t in v] for k, v in parts.items()}
                rec[label]["save_ms"] = ms
                print(f"      saves: state to host {ms['payload']} ms, npz "
                      f"write {ms['write']} ms")
            print(f"  (o) {label}: events {counts}; launches "
                  f"{rec[label]['launches']} (equal on and off); history "
                  "and weights equal on and off bit for bit; virtual spans "
                  "and traffic equal the CPU run's; rounds 2-3, median "
                  f"s/round on {cost['median_on_s']:.4f}, off "
                  f"{cost['median_off_s']:.4f} (x{cost['ratio']:.3f}), on "
                  f"slower in {cost['pairs_on_slower']} of {O_PAIRS} pairs")
            for what, rows in (("", split),
                               ("engine calls timed, ", calls_split)):
                for i, row in enumerate(rows, 1):
                    cells = ", ".join(
                        f"{name} {v['s'] * 1e3:.3f} ms "
                        f"({100 * v['share']:.1f}%)"
                        for name, v in row.items() if name != "s")
                    print(f"      {what}round {i}: {row['s']:.4f} s; "
                          f"{cells}")
            for line in render_report(on[3]).splitlines():
                print(f"      | {line}")
    return total, rec


# path (v): step 9's multi-device part on logical shards of the card
# (``sharding.fl.logical_devices``: one device listed once a shard): the
# merge across shards, the sharded cohort trainer, the block-split server
# state and the expert-parallel MoE.  One card proves the shard
# arithmetic (padding to a multiple of the shard count, each shard's
# ordered partials, their fold, the block slices, the masked clones);
# NCCL and peer-to-peer copies need a second GPU.
V_SHARDS = 4
# max_width 3: 9 hidden and 3 anchored blocks, which 3 shards divide and
# 4 do not; 4 clients a round pad to 6 rows, 2 of them masked clones
V_SPLIT_SHARDS = 3
V_TOL = 1e-5  # the JAX package's ENGINE_SCRIPT and SHARDED_SCRIPT
# the JAX package's ENGINE_SCRIPT / SHARDED_SCRIPT schedule, and the
# fastest-K semi-async one
V_BASE = dict(num_clients=8, clients_per_round=3, eval_every=2, tau_fixed=2,
              tau_max=15, estimate=True)
V_ASYNC = dict(num_clients=10, clients_per_round=4, eval_every=100,
               tau_fixed=3, tau_max=15, estimate=False,
               round_mode="semi_async", async_k=2)
V_PINS = dict(SCHEME_KNOBS)  # path (c)'s pinned auto
V_ROUNDS, V2_ROUNDS, V4_EVENTS = 2, 3, 4
V_SCHEMES = ("fedavg", "heterofl", "flanc", "heroes")
V_EXPECT = ("compose", "conv_rank", "compose_apply")
# (v5): olmoe-1b-7b's MoE layer at its widths (d_model 2048, 64 experts,
# top-8, d_expert 1024), f32, capacity factor 8 so nothing drops, over 4
# x 512 tokens (the zoo's prefill shape) on a 2 x 4 grid.  Both
# formulations sum the same f32 products in other orders (TF32 off), and
# a token whose top-8 set flips between the two router calls (their
# logits are products of other shapes) is counted and left out
V_MOE_ARCH = "olmoe-1b-7b"
V_MOE_GRID = (2, 4)
V_MOE_X = (4, 512)
V_MOE_TOL = 1e-4
V_MOE_MAX_FLIPS = 8


def v_device(torch):
    """The card, with its index (``cuda`` -> ``cuda:0``); the CPU when
    rehearsed there."""
    from repro_torch.sharding import fl as flsh

    return flsh._concrete(DEVICE)


def v_sync(torch) -> None:
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def v_peak_start(torch) -> int:
    if DEVICE == "cpu":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def v_peak(torch, base: int) -> int:
    return 0 if DEVICE == "cpu" else torch.cuda.max_memory_allocated() - base


def v_diff(a, b) -> float:
    """The largest absolute difference of two params trees, split
    coefficients made whole."""
    from repro_torch.core.estimator import tree_leaves
    from repro_torch.sharding import fl as flsh

    return max(float((x - y).abs().max()) for x, y in zip(
        tree_leaves(flsh.assemble(a)), tree_leaves(flsh.assemble(b))))


def check_mesh(torch) -> dict:
    """Path (v)'s first case, (v0): the merge over 8 logical shards of the
    card, every shard holding a real client.  The JAX package's SCRIPT
    (8 clients' random block subsets, ``masked_block_merge`` over the
    shards against the host rule ``aggregate_coefficient``), and the
    trainer's hand-off: a stack of 8 rows on the 8 shards merged whole
    and as its first 4 rows (a fastest-K event), against plain means.
    Fails if the shard fold drops a partial or a stack passes through
    with rows the merge did not ask for."""
    import numpy as np

    from repro_torch.core import aggregation as agg
    from repro_torch.fl.client import ClientResult
    from repro_torch.fl.engine.collective import (CohortSlice, CohortStack,
                                                  CollectiveMerger)
    from repro_torch.sharding import fl as flsh

    dev = v_device(torch)
    with flsh.logical_devices(8, dev):
        mesh = flsh.cohort_mesh(0, dev)
    check(mesh is not None and mesh.size == 8, "(v0) no 8-shard mesh")
    rng = np.random.default_rng(0)
    nb, r, o = 9, 8, 64
    prev = torch.tensor(rng.normal(size=(nb, r, o)), dtype=torch.float32,
                        device=dev)
    ids, blocks = [], []
    for _ in range(8):
        take = np.sort(rng.choice(nb, size=rng.integers(1, nb + 1),
                                  replace=False))
        ids.append(take)
        blocks.append(torch.tensor(rng.normal(size=(len(take), r, o)),
                                   dtype=torch.float32, device=dev))
    host = agg.aggregate_coefficient(prev, blocks, ids)
    dense, mask = agg.scatter_contributions_host(blocks, ids, nb)
    merged = agg.masked_block_merge(flsh.split_rows(dense, mesh),
                                    flsh.split_rows(mask, mesh), prev,
                                    mesh=mesh)
    errs = {"script": float((merged - host).abs().max())}
    rows = torch.tensor(rng.normal(size=(8, nb, r, o)), dtype=torch.float32,
                        device=dev)
    stack = CohortStack([{"w": t} for t in flsh.split_rows(rows, mesh)], 8,
                        mesh)
    merger = CollectiveMerger(mesh)
    zero = {"w": torch.zeros_like(rows[0])}

    def results(js):
        return {j: ClientResult(CohortSlice(stack, j), {}, 0.0, 0.0)
                for j in js}

    for label, js in (("stack", range(8)), ("stack first 4", range(4))):
        got = merger.merge_dense_mean(zero, results(js))["w"]
        errs[label] = float((got - rows[list(js)].mean(0)).abs().max())
    err = max(errs.values())
    print(f"  (v0) merge over 8 logical shards: max_abs_err {err:.3e} "
          f"{json.dumps(errs)} (tolerance {V_TOL})")
    check(err <= V_TOL, f"(v0) the merge over 8 shards differs: {errs}")
    return errs


def v_runner(torch, setup, scheme, shards, **knobs):
    from repro_torch.fl import FLConfig, build_runner
    from repro_torch.sharding import fl as flsh

    dev = v_device(torch)
    if shards > 1:
        with flsh.logical_devices(shards, dev):
            return build_runner(scheme, *setup, cfg=FLConfig(**knobs),
                                device=dev)
    return build_runner(scheme, *setup, cfg=FLConfig(**knobs), device=dev)


def v_rounds(torch, runner, n: int) -> list:
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        runner.run_round()
        v_sync(torch)
        secs.append(time.perf_counter() - t0)
    return secs


def v1_merge(torch) -> dict:
    """(v1): the CNN at full width on ENGINE_SCRIPT's schedule (8
    clients, 3 a round, so the rows pad to 4), each scheme's 2 rounds on
    the collective merge over 4 shards against the same run on the host
    rules: wall times equal, params within ``V_TOL``."""
    from repro_torch.fl import build_image_setup

    setup = build_image_setup(num_clients=8, device=v_device(torch))
    rec = {}
    for scheme in V_SCHEMES:
        host = v_runner(torch, setup, scheme, 1, **V_BASE, **V_PINS,
                        agg_backend="host")
        mesh = v_runner(torch, setup, scheme, V_SHARDS, **V_BASE, **V_PINS)
        check(host.merger is None and mesh.merger.mesh.size == V_SHARDS,
              f"(v1 {scheme}) the merge is not over {V_SHARDS} shards")
        hm, mm = (timed_merges(torch, r, DEVICE) for r in (host, mesh))
        hs, ms = v_rounds(torch, host, V_ROUNDS), v_rounds(torch, mesh,
                                                           V_ROUNDS)
        for a, b in zip(host.history, mesh.history):
            check(a.wall_time == b.wall_time
                  and a.traffic_bytes == b.traffic_bytes,
                  f"(v1 {scheme}) round {a.round}'s schedule differs")
        diff = v_diff(host.params, mesh.params)
        rec[scheme] = {"max_param_diff": diff,
                       "merge_ms": [1e3 * t for t in mm],
                       "host_merge_ms": [1e3 * t for t in hm],
                       "s_per_round": ms, "host_s_per_round": hs}
        print(f"  (v1 {scheme}) merge over {V_SHARDS} shards against the "
              f"host rules: {json.dumps(rec[scheme])}")
        check(diff <= V_TOL, f"(v1 {scheme}) params differ by {diff:.3e}")
    return rec


def v2_split(torch) -> dict:
    """(v2): heroes, path (c)'s pinned auto, ``trainer="cohort"`` and
    ``shard_server_state`` on 3 shards, 3 rounds of 4 of 10 clients,
    against the same run on one shard: schedule, wall times and traffic
    equal, accuracy within 2 test samples, every coefficient split into
    3 slices after each round, and each composition kernel's training
    launches equal to the per-shard formula (each shard runs each group
    on its slice: 3 times ``expected_training_launches``)."""
    from repro_torch.fl import build_image_setup
    from repro_torch.kernels import LAUNCHES
    from repro_torch.sharding import fl as flsh

    setup = build_image_setup(num_clients=10, device=v_device(torch))
    knobs = dict(num_clients=10, clients_per_round=4, eval_every=1,
                 trainer="cohort", shard_server_state=True, **V_PINS)
    n_test = int(setup[3]["labels"].shape[0])
    runs = {}
    for shards in (1, V_SPLIT_SHARDS):
        runner = v_runner(torch, setup, "heroes", shards, **knobs)
        rec = record_training(runner)
        merges = timed_merges(torch, runner, DEVICE)
        base = v_peak_start(torch)
        before = dict(LAUNCHES)
        secs, splits = [], []
        for _ in range(V2_ROUNDS):
            secs += v_rounds(torch, runner, 1)
            splits.append([len(t["coeff"].parts)
                           if isinstance(t["coeff"], flsh.SplitBlocks)
                           else 1 for t in runner.params.values()])
        counts = {k: n - before[k] for k, n in LAUNCHES.items()}
        train = {k: counts[k] - rec["eval"][k] for k in COMPOSITION}
        want = {k: shards * n for k, n in expected_training_launches(
            runner, rec["assigns"], True).items()}
        r = {"s_per_round": secs, "merge_ms": [1e3 * t for t in merges],
             "peak_bytes": v_peak(torch, base), "slices": splits,
             "training_launches": train, "expected": want,
             "launches": {k: n for k, n in counts.items() if n},
             "accuracy": [h.accuracy for h in runner.history]}
        print(f"  (v2) heroes cohort, shard_server_state, {shards} "
              f"shard{'s' if shards > 1 else ''}: {json.dumps(r)}")
        check_run(torch, f"v2 {shards}", AssembledView(runner))
        check(train == want, f"(v2 {shards}) training launches {train}, "
              f"the per-shard formula {want}")
        for k in V_EXPECT:
            check(counts[k] > 0, f"(v2 {shards}) never launched {k}")
        runs[shards] = (runner, r)
    (one, r1), (split, r3) = runs[1], runs[V_SPLIT_SHARDS]
    check(all(s == [V_SPLIT_SHARDS] * len(s) for s in r3["slices"]),
          f"(v2) a coefficient is not split into {V_SPLIT_SHARDS}: "
          f"{r3['slices']}")
    for a, b in zip(one.history, split.history):
        check((a.wall_time, a.traffic_bytes, a.makespan, a.mean_tau) ==
              (b.wall_time, b.traffic_bytes, b.makespan, b.mean_tau),
              f"(v2) round {a.round}'s schedule differs from one shard")
        check(abs(a.accuracy - b.accuracy) <= 2.0 / n_test,
              f"(v2) round {a.round}'s accuracy differs from one shard")
    r3["max_param_diff_one_shard"] = v_diff(one.params, split.params)
    print(f"  (v2) s/round {r3['s_per_round']} on {V_SPLIT_SHARDS} shards "
          f"against {r1['s_per_round']} on one; merge ms "
          f"{r3['merge_ms']} against {r1['merge_ms']}; peak memory above "
          f"the start {r3['peak_bytes']} B against {r1['peak_bytes']} B; "
          f"max param diff {r3['max_param_diff_one_shard']:.3e}; "
          f"{card_line()}")
    return {"split": r3, "one_shard": r1}


class AssembledView:
    """A runner's view for ``check_run`` with split coefficients whole."""

    def __init__(self, runner):
        from repro_torch.sharding import fl as flsh

        self.history = runner.history
        self.bound_state = runner.bound_state
        self.params = flsh.assemble(runner.params)


def v3_odd(torch) -> dict:
    """(v3): an odd cohort, 3 of 8 clients on 4 shards (one masked clone
    row), gives each client the params the cohort on one shard gives,
    within ``V_TOL`` (fedavg, as SHARDED_SCRIPT; heroes pinned auto)."""
    from repro_torch.core.estimator import tree_leaves
    from repro_torch.fl import build_image_setup

    setup = build_image_setup(num_clients=8, device=v_device(torch))
    rec = {}
    for scheme in ("fedavg", "heroes"):
        coh = v_runner(torch, setup, scheme, V_SHARDS, **V_BASE, **V_PINS,
                       trainer="cohort")
        ref = v_runner(torch, setup, scheme, V_SHARDS, **V_BASE, **V_PINS,
                       trainer="cohort", trainer_mesh_devices=1)
        check(coh.trainer.mesh is not None and ref.trainer.mesh is None,
              f"(v3 {scheme}) the trainers' shards are not 4 and 1")
        _, a4 = coh.assignment.assign(coh.state, [0, 1, 2])
        _, a1 = ref.assignment.assign(ref.state, [0, 1, 2])
        r4 = coh.trainer.train_all(coh.state, a4)
        r1 = ref.trainer.train_all(ref.state, a1)
        worst, ok = 0.0, True
        for n in r1:
            for x, y in zip(tree_leaves(r4[n].host_params()),
                            tree_leaves(r1[n].host_params())):
                d = abs(x - y)
                worst = max(worst, float(d.max()))
                ok = ok and bool((d <= V_TOL + V_TOL * abs(y)).all())
        rec[scheme] = worst
        print(f"  (v3 {scheme}) 3 of 8 on {V_SHARDS} shards against one "
              f"shard: max per-client param diff {worst:.3e}")
        check(ok, f"(v3 {scheme}) per-client params differ: {worst:.3e}")
    return rec


def v4_async(torch) -> dict:
    """(v4): fastest-K semi-async (the fastest 2 of 4 in flight, 10
    clients, ``trainer="cohort"``), 4 events on the collective merge over
    4 shards against the host rules: wall times equal, no ``CohortSlice``
    left in flight after an event, params within ``V_TOL``; fedavg's
    all-fresh event merges a strict subset of a trained stack through
    the plain prep, not the stack as it lies."""
    from repro_torch.fl import build_image_setup
    from repro_torch.fl.engine.collective import CohortSlice

    setup = build_image_setup(num_clients=10, device=v_device(torch))
    rec = {}
    for scheme in ("fedavg", "heroes"):
        host = v_runner(torch, setup, scheme, V_SHARDS, **V_ASYNC, **V_PINS,
                        agg_backend="host", trainer="cohort")
        coll = v_runner(torch, setup, scheme, V_SHARDS, **V_ASYNC, **V_PINS,
                        trainer="cohort")
        seen = []  # (a strict subset of a stack's real rows, passed)
        stacked = coll.merger._device_stacked

        def spy(results, k_pad, stacked=stacked, seen=seen):
            out = stacked(results, k_pad)
            slices = [r.params for r in results.values()]
            if all(isinstance(p, CohortSlice) for p in slices):
                seen.append((len(slices) < slices[0].stack.n_real,
                             out is not None))
            return out

        coll.merger._device_stacked = spy
        for _ in range(V4_EVENTS):
            a, b = host.run_round(), coll.run_round()
            check(a.wall_time == b.wall_time,
                  f"(v4 {scheme}) event {a.round}'s wall time differs")
            check(not any(isinstance(t.result.params, CohortSlice)
                          for t in coll.state.in_flight),
                  f"(v4 {scheme}) a CohortSlice stayed in flight")
        diff = v_diff(host.params, coll.params)
        rec[scheme] = {"max_param_diff": diff, "subset_merges": seen,
                       "stale": [h.stale for h in coll.history]}
        print(f"  (v4 {scheme}) fastest-K on {V_SHARDS} shards against the "
              f"host rules: {json.dumps(rec[scheme])}")
        check(scheme != "fedavg" or ((True, False) in seen
                                     and (True, True) not in seen),
              f"(v4 {scheme}) no subset merge, or one passed: {seen}")
        check(diff <= V_TOL, f"(v4 {scheme}) params differ by {diff:.3e}")
    return rec


def v5_moe(torch, cfg=None, x_shape=V_MOE_X) -> dict:
    """(v5): ``apply_moe_shardmap`` on a 2 x 4 grid of the card against
    the port's ``moe.apply_moe`` at olmoe-1b-7b's layer widths, tokens
    whose top-8 set flips between the two router calls left out."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.moe_shardmap import apply_moe_shardmap

    dev = v_device(torch)
    cfg = cfg or configs.get_config(V_MOE_ARCH)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    base = v_peak_start(torch)
    gen = torch.Generator(dev).manual_seed(0)
    params = moe.init_moe(gen, cfg, torch.float32)
    B, S = x_shape
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    grid = [[dev] * V_MOE_GRID[1]] * V_MOE_GRID[0]
    with torch.no_grad():
        y = apply_moe_shardmap(params, cfg, x, grid)
        ref, _ = moe.apply_moe(params, cfg, x)
        ms = {}
        for label, fn in (("shardmap", lambda: apply_moe_shardmap(
                params, cfg, x, grid)),
                          ("apply_moe", lambda: moe.apply_moe(params, cfg,
                                                              x))):
            v_sync(torch)
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            v_sync(torch)
            ms[label] = 1e3 * (time.perf_counter() - t0) / 3
        ids = moe.router_topk(params["router"], x, cfg)[2]
        rows = B // V_MOE_GRID[0]
        shard_ids = torch.cat([moe.router_topk(
            params["router"], x[i * rows:(i + 1) * rows].reshape(-1,
                                                                cfg.d_model),
            cfg)[2].reshape(rows, S, -1) for i in range(V_MOE_GRID[0])])
        keep = (ids.sort(-1).values == shard_ids.sort(-1).values).all(-1)
    err = float((y - ref).abs().amax(-1)[keep].max())
    rec = {"max_abs_err": err, "flips": int((~keep).sum()),
           "tokens": B * S, "ms": ms, "peak_bytes": v_peak(torch, base),
           "finite": bool(torch.isfinite(y).all()),
           "expert_bytes": sum(params[k].numel() * 4
                               for k in ("gate", "up", "down"))}
    print(f"  (v5) {V_MOE_ARCH}'s MoE layer on a {V_MOE_GRID[0]}x"
          f"{V_MOE_GRID[1]} grid against moe.apply_moe: {json.dumps(rec)} "
          f"(tolerance {V_MOE_TOL}, at most {V_MOE_MAX_FLIPS} flips)")
    check(rec["finite"] and tuple(y.shape) == (B, S, cfg.d_model),
          "(v5) non-finite or misshapen output")
    check(rec["flips"] <= V_MOE_MAX_FLIPS, f"(v5) {rec['flips']} flips")
    check(err <= V_MOE_TOL, f"(v5) apply_moe_shardmap differs by {err:.3e}")
    del params
    return rec


def mesh_path(torch) -> tuple:
    """Path (v): (v0) the merge over 8 shards, (v1)-(v4) the CNN engine
    over logical shards of the card, (v5) the expert-parallel MoE; launch
    counts set to 0 just before and read just after.  Returns (launch
    counts, records)."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    recs = {"v0": check_mesh(torch)}
    reset_launches()
    recs["v1"] = v1_merge(torch)
    recs["v2"] = v2_split(torch)
    recs["v3"] = v3_odd(torch)
    recs["v4"] = v4_async(torch)
    recs["v5"] = v5_moe(torch)
    counts = dict(LAUNCHES)
    for k in V_EXPECT:
        check(counts[k] > 0, f"(v) never launched {k}")
    return counts, recs


def serve_path(torch, model, params):
    """Path (e)'s serving half: compose the heroes weights once per width
    and greedy-decode ``SERVE_STEPS`` tokens for ``SERVE_BATCH`` prompts
    through the decode-attention kernel; the same weights on the CPU must
    decode the same tokens, and the full-sequence training forward on the
    card must predict the generated continuation."""
    from repro_torch.fl import greedy_decode, serving_weights

    import numpy as np

    prompt = (np.arange(SERVE_BATCH * SERVE_PROMPT, dtype=np.int32)
              .reshape(SERVE_BATCH, SERVE_PROMPT) % model.num_classes)
    for width in (1, 2, 3):
        w = serving_weights(model, params, width)
        greedy_decode(model, w, width, prompt, SERVE_STEPS)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, logits = greedy_decode(model, w, width, prompt, SERVE_STEPS)
        dt = time.perf_counter() - t0
        n = toks.size
        wc = {k: t.cpu() for k, t in w.items()}
        toks_c, logits_c = greedy_decode(model, wc, width, prompt,
                                         SERVE_STEPS)
        rel = float(np.abs(logits - logits_c).max()
                    / max(1.0, float(np.abs(logits_c).max())))
        seq = torch.as_tensor(np.concatenate([prompt, toks], axis=1),
                              device=DEVICE)
        with torch.no_grad():
            full = model.forward(w, width, {"tokens": seq})
        pred = full.argmax(-1)[:, SERVE_PROMPT - 1:-1].cpu().numpy()
        print(f"      serve width {width}: batch {SERVE_BATCH}, prompt "
              f"{SERVE_PROMPT}, {SERVE_STEPS} steps: {dt:.4f} s, "
              f"tokens/s {n / dt:.1f}; vs CPU decode: tokens equal "
              f"{bool(np.array_equal(toks, toks_c))}, logits max rel diff "
              f"{rel:.3e}; full forward predicts the continuation "
              f"{bool(np.array_equal(pred, toks))}")
        check(toks.shape == (SERVE_BATCH, SERVE_STEPS),
              f"(e) width {width}: tokens of shape {toks.shape}")
        check(bool(np.isfinite(logits).all()),
              f"(e) width {width}: non-finite logits")
        check(np.array_equal(toks, toks_c),
              f"(e) width {width}: tokens differ from the CPU decode")
        check(rel <= 1e-4, f"(e) width {width}: logits differ from the CPU "
                           "decode")
        check(np.array_equal(pred, toks),
              f"(e) width {width}: the full forward disagrees with decode")


def ops_path(torch):
    """Path (f): ``kernels.ops.flash_attention`` and ``decode_attention``
    in model layout at a GQA shape (batch 2, 256 tokens, 2 KV heads x 4
    query heads, head_dim 64), f32 and bf16, each held against the same
    call on the CPU (the plain versions)."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(2)
    B, S, KV, G, D = 2, 256, 2, 4, 64
    for dtype in (torch.float32, torch.bfloat16):
        tn = str(dtype).split(".")[1]
        q = torch.randn((B, S, KV, G, D), generator=gen).to(dtype)
        k = torch.randn((B, S, KV, D), generator=gen).to(dtype)
        v = torch.randn((B, S, KV, D), generator=gen).to(dtype)
        lens = torch.tensor([S, S // 2 + 3], dtype=torch.int32)
        qd, kd, vd, ld = (t.to(DEVICE) for t in (q, k, v, lens))
        out = ops.flash_attention(qd, kd, vd)
        dec = ops.decode_attention(qd[:, -1:], kd, vd, ld)
        check(tuple(out.shape) == (B, S, KV, G, D) and out.dtype == dtype,
              f"(f) flash_attention {tn}: {tuple(out.shape)} {out.dtype}")
        check(tuple(dec.shape) == (B, 1, KV, G, D) and dec.dtype == dtype,
              f"(f) decode_attention {tn}: {tuple(dec.shape)} {dec.dtype}")
        close(torch, out.cpu(), ops.flash_attention(q, k, v), ATTN_TOL[tn],
              f"(f) ops.flash_attention {tn} vs the CPU")
        close(torch, dec.cpu(), ops.decode_attention(q[:, -1:], k, v, lens),
              ATTN_TOL[tn], f"(f) ops.decode_attention {tn} vs the CPU")


# path (g): zamba2-2.7b at full width and full depth, bf16 compute, f32
# params made on the card from the port's generator
ZAMBA_ARCH = "zamba2-2.7b"
PREFILL_BATCH, PREFILL_LEN = 4, 512  # 2 chunks of 256: a carried state
# launch/serve.py's defaults: 8 requests, batch 4, 16 new tokens, max 64
SERVE_KW = dict(requests=8, batch=4, max_new=16, max_len=64)
STEP_CHECK = 8  # prefill positions held against step-by-step serve_step
# bf16 through 63 blocks: the prefill (chunked SSD, flash attention) and
# the recurrent decode round to bf16 at different places, each op ~4e-3
# relative, accumulated over the depth
STEP_TOL = 0.1
# one superblock at full width in f32 (TF32 off) against the CPU: the
# CPU tests' 1e-4, relative to max(1, max|logits|)
CPU_BATCH, CPU_LEN, CPU_TOL = 2, 288, 1e-4  # 288 = 256 + a padded chunk
ZOO_EXPECT = frozenset({"rmsnorm", "ssd_chunk", "flash_attention",
                        "decode_attention"})
# the device functions of those kernels, as the profiler names them
PORT_SYMBOLS = {"flash_attention": ("flash_mma_kernel", "flash_ffma_kernel"),
                "decode_attention": ("decode_split_kernel",
                                     "decode_merge_kernel"),
                "ssd_chunk": ("ssd_scores_kernel", "ssd_mma_kernel",
                              "ssd_ffma_kernel"),
                "rmsnorm": ("rmsnorm_regs_kernel", "rmsnorm_generic_kernel")}


def zoo_path(torch, cfg=None):
    """Path (g): the zoo's serving path on zamba2-2.7b — a prefill of
    ``PREFILL_BATCH`` x ``PREFILL_LEN`` tokens (timed warm), its first
    positions held against step-by-step ``serve_step``, then
    ``launch/serve.py``'s loop at its defaults, greedy.  Launch counts
    are set to 0 just before and read just after.  ``cfg`` defaults to
    the full config.  Returns (counts, stats)."""
    from repro_torch import configs
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import model, module

    import numpy as np

    cfg = cfg or configs.get_config(ZAMBA_ARCH)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    params = model.init(0, cfg, DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = module.count_params(params)
    # init stacks each layer's draws, so its peak is its own: the
    # serving peak below is measured from the weights alone
    init_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (PREFILL_BATCH,
                                                       PREFILL_LEN)),
                           device=DEVICE)
    with torch.no_grad():
        model.prefill(params, cfg, {"tokens": toks})  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab)
              and logits.dtype == cfg.cdtype,
              f"(g) prefill logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()),
              "(g) non-finite prefill logits")
        cache = model.init_cache(cfg, PREFILL_BATCH, STEP_CHECK, DEVICE)
        steps = []
        for t in range(STEP_CHECK):
            lg, cache = model.serve_step(params, cfg,
                                         {"tokens": toks[:, t:t + 1]},
                                         cache, t)
            steps.append(lg)
    dec = torch.cat(steps, dim=1).float()
    pre = logits[:, :STEP_CHECK].float()
    step_err = err(torch, dec, pre, STEP_TOL,
                   f"(g) serve_step vs prefill, first {STEP_CHECK} positions, "
                   "bf16")
    agree = float((dec.argmax(-1) == pre.argmax(-1)).float().mean())
    del cache, steps, dec, pre, logits
    r = serve(cfg, params, device=DEVICE, **SERVE_KW)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    trace = trace_zoo(torch, cfg, params, toks)
    stats = {
        "config": f"{ZAMBA_ARCH}, {cfg.num_layers} layers, d_model "
                  f"{cfg.d_model}, {n_params} params ({cfg.param_dtype}), "
                  f"compute {cfg.compute_dtype}",
        "init_s": t_init,
        "prefill_s": t_prefill,
        "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / t_prefill,
        "serve_s": r["seconds"], "serve_tokens": r["tokens"],
        "serve_steps": r["steps"],
        "serve_tokens_per_s": r["tokens"] / r["seconds"],
        "init_peak_bytes": init_peak, "peak_bytes": peak,
        "step_vs_prefill_max_abs_err": step_err,
        "step_vs_prefill_argmax_agree": agree, "launches": counts,
        "trace": trace}
    print(f"  (g) {stats['config']}: init {t_init:.3f} s; prefill "
          f"{PREFILL_BATCH}x{PREFILL_LEN} {t_prefill:.4f} s "
          f"({stats['prefill_tokens_per_s']:.1f} tokens/s); serve "
          f"{r['done']}/{SERVE_KW['requests']} requests, {r['tokens']} "
          f"tokens in {r['steps']} steps, {r['seconds']:.4f} s "
          f"({stats['serve_tokens_per_s']:.2f} tokens/s); peak memory above "
          f"the run's start: init {init_peak} B, prefill and serving "
          f"{peak} B; serve_step argmax agrees with the "
          f"prefill at {agree:.4f} of positions; launches {counts}; "
          f"[{card_line()}]")
    check(r["done"] == SERVE_KW["requests"], "(g) not every request served")
    check(all(0 <= t < cfg.vocab for out in r["outputs"].values()
              for t in out), "(g) served a token outside the vocabulary")
    for k in ZOO_EXPECT:
        check(counts[k] > 0, f"(g) never launched {k}")
    del params
    torch.cuda.empty_cache()
    stats.update(zoo_vs_cpu(torch, cfg))
    return counts, stats


def trace_zoo(torch, cfg, params, toks, steps: int = 4,
              extra=None) -> dict:
    """One warm prefill (with the batch keys ``extra`` beside the tokens)
    and ``steps`` serve steps (an enc-dec model's over the memory of
    ``extra``'s frames, prefilled before) of a zoo path under
    ``torch.profiler``: wall
    time, device busy time (sum of kernel self times), their ratio, the
    kernels that took the most device time, and the device time of each
    of the port's kernels on the path.  The launch counts of these calls
    are not part of the path's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model

    out = {}
    B = toks.shape[0]
    for label in ("prefill", "decode"):
        cache = (model.init_cache(cfg, B, steps, DEVICE)
                 if label == "decode" else None)
        if cache is not None and "enc_embeddings" in (extra or {}):
            with torch.no_grad():  # the steps read the encoded memory
                model.prefill(params, cfg, {"tokens": toks[:, :1], **extra},
                              cache)
        torch.cuda.synchronize()
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if label == "prefill":
                model.prefill(params, cfg, {"tokens": toks, **(extra or {})})
            else:
                for t in range(steps):
                    model.serve_step(params, cfg,
                                     {"tokens": toks[:, t:t + 1]}, cache, t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in device)
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
        port = {}
        for name, symbols in PORT_SYMBOLS.items():
            mine = [e for e in device if any(s in e.key for s in symbols)]
            port[name] = (sum(e.self_device_time_total for e in mine) / 1e3,
                          sum(e.count for e in mine))
        out[label] = {
            "wall_s": wall, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e6 / wall,
            "device_kernels": sum(e.count for e in device),
            "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                    for e in top],
            "port_kernels": port}
        what = ("one prefill" if label == "prefill"
                else f"{steps} serve steps")
        print(f"      traced {what}: wall {wall:.4f} s, device busy "
              f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall:.2f}% of "
              f"the wall), {out[label]['device_kernels']} device kernels")
        for name, ms, n in out[label]["top"]:
            print(f"        {ms:9.3f} ms {n:6d}x {name}")
        print("        the port's kernels: " + ", ".join(
            f"{k} {ms:.3f} ms {n}x ({100 * ms * 1e3 / max(busy_us, 1):.2f} "
            "% of busy)" for k, (ms, n) in port.items()))
    return out


def zoo_vs_cpu(torch, cfg, layers=None, batch=CPU_BATCH, length=CPU_LEN,
               label="(g)", positions=None, tol=CPU_TOL, extra=None):
    """``layers`` of ``cfg`` (one superblock by default) at full width,
    f32 compute, TF32 off: the card's forward against the same forward on
    the CPU from the same weights, at ``batch`` x ``length`` tokens (for
    zamba2 a full chunk and a padded one), with ``positions`` when given
    and the CPU tensors of ``extra`` beside them (an enc-dec model's
    frames and mask), within ``tol`` of max(1, max |logits|).
    Greedy tokens (argmax at every position) must be equal.  For a MoE
    config, at its default capacity, the tokens whose top-k expert sets
    differ between the card and the CPU (in any MoE layer) are counted
    first, and the logits and greedy tokens held on the others."""
    from repro_torch.models import model, module

    import numpy as np

    n = layers or cfg.hybrid.attn_every
    cfg = cfg.replace(num_layers=n, compute_dtype="float32")
    params = model.init(1, cfg, DEVICE)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, length)))
    extra = dict(extra or {})
    if positions is not None:
        extra["positions"] = positions
    with torch.no_grad(), routing() as ids_g:
        g, _ = model.forward(params, cfg, {
            k: v.to(DEVICE) for k, v in dict(extra, tokens=toks).items()})
        g = g.cpu()
        ids_g = [i.cpu() for i in ids_g]
    params = module.tree_map(lambda t: t.cpu(), params)
    torch.cuda.empty_cache()
    with torch.no_grad(), routing() as ids_c:
        t0 = time.perf_counter()
        c, _ = model.forward(params, cfg, dict(extra, tokens=toks))
        t_cpu = time.perf_counter() - t0
    keep = routing_agree(torch, ids_g, ids_c, batch, length)
    flips = int((~keep).sum())
    if cfg.moe is not None:
        print(f"      {label} top-k expert sets differ between the card and "
              f"the CPU at {flips} of {batch * length} tokens ({len(ids_c)} "
              "MoE layers); held on the others")
        check(flips < batch * length, f"{label} every token's experts differ")
    e = err(torch, g[keep], c[keep], tol,
            f"{label} depth {n} f32 {batch}x{length}: card vs CPU logits")
    top2 = torch.topk(c[keep], 2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    same = bool(torch.equal(g.argmax(-1)[keep], c.argmax(-1)[keep]))
    print(f"      greedy tokens equal {same} over {int(keep.sum())} "
          f"positions (smallest top-2 margin on the CPU {margin:.3e}); CPU "
          f"forward {t_cpu:.2f} s")
    check(same, f"{label} greedy tokens differ between the card and the CPU")
    del params
    torch.cuda.empty_cache()
    out = {f"depth{n}_vs_cpu_max_abs_err": e, f"depth{n}_greedy_equal": same,
           f"depth{n}_min_top2_margin": margin}
    if cfg.moe is not None:
        out[f"depth{n}_expert_set_flips"] = flips
    return out


@contextlib.contextmanager
def routing():
    """The top-k expert ids (..., T, k) of every ``router_topk`` call made
    inside, in call order (one per MoE layer a forward or a step)."""
    from repro_torch.models import moe

    ids, orig = [], moe.router_topk

    def recorded(router_params, x2d, cfg):
        out = orig(router_params, x2d, cfg)
        ids.append(out[2].detach())
        return out

    moe.router_topk = recorded
    try:
        yield ids
    finally:
        moe.router_topk = orig


def routing_agree(torch, a, b, batch: int, length: int):
    """(batch, length) bool: the tokens whose top-k expert *sets* are the
    same in every MoE layer of two recordings of one forward (all True
    without MoE layers)."""
    keep = torch.ones((batch, length), dtype=torch.bool)
    for x, y in zip(a, b):
        x, y = (t.cpu().reshape(batch, length, -1).sort(-1).values
                for t in (x, y))
        keep &= (x == y).all(-1)
    return keep


# path (g)'s gradient: zamba2's smoke config in f32, the card's loss_fn
# backward against the CPU's; the leaves span 4e-5 to 0.2, so each is
# held relative to its own largest entry, at the tolerance the CPU tests
# hold the CPU's to jax.grad
GRAD_BATCH, GRAD_LEN = 2, 80
ZOO_GRAD_TOL = 1e-4
ZOO_FWD_KERNELS = ("rmsnorm", "ssd_chunk", "flash_attention")


def zoo_grad(torch):
    """One ``loss_fn`` backward on zamba2's smoke config (f32) on the card
    and on the CPU from the same weights and tokens.  The card's forward
    runs rmsnorm, ssd_chunk and flash attention (each must launch in it;
    their backward is their plain versions', ``kernels.ops``); every
    gradient leaf must match the CPU's."""
    from repro_torch import configs
    from repro_torch.core.estimator import tree_leaves
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import model, module

    import numpy as np

    cfg = configs.get_smoke(ZAMBA_ARCH).replace(compute_dtype="float32")
    params = model.init(0, cfg, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab,
                                             (GRAD_BATCH, GRAD_LEN))
    grads, counts = {}, None
    for dev in (DEVICE, "cpu"):
        p = module.tree_map(lambda t: t.detach().to(dev).requires_grad_(),
                            params)
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "labels": torch.as_tensor(np.roll(toks, -1, axis=1),
                                           device=dev)}
        reset_launches()
        loss, _ = model.loss_fn(p, cfg, batch)
        if dev != "cpu":
            counts = {k: LAUNCHES[k] for k in ZOO_FWD_KERNELS}
        loss.backward()
        grads[dev] = [t.grad.cpu() for t in tree_leaves(p)]
        check(all(g is not None for g in grads[dev]),
              f"(g) gradient: a leaf has no gradient on {dev}")
    worst = 0.0
    for g, c in zip(grads[DEVICE], grads["cpu"]):
        scale = max(1e-30, float(c.abs().max()))
        worst = max(worst, float((g - c).abs().max()) / scale)
    print(f"  (g) loss_fn backward, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, f32, {GRAD_BATCH}x{GRAD_LEN}: "
          f"{len(grads['cpu'])} leaves, worst error relative to the leaf "
          f"{worst:.3e} (tol {ZOO_GRAD_TOL:.0e}); launches in its forward "
          f"{counts}")
    check(math.isfinite(worst) and worst <= ZOO_GRAD_TOL,
          "(g) loss_fn gradients differ between the card and the CPU")
    check(all(n > 0 for n in counts.values()),
          f"(g) a zoo kernel never launched in the training forward: "
          f"{counts}")
    return {"leaves": len(grads["cpu"]), "worst_rel_err": worst,
            "forward_launches": counts}


# paths (p) and (q): the zoo's dense family at full width, bf16 compute,
# f32 params made on the card.  gemma-2b (the serving launcher's default
# arch) and stablelm-3b at full depth; deepseek-coder-33b and granite-34b
# with the depth cut to Q_DEPTH layers: their 62 and 88 f32 layers take
# 133.4 and 135.9 GB, past one card's 80 GB
DENSE_DEFAULT = "gemma-2b"
Q_DEPTH = 8
DENSE_Q = (("stablelm-3b", None), ("deepseek-coder-33b", Q_DEPTH),
           ("granite-34b", Q_DEPTH))
# (p) and (q) hold serve_step to the prefill within DENSE_STEP_TOL of
# max|logits|: 3x the largest sound reading, stablelm-3b's 1.87e-2 over 32
# bf16 layers (gemma-2b 7.1e-3, deepseek-coder-33b 1.2e-2, granite-34b
# 9.6e-3 at 8 layers; H100, bf16).  path (g)'s STEP_TOL is zamba2's 63
# blocks'.
DENSE_STEP_TOL = 0.06
# (p)'s sliding-window variant: teacher-forced serve_step over WINDOW_LEN
# tokens through a ring of WINDOW slots (wrapping twice) against forward
# with the same window, within RING_TOL: ~4x its sound reading (7.4e-3 of
# max|logits|, H100, bf16).  The same check must fail two planted faults
# (a ring one slot too wide; one slot left stale at STALE_AT for the next
# WINDOW - 1 steps), so the limit tells a broken ring from rounding.
WINDOW, WINDOW_BATCH, WINDOW_LEN = 16, 2, 48
RING_TOL = 0.03
STALE_AT = WINDOW + 4
# (p)'s int8 KV cache: INT8_STEPS decode steps against the compute-type
# cache, within the reference's bound (tests/test_arch_smoke.py:104)
INT8_STEPS, INT8_TOL = 8, 0.05
# (p)'s training: the launcher's step function and data (AdamW, cosine
# schedule over the steps, SyntheticTextTask with numpy seed 0), on the
# full model and, held against the CPU, on one layer at full width in f32
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 8, 64, 3
TRAIN_CPU_BATCH, TRAIN_CPU_LEN, TRAIN_CPU_STEPS = 2, 32, 2
TRAIN_CPU_TOL = 1e-5  # loss and grad_norm, f32, relative
# one layer at full width in f32 against the CPU
DENSE_CPU_BATCH, DENSE_CPU_LEN = 2, 128


def dense_attention_shapes() -> tuple:
    """The attention calls of paths (p), (q), (r) and (t), from the
    configs: each arch's prefill (``PREFILL_BATCH`` x ``PREFILL_LEN``,
    causal), and its decode over serve's cache (``SERVE_KW``'s batch and
    ``max_len``) and over the step check's (``STEP_CHECK`` slots);
    gemma's windowed forward and ring decode, its int8 cache's decode
    (the dequantized cache, ``2 * INT8_STEPS`` slots) and its training
    forward; (r) and (t)'s step-check forward over ``STEP_CHECK`` tokens,
    their f32 layers against the CPU, and olmoe's training forward.
    Returns (flash, decode) lists of (label, B, S, KV, G, D, window)."""
    from repro_torch import configs

    flash, decode = [], []
    for arch in (DENSE_DEFAULT, *(a for a, _ in DENSE_Q)):
        c = configs.get_config(arch)
        h = (c.num_kv_heads, c.q_per_kv, c.resolved_head_dim)
        flash.append((f"{arch} prefill", PREFILL_BATCH, PREFILL_LEN, *h, 0))
        decode += [(f"{arch} serve", SERVE_KW["batch"], SERVE_KW["max_len"],
                    *h, 0),
                   (f"{arch} step check", PREFILL_BATCH, STEP_CHECK, *h, 0)]
        if arch == DENSE_DEFAULT:
            flash += [(f"{arch} window", WINDOW_BATCH, WINDOW_LEN, *h,
                       WINDOW),
                      (f"{arch} train", TRAIN_BATCH, TRAIN_LEN, *h, 0)]
            decode += [(f"{arch} ring", WINDOW_BATCH, WINDOW, *h, 0),
                       (f"{arch} int8", PREFILL_BATCH, 2 * INT8_STEPS, *h,
                        0)]
    # paths (r) and (t): the same prefill, step-check and serve calls,
    # olmoe's training forward and each arch's f32 layer against the CPU
    for arch in (MOE_DEFAULT, KIMI, VLM_ARCH):
        c = configs.get_config(arch)
        h = (c.num_kv_heads, c.q_per_kv, c.resolved_head_dim)
        flash += [(f"{arch} prefill", PREFILL_BATCH, PREFILL_LEN, *h, 0),
                  (f"{arch} step-check forward", PREFILL_BATCH, STEP_CHECK,
                   *h, 0),
                  (f"{arch} vs the CPU", DENSE_CPU_BATCH, DENSE_CPU_LEN, *h,
                   0)]
        decode += [(f"{arch} serve", SERVE_KW["batch"], SERVE_KW["max_len"],
                    *h, 0),
                   (f"{arch} step check", PREFILL_BATCH, STEP_CHECK, *h, 0)]
        if arch == MOE_DEFAULT:
            flash.append((f"{arch} train", TRAIN_BATCH, TRAIN_LEN, *h, 0))
    return flash, decode


def launch_diff(before: dict) -> dict:
    """Launches of each kernel since the snapshot ``before``."""
    from repro_torch.kernels import LAUNCHES

    return {k: n - before[k] for k, n in LAUNCHES.items() if n > before[k]}


def dense_serving(torch, label, cfg, params) -> dict:
    """A prefill of ``PREFILL_BATCH`` x ``PREFILL_LEN`` tokens (timed
    warm), its first ``STEP_CHECK`` positions held against step-by-step
    ``serve_step``, and one prefill and 4 serve steps traced."""
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import model

    import numpy as np

    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)), device=DEVICE)
    prefill = make_prefill(cfg)
    with torch.no_grad():
        prefill(params, {"tokens": toks})  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab)
              and logits.dtype == cfg.cdtype,
              f"{label} prefill logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()),
              f"{label} non-finite prefill logits")
        cache = model.init_cache(cfg, PREFILL_BATCH, STEP_CHECK, DEVICE)
        steps = []
        for t in range(STEP_CHECK):
            lg, cache = model.serve_step(params, cfg,
                                         {"tokens": toks[:, t:t + 1]},
                                         cache, t)
            steps.append(lg)
    dec = torch.cat(steps, dim=1).float()
    pre = logits[:, :STEP_CHECK].float()
    step_err = err(torch, dec, pre, DENSE_STEP_TOL,
                   f"{label} serve_step vs prefill, first {STEP_CHECK} "
                   "positions, bf16")
    agree = float((dec.argmax(-1) == pre.argmax(-1)).float().mean())
    del cache, steps, dec, pre, logits
    return {"prefill_s": t_prefill,
            "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / t_prefill,
            "step_vs_prefill_max_abs_err": step_err,
            "step_vs_prefill_argmax_agree": agree,
            "trace": trace_zoo(torch, cfg, params, toks)}


def ring_steps(torch, cfg, params, toks, stale_at=None):
    """Teacher-forced ``serve_step`` logits over ``toks`` through a ring of
    ``cfg.sliding_window`` slots.  With ``stale_at``, the slot that step
    writes is put back as it was after the step (a planted fault: the
    next ``WINDOW - 1`` steps attend a key from a window earlier)."""
    from repro_torch.models import model

    cache = model.init_cache(cfg, toks.shape[0], toks.shape[1], DEVICE)
    smax = cache["k"].shape[2]
    check(smax == cfg.sliding_window,
          f"(p) ring of {smax} slots, not {cfg.sliding_window}")
    steps = []
    for t in range(toks.shape[1]):
        if t == stale_at:
            old = {n: cache[n][:, :, t % smax].clone() for n in ("k", "v")}
        steps.append(model.serve_step(params, cfg,
                                      {"tokens": toks[:, t:t + 1]},
                                      cache, t)[0])
        if t == stale_at:
            for n, a in old.items():
                cache[n][:, :, t % smax] = a
    return torch.cat(steps, 1).float()


def window_check(torch, cfg, params) -> dict:
    """(p)'s sliding-window variant: teacher-forced ``serve_step`` over
    ``WINDOW_LEN`` tokens through a ring of ``WINDOW`` slots against the
    forward with the same window, within ``RING_TOL``; then the same
    comparison of two planted faults, which must exceed it: a ring of
    ``WINDOW + 1`` slots (it attends one token the forward masks) and a
    ring whose slot ``STALE_AT % WINDOW`` goes stale."""
    from repro_torch.models import model

    import numpy as np

    cfg = cfg.replace(sliding_window=WINDOW)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (WINDOW_BATCH, WINDOW_LEN)), device=DEVICE)
    with torch.no_grad():
        full = model.forward(params, cfg, {"tokens": toks})[0].float()
        sound = ring_steps(torch, cfg, params, toks)
        wide = ring_steps(torch, cfg.replace(sliding_window=WINDOW + 1),
                          params, toks)
        stale = ring_steps(torch, cfg, params, toks, stale_at=STALE_AT)
    e = err(torch, sound, full, RING_TOL,
            f"(p) window {WINDOW}: serve_step through the ring vs the "
            f"windowed forward, {WINDOW_BATCH}x{WINDOW_LEN}, bf16")
    scale = max(1.0, float(full.abs().max()))
    planted = {"ring_one_slot_wide": float((wide - full).abs().max())
               / scale,
               "slot_stale_at_step_" + str(STALE_AT):
               float((stale - full).abs().max()) / scale}
    print(f"  (p) window {WINDOW}, planted faults, max |diff| / max "
          f"|logits| against the windowed forward: {planted} (each must "
          f"exceed {RING_TOL})")
    for k, v in planted.items():
        check(math.isfinite(v) and v > RING_TOL,
              f"(p) the ring check passes a planted fault ({k})")
    return {"window_vs_forward_max_abs_err": e,
            "window_vs_forward_max_rel_err": e / scale,
            "window_planted_max_rel_err": planted}


def int8_check(torch, cfg, params) -> float:
    """(p)'s int8 KV cache: ``INT8_STEPS`` teacher-forced decode steps
    against the compute-type cache's; the reference's bound on max |diff|
    over max |logits|."""
    from repro_torch.models import model

    import numpy as np

    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (PREFILL_BATCH, INT8_STEPS)), device=DEVICE)
    outs = []
    for c in (cfg, cfg.replace(kv_cache_quant="int8")):
        cache = model.init_cache(c, PREFILL_BATCH, 2 * INT8_STEPS, DEVICE)
        with torch.no_grad():
            outs.append(torch.cat([model.serve_step(
                params, c, {"tokens": toks[:, t:t + 1]}, cache, t)[0]
                for t in range(INT8_STEPS)], 1).float())
        check(("k_scale" in cache) == (c.kv_cache_quant == "int8"),
              "(p) the int8 cache has no scales")
    rel = float((outs[0] - outs[1]).abs().max() / outs[0].abs().max())
    print(f"  (p) int8 KV cache, {INT8_STEPS} steps: max |diff| / max "
          f"|logits| {rel:.3e} against the {cfg.compute_dtype} cache (tol "
          f"{INT8_TOL})")
    check(math.isfinite(rel) and rel < INT8_TOL,
          "(p) the int8 KV cache strays from the compute-type cache")
    return rel


def train_steps(torch, cfg, params, seqs, batch, steps, device):
    """``steps`` steps of the launcher's step function (AdamW, cosine
    schedule over the steps, warm-up 5) on batches drawn from ``seqs`` by
    ``lm_batches`` with numpy seed 0 (for the audio family with the
    launcher's stub frames: ``AUDIO_TRAIN_FRAMES`` of them from a
    generator seeded by the step, all valid).  Returns (params, losses,
    grad norms, per-step seconds, per-step launches)."""
    from repro_torch.data import lm_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.frontends import audio_frame_embeddings
    from repro_torch.optim import cosine_schedule, make_optimizer

    import numpy as np

    opt = make_optimizer("adamw", cosine_schedule(3e-3, steps, 5))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    losses, norms, secs, launched = [], [], [], []
    for i in range(steps):
        toks, labels = lm_batches(seqs, batch, rng)
        b = {"tokens": torch.as_tensor(toks % cfg.vocab, device=device),
             "labels": torch.as_tensor(labels % cfg.vocab, device=device)}
        if cfg.family == "audio":
            b.update(audio_frame_embeddings(
                torch.Generator(device).manual_seed(i), batch,
                AUDIO_TRAIN_FRAMES, cfg.d_model))
        before = dict(LAUNCHES)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        secs.append(time.perf_counter() - t0)
        launched.append(launch_diff(before))
    del state
    return params, losses, norms, secs, launched


def forward_launches(cfg) -> dict:
    """The fewest launches of each zoo kernel one forward of ``cfg``'s
    stack makes: flash attention once an attention layer (an enc-dec
    decoder layer has two), rmsnorm at
    each RMSNorm (two a decoder layer and the final norm; the xLSTM's
    ``out_norm`` and ``gn``, one a layer, its LayerNorms plain)."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return {"rmsnorm": L}
    if cfg.family == "audio":  # encoder, decoder self and cross
        return {"flash_attention": cfg.encdec.num_encoder_layers + 2 * L}
    out = {"flash_attention": L}
    if cfg.norm == "rmsnorm":
        out["rmsnorm"] = 2 * L + 1
    return out


def dense_train(torch, cfg, params, task, label="(p)") -> dict:
    """A zoo path's training: ``TRAIN_STEPS`` AdamW steps of the model at
    ``TRAIN_BATCH`` x ``TRAIN_LEN`` tokens.  The loss (with a MoE's aux
    loss) must be finite and fall, and the stack's kernels must launch in
    each step's forward (``forward_launches``)."""
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, losses, norms, secs, launched = train_steps(
        torch, cfg, params, task.train, TRAIN_BATCH, TRAIN_STEPS, DEVICE)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"  {label} training, {TRAIN_STEPS} AdamW steps of {cfg.arch_id} "
          f"({cfg.num_layers} layers) at {TRAIN_BATCH}x{TRAIN_LEN}: losses "
          f"{losses}, grad norms {norms}, s/step {secs}; peak memory above "
          f"the weights {peak} B; launches per step {launched}; "
          f"[{card_line()}]")
    check(all(math.isfinite(x) for x in losses + norms),
          f"{label} a non-finite training loss or gradient norm")
    check(losses[-1] < losses[0], f"{label} the training loss did not fall: "
                                  f"{losses}")
    least = forward_launches(cfg)
    for n in launched:
        check(all(n.get(k, 0) >= m for k, m in least.items()),
              f"{label} a training step's forward skipped a kernel: {n}")
    return {"losses": losses, "grad_norms": norms, "s_per_step": secs,
            "peak_bytes": peak, "launches_per_step": launched}


def dense_train_vs_cpu(torch, cfg, task) -> dict:
    """The training step function on one layer of ``cfg`` at full width,
    f32, TF32 off, on the card and on the CPU from the same weights and
    batches (``TRAIN_CPU_BATCH`` x ``TRAIN_CPU_LEN``): loss and grad_norm
    within ``TRAIN_CPU_TOL``; the parameters as the CPU tests hold the
    port's to the reference's (AdamW steps an entry whose gradient is
    rounding noise either way: within twice the summed rates, and 1e-5
    in all but 1e-3 of the entries)."""
    from repro_torch.core.estimator import tree_leaves
    from repro_torch.models import model, module
    from repro_torch.optim import cosine_schedule

    cfg = cfg.replace(num_layers=1, compute_dtype="float32")
    params = model.init(2, cfg, DEVICE)
    cpu = module.tree_map(lambda t: t.cpu(), params)
    seqs = task.train[:, :TRAIN_CPU_LEN + 1]
    runs = {}
    for dev, p in ((DEVICE, params), ("cpu", cpu)):
        runs[dev] = train_steps(torch, cfg, p, seqs, TRAIN_CPU_BATCH,
                                TRAIN_CPU_STEPS, dev)
    (pg, lg, ng, _, _), (pc, lc, nc, sc, _) = runs[DEVICE], runs["cpu"]
    rates = sum(float(cosine_schedule(3e-3, TRAIN_CPU_STEPS, 5)(
        torch.tensor(s))) for s in range(1, TRAIN_CPU_STEPS + 1))
    worst, beyond = 0.0, 0.0
    for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
        d = (a.detach().cpu() - b.detach()).abs()
        worst = max(worst, float(d.max()))
        beyond = max(beyond, float((d > 1e-5).float().mean()))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    norm_rel = max(abs(a - b) / abs(b) for a, b in zip(ng, nc))
    print(f"  (p) training step on 1 layer, f32, {TRAIN_CPU_BATCH}x"
          f"{TRAIN_CPU_LEN}, {TRAIN_CPU_STEPS} steps, card vs CPU: losses "
          f"{lg} / {lc} (worst rel {loss_rel:.3e}), grad norms rel "
          f"{norm_rel:.3e}, params max |diff| {worst:.3e} (bound "
          f"{2 * rates:.3e}), share beyond 1e-5 {beyond:.3e}; CPU s/step "
          f"{sc}")
    check(loss_rel <= TRAIN_CPU_TOL and norm_rel <= TRAIN_CPU_TOL,
          "(p) the training step's loss or grad_norm differs from the CPU's")
    check(worst <= 2 * rates and beyond < 1e-3,
          "(p) the training step's parameters differ from the CPU's")
    del params, cpu, pg, pc
    torch.cuda.empty_cache()
    return {"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
            "param_max_abs_diff": worst, "param_share_beyond_1e-5": beyond}


def dense_report(torch, label, cfg, n_params, t_init, init_peak, serving,
                 r, peak, counts) -> dict:
    stats = dict(serving, config=(
        f"{cfg.arch_id}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} params ({cfg.param_dtype}), compute "
        f"{cfg.compute_dtype}"), init_s=t_init, serve_s=r["seconds"],
        serve_tokens=r["tokens"], serve_steps=r["steps"],
        serve_tokens_per_s=r["tokens"] / r["seconds"],
        init_peak_bytes=init_peak, peak_bytes=peak, launches=counts)
    print(f"  {label} {stats['config']}: init {t_init:.3f} s; prefill "
          f"{PREFILL_BATCH}x{PREFILL_LEN} {serving['prefill_s']:.4f} s "
          f"({serving['prefill_tokens_per_s']:.1f} tokens/s); serve "
          f"{r['done']}/{r['requests']} requests, {r['tokens']} tokens in "
          f"{r['steps']} steps, {r['seconds']:.4f} s "
          f"({stats['serve_tokens_per_s']:.2f} tokens/s); peak memory above "
          f"the run's start: init {init_peak} B, serving {peak} B; "
          f"serve_step argmax agrees with the prefill at "
          f"{serving['step_vs_prefill_argmax_agree']:.4f} of positions; "
          f"launches {counts}; [{card_line()}]")
    what = f"{label} {cfg.arch_id}"
    check(r["done"] == r["requests"], f"{what}: not every request served")
    check(all(0 <= t < cfg.vocab for out in r["outputs"].values()
              for t in out), f"{what}: served a token outside the vocabulary")
    expect = family_kernels(cfg)
    for k, n in counts.items():
        check((n > 0) == (k in expect),
              f"{what}: {k} launched {n} times (expected: {sorted(expect)})")
    return stats


def family_kernels(cfg) -> frozenset:
    """The port's kernels a zoo arch's prefill and serving launch: the
    attention kernels wherever there is attention (the audio family's
    encoder, decoder and cross-attention alike), rmsnorm wherever a norm
    is an RMSNorm (LayerNorm stays plain PyTorch, in the reference and the
    port alike: seamless launches none; the xLSTM's ``out_norm`` and
    ``gn`` are RMSNorms whatever ``cfg.norm``), and nothing else."""
    if cfg.family == "ssm":
        return frozenset({"rmsnorm"})
    attn = frozenset({"flash_attention", "decode_attention"})
    return attn | ({"rmsnorm"} if cfg.norm == "rmsnorm" else frozenset())


def init_timed(torch, cfg):
    """``model.init`` on the card: (params, seconds, parameter count, its
    peak memory above the call's start)."""
    from repro_torch.models import model, module

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, cfg, DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    # init stacks each layer's draws, so its peak is its own: the
    # serving peak is measured from the weights alone
    init_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    return params, t_init, module.count_params(params), init_peak


def dense_default_path(torch, cfg=None):
    """Path (p): gemma-2b at full width and depth through the normal entry
    points: a 4 x 512 prefill held against step-by-step ``serve_step``,
    the sliding-window variant and the int8 KV cache, 3 AdamW steps of
    the training launcher's step function, then ``launch/serve.py``'s
    ``main`` with no arguments (its default arch, on the card), one layer
    in f32 against the CPU and the training step against the CPU's.  The
    launch counts are set to 0 just before and read just after.  ``cfg``
    defaults to the full config.  Returns (counts, stats)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticTextTask
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve

    cfg = cfg or configs.get_config(DENSE_DEFAULT)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reset_launches()
    params, t_init, n_params, init_peak = init_timed(torch, cfg)
    serving = dense_serving(torch, "(p)", cfg, params)
    serving.update(window_check(torch, cfg, params))
    serving["int8_rel"] = int8_check(torch, cfg, params)
    peak = torch.cuda.max_memory_allocated() - base
    # the training launcher's data: 512 tokens of the vocabulary
    task = SyntheticTextTask(vocab=512, seq_len=TRAIN_LEN)
    train = dense_train(torch, cfg, params, task)
    del params
    torch.cuda.empty_cache()
    full = cfg == configs.get_config(DENSE_DEFAULT)
    r = serve.main(["--device", DEVICE] + ([] if full else ["--smoke"]))
    check(r["arch"] == DENSE_DEFAULT,
          f"(p) launch/serve.py served {r['arch']} by default")
    counts = dict(LAUNCHES)
    stats = dense_report(torch, "(p)", cfg, n_params, t_init, init_peak,
                         serving, r, peak, counts)
    stats["train"] = train
    torch.cuda.empty_cache()
    stats.update(zoo_vs_cpu(torch, cfg, layers=1, batch=DENSE_CPU_BATCH,
                            length=DENSE_CPU_LEN, label="(p)"))
    stats["train_vs_cpu"] = dense_train_vs_cpu(torch, cfg, task)
    return counts, stats


def serve_times(torch) -> dict:
    """Tokens/s of ``launch/serve.py``'s ``serve()`` at its defaults on the
    full gemma-2b, three runs after a warm one: a host-bound loop, for
    ``chip_compare.py`` to set two trees side by side."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import model

    cfg = configs.get_config(DENSE_DEFAULT)
    params = model.init(0, cfg, DEVICE)
    serve(cfg, params, device=DEVICE, **SERVE_KW)  # warm-up
    out = {}
    for i in range(3):
        r = serve(cfg, params, device=DEVICE, **SERVE_KW)
        out[f"serve_tokens_per_s_{i}"] = r["tokens"] / r["seconds"]
    del params
    torch.cuda.empty_cache()
    return out


def dense_q_path(torch, cfgs=None):
    """Path (q): stablelm-3b at full depth, deepseek-coder-33b and
    granite-34b at full width and ``Q_DEPTH`` layers: each a 4 x 512
    prefill against step-by-step ``serve_step``, then ``launch/serve.py``'s
    loop at its defaults.  deepseek must launch rmsnorm, the LayerNorm
    archs none.  The launch counts are set to 0 just before each arch and
    read just after.  ``cfgs`` defaults to the full configs with the
    cuts.  Returns (the summed counts, stats by arch)."""
    from repro_torch import configs
    from repro_torch.kernels import KERNELS, LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve

    if cfgs is None:
        cfgs = [configs.get_config(a).replace(
            num_layers=d or configs.get_config(a).num_layers)
            for a, d in DENSE_Q]
    total = {k: 0 for k in KERNELS}
    stats = {}
    for cfg in cfgs:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        reset_launches()
        params, t_init, n_params, init_peak = init_timed(torch, cfg)
        label = f"(q) {cfg.arch_id}"
        serving = dense_serving(torch, label, cfg, params)
        r = serve(cfg, params, device=DEVICE, **SERVE_KW)
        peak = torch.cuda.max_memory_allocated() - base
        counts = dict(LAUNCHES)
        stats[cfg.arch_id] = dense_report(torch, "(q)", cfg, n_params,
                                          t_init, init_peak, serving, r,
                                          peak, counts)
        for k, n in counts.items():
            total[k] += n
        del params
    torch.cuda.empty_cache()
    return total, stats


# paths (r), (s) and (t): the zoo's moe, ssm and vlm families at full
# width, bf16 compute.  (r) olmoe-1b-7b at full depth (16 layers, f32
# params, 27.7 GB) and its training at R_TRAIN_DEPTH layers (AdamW's
# moments beside all 16 would pass 80 GB); kimi-k2-1t-a32b with its bf16
# params at K_DEPTH of its 61 layers, the first_k_dense dense layer and
# one MoE layer of 384 experts (39.2 GB: its 60 MoE layers take 2 TB);
# (s) xlstm-125m and (t) qwen2-vl-7b at full size
MOE_DEFAULT = "olmoe-1b-7b"
KIMI = "kimi-k2-1t-a32b"
R_TRAIN_DEPTH = 4
K_DEPTH = 2
XLSTM_ARCH = "xlstm-125m"
VLM_ARCH = "qwen2-vl-7b"
# the step checks' argmax agreement with the forward: (p) and (q)'s
# lowest sound reading was deepseek-coder-33b's 0.906 (PR 23)
STEP_AGREE = 0.9
# (s)'s step check runs in f32, and it and (s)'s card-vs-CPU check are
# held to XLSTM_F32_TOL of max |logits|.  xlstm-125m at full size grows
# rounding ~1e3-fold (``rounding_floor``: weights moved by 1e-7 relative
# move its f32 logits by 2.0e-4 of their max), so its f32 steps sit
# 4.0e-4 from the forward and its superblock 1.2e-4 from the CPU (H100,
# PR 24);
# in bf16 decode parts from the forward by over half of max |logits|, in
# the reference as in the port (tests/test_torch_xlstm.py::
# test_full_size_bf16_decode_drifts_as_the_references).  The limit is 5x
# the larger reading; a wrong state update misses by O(1)
XLSTM_F32_TOL = 2e-3
# (t)'s M-RoPE ids: a VLM_GRID x VLM_GRID patch grid (t 0, h and w the
# patch's row and column), then text whose three ids continue from
# VLM_GRID, as Qwen2-VL numbers an image followed by text
VLM_GRID = 16


def vision_positions(torch, batch: int, length: int):
    """(batch, 3, length) int32 M-RoPE ids: an image's patch grid, then
    text (``VLM_GRID``)."""
    n = min(VLM_GRID * VLM_GRID, length)
    j = torch.arange(length)
    text = j - n + VLM_GRID
    ids = torch.stack([torch.where(j < n, 0, text),
                       torch.where(j < n, j // VLM_GRID, text),
                       torch.where(j < n, j % VLM_GRID, text)])
    return ids.to(torch.int32)[None].expand(batch, 3, length).contiguous()


def family_serving(torch, label, cfg, params, positions=None,
                   frames=None) -> dict:
    """(r)-(u)'s serving half: a warm timed prefill of
    ``PREFILL_BATCH`` x ``PREFILL_LEN`` tokens (with ``positions`` when
    given, and an enc-dec model's ``frames``: its ``enc_embeddings`` and
    ``enc_mask``), then ``STEP_CHECK`` teacher-forced ``serve_step`` calls
    (with the same positions; over the frames' memory, encoded into the
    cache by ``model.prefill`` first) against the forward over those
    tokens, within ``DENSE_STEP_TOL`` and ``STEP_AGREE``.  A MoE takes
    the check in the no-drop regime (capacity factor E/k: every token
    fits), where a
    4 x 512 forward and a 4-token step drop different tokens by
    construction; its tokens whose top-k expert sets differ between the
    forward and the steps (bf16 rounds the two differently) are counted
    and left out.  The xLSTM takes it in f32, within ``XLSTM_F32_TOL``:
    its bf16 steps are reported beside their prefill, not held (see
    ``XLSTM_F32_TOL``).  Then one prefill and 4 serve steps are traced."""
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import model

    import numpy as np

    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)), device=DEVICE)
    extra = {} if positions is None else {"positions": positions.to(DEVICE)}
    extra.update(frames or {})
    prefill = make_prefill(cfg)
    with torch.no_grad():
        prefill(params, {"tokens": toks, **extra})  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": toks, **extra})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab)
          and logits.dtype == cfg.cdtype,
          f"{label} prefill logits {tuple(logits.shape)} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()),
          f"{label} non-finite prefill logits")
    pre = logits[:, :STEP_CHECK].float()
    del logits

    def at(t0, t1):
        b = {"tokens": toks[:, t0:t1]}
        if positions is not None:
            b["positions"] = extra["positions"][..., t0:t1]
        return b

    def steps(c):
        cache = model.init_cache(c, PREFILL_BATCH, STEP_CHECK, DEVICE)
        with torch.no_grad(), routing() as ids:
            if frames:
                model.prefill(params, c, {"tokens": toks[:, :1], **frames},
                              cache)
            out = [model.serve_step(params, c, at(t, t + 1), cache, t)[0]
                   for t in range(STEP_CHECK)]
        return torch.cat(out, dim=1).float(), ids

    out = {"prefill_s": t_prefill,
           "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / t_prefill}
    step_cfg, tol = cfg, DENSE_STEP_TOL
    if cfg.moe is not None:
        step_cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    if cfg.family == "ssm":
        dec, _ = steps(cfg)
        rel = float((dec - pre).abs().max()) / max(1.0, float(
            pre.abs().max()))
        print(f"  {label} bf16 serve_step vs the prefill, first "
              f"{STEP_CHECK} positions: max |diff| / max |logits| {rel:.3e} "
              "(not held: bf16 rounding grows through the recurrences, "
              "in the reference too)")
        out["bf16_step_vs_prefill_max_rel_err"] = rel
        step_cfg, tol = cfg.replace(compute_dtype="float32"), XLSTM_F32_TOL
    if step_cfg is cfg:
        ref, ref_ids = pre, []
    else:
        with torch.no_grad(), routing() as ref_ids:
            ref = model.forward(params, step_cfg,
                                at(0, STEP_CHECK))[0].float()
    if cfg.family == "ssm":
        out["f32_rounding_floor"] = floor = rounding_floor(
            torch, step_cfg, params, at(0, STEP_CHECK), ref)
        print(f"  {label} weights moved by 1e-7 relative move the f32 "
              f"forward's logits by {floor:.3e} of max |logits|")
    dec, step_ids = steps(step_cfg)
    n = len(ref_ids)  # MoE layers; the steps record them layer by layer
    by_layer = [torch.stack(step_ids[i::n], dim=1) for i in range(n)]
    keep = routing_agree(torch, ref_ids, by_layer, PREFILL_BATCH,
                         STEP_CHECK).to(DEVICE)
    flips = int((~keep).sum())
    what = (f"{label} serve_step vs the forward, first {STEP_CHECK} "
            f"positions, {step_cfg.compute_dtype}")
    if cfg.moe is not None:
        print(f"  {label} no-drop step check: top-k expert sets differ "
              f"between the forward and the steps at {flips} of "
              f"{keep.numel()} tokens ({n} MoE layers); held on the others")
        check(flips < keep.numel(), f"{what}: every token's experts differ")
        out["step_check_expert_set_flips"] = flips
    out["step_vs_prefill_max_abs_err"] = err(torch, dec[keep], ref[keep],
                                             tol, what)
    agree = float((dec.argmax(-1) == ref.argmax(-1))[keep].float().mean())
    print(f"  {label} serve_step argmax agrees with the forward at "
          f"{agree:.4f} of positions (at least {STEP_AGREE})")
    check(agree >= STEP_AGREE, f"{what}: argmax agreement {agree}")
    out["step_vs_prefill_argmax_agree"] = agree
    del dec, ref, pre
    out["trace"] = trace_zoo(torch, cfg, params, toks, extra=extra)
    dec_trace = out["trace"]["decode"]
    print(f"  {label} a traced decode step: {1e3 * dec_trace['wall_s'] / 4:.3f}"
          f" ms of wall, {dec_trace['busy_ms'] / 4:.3f} ms of device time")
    return out


def rounding_floor(torch, cfg, params, batch, ref) -> float:
    """How far rounding alone moves ``cfg``'s outputs: max |logits' -
    ``ref``| / max(1, max |ref|), where logits' is the forward on
    ``batch`` with every weight moved by 1e-7 relative (seeded draws)
    and ``ref`` the forward's own logits."""
    from repro_torch.models import model, module

    gen = torch.Generator(DEVICE).manual_seed(0)
    moved = module.tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen, device=t.device, dtype=t.dtype)), params)
    with torch.no_grad():
        out = model.forward(moved, cfg, batch)[0].float()
    return float((out - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def moe_path(torch, cfgs=None, train_depth=R_TRAIN_DEPTH):
    """Path (r): olmoe-1b-7b at full width and depth, and kimi-k2-1t-a32b
    at full width with its bf16 params and ``K_DEPTH`` layers, each
    through ``family_serving`` and ``launch/serve.py``'s loop at its
    defaults; olmoe's training (``TRAIN_STEPS`` AdamW steps at
    ``train_depth`` layers); then each arch's first MoE layer (kimi's
    after its dense one) in f32 against the CPU at the default capacity.
    The launch counts are set to 0 just before each arch and read just
    after its serving (and olmoe's training).  ``cfgs`` defaults to the
    full configs with the cuts.  Returns (the summed counts, stats by
    arch)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticTextTask
    from repro_torch.kernels import KERNELS, LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import model, module

    if cfgs is None:
        cfgs = [configs.get_config(MOE_DEFAULT),
                configs.get_config(KIMI).replace(num_layers=K_DEPTH)]
    total = {k: 0 for k in KERNELS}
    stats = {}
    for cfg in cfgs:
        label = f"(r) {cfg.arch_id}"
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        reset_launches()
        params, t_init, n_params, init_peak = init_timed(torch, cfg)
        serving = family_serving(torch, label, cfg, params)
        r = serve(cfg, params, device=DEVICE, **SERVE_KW)
        peak = torch.cuda.max_memory_allocated() - base
        del params
        torch.cuda.empty_cache()
        st = dense_report(torch, "(r)", cfg, n_params, t_init, init_peak,
                          serving, r, peak, dict(LAUNCHES))
        print(f"  {label} serve loop: {1e3 * r['seconds'] / r['steps']:.3f} "
              "ms a step")
        if cfg.arch_id == MOE_DEFAULT:
            tcfg = cfg.replace(num_layers=train_depth)
            params = model.init(0, tcfg, DEVICE)
            st["train_params"] = module.count_params(params)
            st["train"] = dense_train(
                torch, tcfg, params,
                SyntheticTextTask(vocab=512, seq_len=TRAIN_LEN), label="(r)")
            del params
            torch.cuda.empty_cache()
        st["launches"] = counts = dict(LAUNCHES)
        for k, n in counts.items():
            total[k] += n
        st.update(zoo_vs_cpu(torch, cfg, layers=cfg.moe.first_k_dense + 1,
                             batch=DENSE_CPU_BATCH, length=DENSE_CPU_LEN,
                             label=label))
        stats[cfg.arch_id] = st
    return total, stats


def xlstm_layer_times(torch, cfg, params) -> dict:
    """Host seconds of the mLSTM and of the sLSTM layers in one warm
    ``PREFILL_BATCH`` x ``PREFILL_LEN`` prefill, each layer synchronized
    on both sides (the sLSTM a host loop of one cell a token)."""
    from repro_torch.models import model, xlstm

    import numpy as np

    secs = {"mlstm": 0.0, "slstm": 0.0}
    orig = {k: getattr(xlstm, f"apply_{k}") for k in secs}

    def timed(kind):
        def layer(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[kind](*args)
            torch.cuda.synchronize()
            secs[kind] += time.perf_counter() - t0
            return out
        return layer

    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)), device=DEVICE)
    try:
        for k in secs:
            setattr(xlstm, f"apply_{k}", timed(k))
        with torch.no_grad():
            model.prefill(params, cfg, {"tokens": toks})
    finally:
        for k, fn in orig.items():
            setattr(xlstm, f"apply_{k}", fn)
    per = cfg.xlstm.slstm_every
    n_s = cfg.num_layers // per
    print(f"  (s) a {PREFILL_BATCH}x{PREFILL_LEN} prefill's layers: "
          f"{cfg.num_layers - n_s} mLSTM {secs['mlstm']:.4f} s, {n_s} sLSTM "
          f"{secs['slstm']:.4f} s ({PREFILL_LEN} cell steps each)")
    return secs


def xlstm_path(torch, cfg=None):
    """Path (s): xlstm-125m at full size: ``family_serving`` (with the
    mLSTM and sLSTM layers' shares of a prefill timed apart),
    ``launch/serve.py``'s loop at its defaults, ``TRAIN_STEPS`` AdamW
    steps, and one superblock in f32 against the CPU (within
    ``XLSTM_F32_TOL``).  rmsnorm must
    launch (the mLSTM's ``out_norm``, the sLSTM's ``gn``), the attention
    kernels never.  The launch counts are set to 0 just before and read
    just after.  Returns (counts, stats)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticTextTask
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve

    cfg = cfg or configs.get_config(XLSTM_ARCH)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reset_launches()
    params, t_init, n_params, init_peak = init_timed(torch, cfg)
    serving = family_serving(torch, "(s)", cfg, params)
    serving["layer_seconds"] = xlstm_layer_times(torch, cfg, params)
    r = serve(cfg, params, device=DEVICE, **SERVE_KW)
    peak = torch.cuda.max_memory_allocated() - base
    stats = dense_report(torch, "(s)", cfg, n_params, t_init, init_peak,
                         serving, r, peak, dict(LAUNCHES))
    stats["train"] = dense_train(
        torch, cfg, params, SyntheticTextTask(vocab=512, seq_len=TRAIN_LEN),
        label="(s)")
    stats["launches"] = counts = dict(LAUNCHES)
    del params
    torch.cuda.empty_cache()
    stats.update(zoo_vs_cpu(torch, cfg, layers=cfg.xlstm.slstm_every,
                            batch=DENSE_CPU_BATCH, length=DENSE_CPU_LEN,
                            label="(s)", tol=XLSTM_F32_TOL))
    return counts, stats


def vlm_path(torch, cfg=None):
    """Path (t): qwen2-vl-7b at full size: ``family_serving`` with (B, 3,
    S) M-RoPE positions whose t, h and w ids differ (``vision_positions``:
    a patch grid, then text), ``launch/serve.py``'s loop at its defaults
    ((B, 3, 1) positions), and one layer in f32 against the CPU on such
    positions.  The launch counts are set to 0 just before and read just
    after.  Returns (counts, stats)."""
    from repro_torch import configs
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve

    cfg = cfg or configs.get_config(VLM_ARCH)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reset_launches()
    params, t_init, n_params, init_peak = init_timed(torch, cfg)
    serving = family_serving(
        torch, "(t)", cfg, params,
        positions=vision_positions(torch, PREFILL_BATCH, PREFILL_LEN))
    r = serve(cfg, params, device=DEVICE, **SERVE_KW)
    peak = torch.cuda.max_memory_allocated() - base
    counts = dict(LAUNCHES)
    stats = dense_report(torch, "(t)", cfg, n_params, t_init, init_peak,
                         serving, r, peak, counts)
    del params
    torch.cuda.empty_cache()
    stats.update(zoo_vs_cpu(
        torch, cfg, layers=1, batch=DENSE_CPU_BATCH, length=DENSE_CPU_LEN,
        label="(t)", positions=vision_positions(torch, DENSE_CPU_BATCH,
                                                DENSE_CPU_LEN)))
    return counts, stats


# path (u): the zoo's audio family, seamless-m4t-medium (arXiv:2308.11596)
# at full size (12 encoder and 12 decoder layers, d_model 1024, 16 heads
# of 64, d_ff 4096, an untied 256206-token vocabulary; f32 params, bf16
# compute) over stub frame embeddings (``frontends.
# audio_frame_embeddings``): the prefill's 4 rows hold AUDIO_FRAMES
# frames (the config's encoder_seq) of which AUDIO_VALID are valid, from
# a full memory down to one frame
AUDIO_ARCH = "seamless-m4t-medium"
AUDIO_FRAMES = 4096
AUDIO_VALID = (4096, 3000, 2048, 1)
# training: the launcher's 64 frames beside TRAIN_BATCH x TRAIN_LEN tokens
AUDIO_TRAIN_FRAMES = 64
# one encoder and one decoder layer in f32 against the CPU, at
# DENSE_CPU_BATCH x DENSE_CPU_LEN tokens over AUDIO_CPU_FRAMES frames of
# which AUDIO_CPU_VALID are valid (a shorter memory keeps the CPU's f32
# encoder to seconds); the compose-then-matmul check takes the same batch
AUDIO_CPU_FRAMES = 1024
AUDIO_CPU_VALID = (1024, 700)


def audio_attention_shapes() -> tuple:
    """The attention calls of path (u), from seamless's config: its
    prefill (encoder non-causal over the frames, decoder causal, the
    cross-attention's queries over the memory with its valid counts), the
    training step's, the f32 layers' against the CPU (and the
    compose-then-matmul check's); decode over serve's self cache and the
    step check's, and over the memory: the step check's ragged counts and
    serve's unfilled memory (counts 0).  Returns (flash, decode) lists:
    (label, B, Sq, Sk, KV, G, D, causal, counts or None) and (label, B,
    S, KV, G, D, lengths or None: ragged)."""
    from repro_torch import configs

    c = configs.get_config(AUDIO_ARCH)
    h = (c.num_kv_heads, c.q_per_kv, c.resolved_head_dim)
    B, L, F = PREFILL_BATCH, PREFILL_LEN, AUDIO_FRAMES
    tb, tl, tf = TRAIN_BATCH, TRAIN_LEN, AUDIO_TRAIN_FRAMES
    cb, cl, cf = DENSE_CPU_BATCH, DENSE_CPU_LEN, AUDIO_CPU_FRAMES
    flash = [("seamless encoder", B, F, F, *h, False, None),
             ("seamless decoder", B, L, L, *h, True, None),
             ("seamless cross", B, L, F, *h, False, AUDIO_VALID),
             ("seamless train encoder", tb, tf, tf, *h, False, None),
             ("seamless train decoder", tb, tl, tl, *h, True, None),
             ("seamless train cross", tb, tl, tf, *h, False, (tf,) * tb),
             ("seamless vs the CPU encoder", cb, cf, cf, *h, False, None),
             ("seamless vs the CPU decoder", cb, cl, cl, *h, True, None),
             ("seamless vs the CPU cross", cb, cl, cf, *h, False,
              AUDIO_CPU_VALID)]
    decode = [("seamless serve", SERVE_KW["batch"], SERVE_KW["max_len"], *h,
               None),
              ("seamless step check", B, STEP_CHECK, *h, None),
              ("seamless cross decode", B, F, *h, AUDIO_VALID),
              ("seamless serve cross, unfilled memory", SERVE_KW["batch"],
               F, *h, (0,) * SERVE_KW["batch"])]
    return flash, decode


def audio_frames(torch, cfg, batch, frames, valid, seed=0) -> dict:
    """Stub frames of ``cfg`` (``enc_embeddings`` and their prefix
    ``enc_mask``, ``valid`` frames a row) from a generator on the card
    seeded by ``seed``."""
    from repro_torch.models.frontends import audio_frame_embeddings

    return audio_frame_embeddings(
        torch.Generator(DEVICE).manual_seed(seed), batch, frames,
        cfg.d_model, torch.tensor(valid, device=DEVICE))


def audio_launches(torch, cfg, params, frames) -> dict:
    """The launches of one ``make_prefill`` call and of one ``serve_step``
    over the frames' memory, against the formula: flash attention
    ``num_encoder_layers + 2 * num_layers`` times a prefill (encoder,
    decoder, cross), decode attention ``2 * num_layers`` a step (self,
    cross), and nothing else.  Also the memory cache's bytes."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import model

    import numpy as np

    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)), device=DEVICE)
    before = dict(LAUNCHES)
    make_prefill(cfg)(params, {"tokens": toks, **frames})
    per_prefill = launch_diff(before)
    cache = model.init_cache(cfg, PREFILL_BATCH, 1, DEVICE)
    with torch.no_grad():
        model.prefill(params, cfg, {"tokens": toks[:, :1], **frames}, cache)
        before = dict(LAUNCHES)
        model.serve_step(params, cfg, {"tokens": toks[:, :1]}, cache, 0)
    per_step = launch_diff(before)
    mem_bytes = sum(cache[k].numel() * cache[k].element_size()
                    for k in ("mem_k", "mem_v"))
    L, Le = cfg.num_layers, cfg.encdec.num_encoder_layers
    want_prefill = {"flash_attention": Le + 2 * L}
    want_step = {"decode_attention": 2 * L}
    print(f"  (u) launches of one prefill {per_prefill} (formula "
          f"{want_prefill}), of one serve step {per_step} (formula "
          f"{want_step}); the memory cache holds {mem_bytes} B")
    check(per_prefill == want_prefill,
          f"(u) one prefill launched {per_prefill}, not {want_prefill}")
    check(per_step == want_step,
          f"(u) one serve step launched {per_step}, not {want_step}")
    return {"launches_per_prefill": per_prefill,
            "launches_per_serve_step": per_step,
            "memory_cache_bytes": mem_bytes}


def audio_compose_check(torch, cfg) -> dict:
    """One encoder and one decoder layer of ``cfg`` at full width with
    Heroes composition (``max_width`` 2, rank d / 4), f32, on the card:
    the forward with ``set_compose_then_matmul(True)`` (each factorized
    linear composed by the compose kernel, then multiplied) against the
    factorized forward, within ``CPU_TOL`` of max |logits|; compose must
    launch once per factorized linear (6 in the encoder layer, 10 in the
    decoder layer) and nowhere in the factorized forward."""
    from repro_torch.configs.base import CompositionConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model, module

    import numpy as np

    c = cfg.replace(num_layers=1, compute_dtype="float32",
                    encdec=dataclasses.replace(cfg.encdec,
                                               num_encoder_layers=1),
                    composition=CompositionConfig(
                        enabled=True, max_width=2, rank=cfg.d_model // 4))
    params = model.init(3, c, DEVICE)
    b = audio_frames(torch, c, DENSE_CPU_BATCH, AUDIO_CPU_FRAMES,
                     AUDIO_CPU_VALID, seed=3)
    b["tokens"] = torch.as_tensor(np.random.default_rng(3).integers(
        0, c.vocab, (DENSE_CPU_BATCH, DENSE_CPU_LEN)), device=DEVICE)
    out, launched = {}, {}
    try:
        for then in (False, True):
            module.set_compose_then_matmul(then)
            before = dict(LAUNCHES)
            with torch.no_grad():
                out[then] = model.forward(params, c, b)[0].float()
            launched[then] = launch_diff(before)
    finally:
        module.set_compose_then_matmul(False)
    e = err(torch, out[True], out[False], CPU_TOL,
            "(u) one encoder and one decoder layer, composition max width "
            "2, f32: compose-then-matmul vs factorized")
    print(f"      launches: factorized {launched[False]}, compose-then-"
          f"matmul {launched[True]}")
    check(launched[True].get("compose", 0) == 16,
          f"(u) compose-then-matmul launched compose "
          f"{launched[True].get('compose', 0)} times, not 16")
    check("compose" not in launched[False],
          "(u) the factorized forward launched compose")
    del params
    torch.cuda.empty_cache()
    return {"compose_vs_factorized_max_abs_err": e,
            "compose_launches": launched[True]["compose"]}


def audio_path(torch, cfg=None):
    """Path (u): seamless-m4t-medium at full size through the zoo's entry
    points: ``init`` (timed, its peak), ``family_serving`` over
    ``AUDIO_FRAMES`` frames a row (``AUDIO_VALID`` valid), the launches of
    one prefill and one step against the formula (``audio_launches``),
    ``launch/serve.py``'s loop at ``SERVE_KW``, ``TRAIN_STEPS`` AdamW
    steps at ``TRAIN_BATCH`` x ``TRAIN_LEN`` tokens and
    ``AUDIO_TRAIN_FRAMES`` frames, one encoder and one decoder layer in
    f32 against the CPU, and the compose-then-matmul check (compose
    launches there).  The launch counts are set to 0 just before and read
    just after.  ``cfg``
    defaults to the full config.  Returns (counts, stats)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticTextTask
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve

    cfg = cfg or configs.get_config(AUDIO_ARCH)
    label = "(u)"
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reset_launches()
    params, t_init, n_params, init_peak = init_timed(torch, cfg)
    frames = audio_frames(torch, cfg, PREFILL_BATCH,
                          min(AUDIO_FRAMES, cfg.encdec.encoder_seq),
                          [min(v, cfg.encdec.encoder_seq)
                           for v in AUDIO_VALID])
    serving = family_serving(torch, label, cfg, params, frames=frames)
    serving["prefill_frames_per_s"] = (serving["prefill_tokens_per_s"]
                                       * AUDIO_FRAMES / PREFILL_LEN)
    serving.update(audio_launches(torch, cfg, params, frames))
    r = serve(cfg, params, device=DEVICE, **SERVE_KW)
    peak = torch.cuda.max_memory_allocated() - base
    stats = dense_report(torch, label, cfg, n_params, t_init, init_peak,
                         serving, r, peak, dict(LAUNCHES))
    del frames
    stats["train"] = dense_train(
        torch, cfg, params, SyntheticTextTask(vocab=512, seq_len=TRAIN_LEN),
        label=label)
    del params
    torch.cuda.empty_cache()
    one = cfg.replace(encdec=dataclasses.replace(cfg.encdec,
                                                 num_encoder_layers=1))
    cpu_frames = audio_frames(torch, one, DENSE_CPU_BATCH, AUDIO_CPU_FRAMES,
                              AUDIO_CPU_VALID, seed=1)
    stats.update(zoo_vs_cpu(
        torch, one, layers=1, batch=DENSE_CPU_BATCH, length=DENSE_CPU_LEN,
        label=label, extra={k: t.cpu() for k, t in cpu_frames.items()}))
    stats.update(audio_compose_check(torch, cfg))
    stats["launches"] = counts = dict(LAUNCHES)
    return counts, stats


# --------------------------------------------------------------------------
# path (w): the production meshes, as rank 0 of a fake world of 256 / 512
# --------------------------------------------------------------------------

# label: (arch, shape, multi-pod, the dry run's flags), each at full width
# and depth, one step
W_PAIRS = {
    "w1": ("gemma-2b", "train_4k", False, {}),
    "w2": ("zamba2-2.7b", "prefill_32k", False, {}),
    "w3": ("kimi-k2-1t-a32b", "decode_32k", True, {"moe_shardmap": True}),
    "w4": ("gemma-2b", "prefill_32k", False, {"composition": True}),
    "w5": ("xlstm-125m", "long_500k", False, {}),
}
# the kernels each pair must launch on its local shards
W_KERNELS = {"w1": ("flash_attention", "rmsnorm"),
             "w2": ("ssd_chunk", "flash_attention", "rmsnorm"),
             "w3": ("decode_attention", "rmsnorm"),
             "w4": ("rank_apply", "flash_attention", "rmsnorm"),
             "w5": ()}
W_EXPECT = ("flash_attention", "decode_attention", "ssd_chunk",
            "rank_apply", "rmsnorm")
# (w0): the projections' conventions (sharding/rules.py's docstring) on
# gemma-2b's stacked params at 16x16, and kimi-k2's experts on 2x16x16
W_RULES = {
    "gemma-2b": {"embed.table": ("model", "data"),
                 "stack.layers.attn.wq.w": (None, "data", "model"),
                 "stack.layers.attn.wo.w": (None, "model", "data"),
                 "stack.layers.mlp.up.w": (None, "data", "model"),
                 "stack.layers.mlp.down.w": (None, "model", "data"),
                 "stack.layers.ln1.scale": (None, None)},
    "kimi-k2-1t-a32b": {
        "stack.moe_layers.moe.gate": (None, ("pod", "model"), "data", None),
        "stack.moe_layers.moe.down": (None, ("pod", "model"), None, "data")},
}
# (w6): the shapes of the local-shard checks (16 x 16 mesh): flash with
# its KV heads over "model", flash under attn_qseq (gemma's heads), and
# rmsnorm's rows over "data"
W6_FLASH = (32, 1024, 16, 1, 128)   # B, S, KV, G, D
W6_QSEQ = (32, 2048, 1, 8, 256)
W6_RMS = (32, 4096, 2048)
# and the factorized linear of (w4): gemma-2b's query projection (B, S,
# d_in, d_out) at the dry run's width 2 and rank d_model / 4, which takes
# rank_apply over 128 basis chunks of 64 x 64; in f32 the chunk sums are
# held at rank_apply's sums' tolerance, in bf16 at two bf16 roundings of
# an O(1) output (the one-device einsum rounds x.v, the kernel does not);
# a chunk left out moves y by ~1e-1
W6_COMP = (16, 256, 2048, 2048, 2, 512)
W6_COMP_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
W_TIMEOUT = 900


def w_case(what: str, err: float, ok: bool) -> float:
    """One (w0)/(w6) case's line, in phase 2's form."""
    print(f"  {what}: max_abs_err {err:.3e}")
    check(ok, f"{what} disagrees")
    return err


def w_close(torch, got, want, tol, what: str) -> float:
    """``close`` that fails, rather than raises, on a shape mismatch (a
    shard laid out otherwise than the op's placements say)."""
    if tuple(got.shape) != tuple(want.shape):
        return w_case(f"{what} (shape {tuple(got.shape)} != "
                      f"{tuple(want.shape)})", math.inf, False)
    return close(torch, got, want, tol, what)


def w_plain_flash(torch, q, k, v, causal=True):
    """The model-layout plain attention (``_flash_math`` in the kernel's
    layout, as ``kernels.ops.flash_attention`` lays it out)."""
    from repro_torch.kernels.flash_attention import _flash_math

    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, Sq, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, D)
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, D)
    out = _flash_math(qf, kf, vf, causal, 0, G)
    return out.reshape(B, KV, G, Sq, D).permute(0, 3, 1, 2, 4)


def check_dryrun(torch) -> dict:
    """Path (w)'s checks, in a fake world of 256 of its own: (w0) the
    rules' projection conventions and the residual layout, (w6) a
    ``local_map``ped flash (KV heads over "model", then the query sequence
    under ``attn_qseq``), rmsnorm and the factorized linear (rank_apply in
    basis chunks, f32 and bf16) on rank 0's shard against the plain
    version on that shard and the slice of the one-device call."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import _rmsnorm_math
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import module
    from repro_torch.sharding import context, rules

    def lay(t, spec, mesh):
        return distribute_tensor(t, mesh, rules.to_placements(
            rules._fit_to_shape(spec, t.shape, rules.mesh_axes(mesh)),
            mesh), src_data_rank=None)

    rec = {}
    bad = 0
    for arch, want in W_RULES.items():
        pod = arch == "kimi-k2-1t-a32b"
        axes = rules.MeshAxes({"pod": 2, "data": 16, "model": 16} if pod
                              else {"data": 16, "model": 16})
        flat = {}

        def walk(tree, prefix=""):
            for k, v in tree.items():
                name = f"{prefix}.{k}" if prefix else k
                if isinstance(v, dict):
                    walk(v, name)
                else:
                    flat[name] = v

        walk(rules.param_specs(specs.params_shape(configs.get_config(arch)),
                               mesh=axes, zero_pod=pod))
        bad += sum(tuple(flat[p]) != s for p, s in want.items())
    rec["rules"] = w_case("(w0) rules: the projections' specs (mismatches)",
                          bad, bad == 0)
    gen = torch.Generator(DEVICE).manual_seed(0)

    def rand(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.float32).to(dtype)

    with fake_world(256):
        mesh = make_production_mesh(device_type=torch.device(DEVICE).type)
        with context.activation_sharding(mesh, "data"):
            x = lay(torch.empty(W6_RMS, device=DEVICE), (None,), mesh)
            got = context.constrain_residual(x).placements
            want = rules.to_placements(rules.Spec("data", None, "model"),
                                       mesh)
            rec["residual"] = w_case(
                f"(w0) residual d_sharded placements {got}", float(
                    got != want), got == want)
        # flash, KV heads over "model": rank 0 holds batch rows 0-1, head 0
        q, k, v = (rand(W6_FLASH), rand(W6_FLASH[:3] + W6_FLASH[4:]),
                   rand(W6_FLASH[:3] + W6_FLASH[4:]))
        dp, b = "data", W6_FLASH[0] // 16
        got = ops.flash_attention(lay(q, (dp, None, "model"), mesh),
                                  lay(k, (dp, None, "model"), mesh),
                                  lay(v, (dp, None, "model"), mesh))
        loc = [t[:b, :, :1] for t in (q, k, v)]
        tol = ATTN_TOL["bfloat16"]
        whole = ops.flash_attention(q, k, v)
        rec["flash_heads"] = max(
            w_close(torch, got.to_local(), w_plain_flash(torch, *loc), tol,
                    "(w6) flash heads over model vs plain on the shard"),
            w_close(torch, got.to_local(), whole[:b, :, :1], tol,
                    "(w6) flash heads over model vs the one-device call"))
        del got, whole
        # flash under attn_qseq: rank 0 holds the first S/16 queries
        q, k, v = (rand(W6_QSEQ), rand(W6_QSEQ[:3] + W6_QSEQ[4:]),
                   rand(W6_QSEQ[:3] + W6_QSEQ[4:]))
        c = W6_QSEQ[1] // 16
        with context.activation_sharding(mesh, "data", attn_qseq=True):
            got = ops.flash_attention(lay(q, (dp, "model"), mesh),
                                      lay(k, (dp,), mesh),
                                      lay(v, (dp,), mesh))
        whole = ops.flash_attention(q, k, v)
        rec["flash_qseq"] = max(
            w_close(torch, got.to_local(), w_plain_flash(
                torch, q[:b, :c], k[:b, :c], v[:b, :c]), tol,
                "(w6) flash q-seq over model vs plain on the shard"),
            w_close(torch, got.to_local(), whole[:b, :c], tol,
                    "(w6) flash q-seq over model vs the one-device call"))
        del got, whole, q, k, v
        # rmsnorm, rows over "data"
        x, scale = rand(W6_RMS), rand(W6_RMS[-1:], torch.float32)
        got = ops.rmsnorm(lay(x, (dp,), mesh), lay(scale, (None,), mesh))
        tol = RMS_TOL["bfloat16"]
        rec["rmsnorm"] = max(
            w_close(torch, got.to_local(), _rmsnorm_math(x[:b], scale, 1e-6),
                    tol, "(w6) rmsnorm rows over data vs plain on the shard"),
            w_close(torch, got.to_local(), ops.rmsnorm(x, scale)[:b], tol,
                    "(w6) rmsnorm rows over data vs the one-device call"))
        del got, x
        # the factorized linear: rank 0 holds batch row 0 and each of the
        # p blocks' first O/16 output columns
        B, S, d_in, d_out, p, R = W6_COMP
        I, O = d_in // p, d_out // p
        b, o = B // 16, O // 16
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            x = rand((B, S, d_in), dtype)
            basis = (rand((I, R), torch.float32) / I ** 0.5).to(dtype)
            coeff = (rand((p * p, R, O), torch.float32) / R ** 0.5).to(dtype)
            got = ops.factorized_shards(
                lay(x, (dp,), mesh), lay(basis, (None,), mesh),
                lay(coeff, (None, None, "model"), mesh), p).to_local()
            plain = module.linear({"basis": basis, "coeff": coeff[..., :o]},
                                  x[:b]).reshape(b, S, p, o)
            whole = module.linear({"basis": basis, "coeff": coeff},
                                  x).reshape(B, S, p, O)[:b, ..., :o]
            tol = W6_COMP_TOL[name]
            rec[f"factorized_{name}"] = max(
                w_close(torch, got, plain, tol, f"(w6) factorized linear "
                        f"{name}, O over model, vs the einsum on the shard"),
                w_close(torch, got, whole, tol, f"(w6) factorized linear "
                        f"{name}, O over model, vs the one-device call"))
            del x, basis, coeff, got, plain, whole
    return rec


def dryrun_worker(argv) -> int:
    """``chip_smoke.py dryrun OUT_JSON``, path (w)'s process: the checks
    of :func:`check_dryrun`, then each pair of ``W_PAIRS`` as rank 0 of
    its fake world (``launch.dryrun.lower_pair``), launch counts set to 0
    before the pairs and read after each; writes the records to
    ``OUT_JSON``.  It imports nothing but torch and ``repro_torch``."""
    import torch

    (out_json,) = argv
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as rt
    from repro_torch.launch import dryrun

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt.build()  # built by the parent: loads them
    out = {"checks": check_dryrun(torch), "pairs": {}}
    torch.cuda.empty_cache()
    total = {k: 0 for k in rt.KERNELS}
    for label, (arch, shape, multi_pod, flags) in W_PAIRS.items():
        rt.reset_launches()
        t0 = time.perf_counter()
        rec = dryrun.lower_pair(arch, shape, multi_pod, **flags)
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = {k: n for k, n in rt.LAUNCHES.items() if n}
        for k, n in rt.LAUNCHES.items():
            total[k] += n
        out["pairs"][label] = rec
        print(f"  ({label}) {json.dumps(w_summary(rec))}", flush=True)
        torch.cuda.empty_cache()
    out["launches"] = total
    Path(out_json).write_text(json.dumps(out))
    return 0


def w_summary(rec: dict) -> dict:
    """A pair's record in the reference's field names, and its seconds."""
    loop = rec["loop_scaled"]
    return {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "devices": rec["devices"], "kind": rec["kind"],
            "params": rec["params"],
            "argument_bytes": rec["memory"]["argument_bytes"],
            "peak_bytes": rec["memory"]["peak_bytes"],
            "dot_flops": loop["dot_flops"], "flops": rec["cost"]["flops"],
            "traffic_bytes": loop["traffic_bytes"],
            "collective_bytes": loop["collective_bytes"],
            "collective_counts": loop["collective_counts"],
            "kernel_flops": loop["kernel_flops"],
            "launches": rec["launches"], "step_s": rec["step_s"],
            "setup_s": rec["setup_s"], "seconds": rec["seconds"]}


def dryrun_path(torch) -> tuple:
    """Path (w): the production meshes in a new process
    (:func:`dryrun_worker`), so that its fake world never meets the
    earlier paths; each pair's argument bytes must be the specs'
    reckoning, its peak below the card's memory, its dot FLOPs above 0,
    and its kernels launched.  Returns (launch counts, records)."""
    import gc
    import tempfile

    card = card_line()
    # the child needs most of the card (kimi-k2's 61 GiB of shards): hand
    # back what this process's allocator holds
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (w) this process holds {torch.cuda.memory_allocated()} B "
          f"({torch.cuda.memory_reserved()} B reserved) as it starts")
    with tempfile.TemporaryDirectory() as tmp:
        out_json = Path(tmp) / "w.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "dryrun",
             str(out_json)], capture_output=True, text=True,
            timeout=W_TIMEOUT)
        wall = time.perf_counter() - t0
        print(proc.stdout, end="")
        check(proc.returncode == 0,
              f"(w) the dry-run process failed:\n{proc.stderr[-6000:]}")
        res = json.loads(out_json.read_text())
    memory = torch.cuda.get_device_properties(0).total_memory
    recs = {"checks": res["checks"], "process_s": wall, "card": card}
    for label, rec in res["pairs"].items():
        m = rec["memory"]
        check(m["argument_bytes"] == m["reckoned_argument_bytes"],
              f"({label}) argument bytes {m['argument_bytes']} are not the "
              f"specs' {m['reckoned_argument_bytes']}")
        check(0 < m["peak_bytes"] < memory,
              f"({label}) peak {m['peak_bytes']} not below {memory}")
        check(rec["loop_scaled"]["dot_flops"] > 0, f"({label}) no dot FLOPs")
        for k in W_KERNELS[label]:
            check(rec["launches"].get(k, 0) > 0,
                  f"({label}) never launched {k}")
        recs[label] = w_summary(rec)
    print(f"  (w) {wall:.1f} s in its process [{card}]")
    for k in W_EXPECT:
        check(res["launches"][k] > 0, f"(w) never launched {k}")
    return res["launches"], recs


def main_path(torch, rt):
    from repro_torch.kernels import KERNELS, LAUNCHES, reset_launches

    print(f"phase 3: main paths, {ROUNDS} rounds each, 4 clients per round; "
          "host merge on (a)-(e), FLConfig's default on (h), (i)")
    launches = {k: 0 for k in KERNELS}
    by_path = {}
    for label, (scheme, knobs, expect) in PATHS.items():
        _, by_path[label] = train_path(torch, label, "image", scheme, knobs,
                                       expect)

    # (e) the composed transformer: heroes and fedavg train, then the
    # heroes weights serve
    e_counts = {k: 0 for k in KERNELS}
    runners = {}
    for scheme, knobs in TEXT_RUNS.items():
        runners[scheme], counts = train_path(torch, f"e {scheme}", "text",
                                             scheme, knobs, set())
        for k, n in counts.items():
            e_counts[k] += n
    heroes = runners["heroes"]
    reset_launches()
    serve_path(torch, heroes.model, heroes.params)
    serve_counts = dict(LAUNCHES)
    print(f"      serve launches {serve_counts}")
    for k, n in serve_counts.items():
        e_counts[k] += n
    for k in TEXT_EXPECT:
        check(e_counts[k] > 0, f"(e) never launched {k}")
    by_path["e"] = e_counts

    # (f) the kernels.ops entry point
    reset_launches()
    ops_path(torch)
    by_path["f"] = dict(LAUNCHES)
    print(f"  (f) kernels.ops attention: launches {by_path['f']}")
    check(by_path["f"]["flash_attention"] > 0,
          "(f) never launched flash_attention")

    # (g) the zoo's hybrid serving path: zamba2-2.7b prefill + serve
    print("  (g) zamba2-2.7b: prefill and launch/serve.py's loop")
    by_path["g"], zoo_stats = zoo_path(torch)
    zoo_stats["grad"] = zoo_grad(torch)

    # (p) gemma-2b, the serving launcher's default, at full size: serving,
    # the sliding window, the int8 cache and training; (q) the other dense
    # archs' serving
    print(f"  (p) {DENSE_DEFAULT}: prefill, window, int8 cache, training, "
          "launch/serve.py with no arguments")
    by_path["p"], p_stats = dense_default_path(torch)
    print("  (q) " + ", ".join(f"{a}" + (f" ({d} layers)" if d else "")
                               for a, d in DENSE_Q)
          + ": prefill and launch/serve.py's loop")
    by_path["q"], q_stats = dense_q_path(torch)
    zoo_stats["dense"] = {"p": p_stats, "q": q_stats}

    # (r) the MoE family, (s) xLSTM, (t) the VLM's M-RoPE
    print(f"  (r) {MOE_DEFAULT}, {KIMI} ({K_DEPTH} layers): prefill and "
          f"launch/serve.py's loop; {MOE_DEFAULT}'s training at "
          f"{R_TRAIN_DEPTH} layers")
    by_path["r"], r_stats = moe_path(torch)
    print(f"  (s) {XLSTM_ARCH}: prefill, launch/serve.py's loop, training")
    by_path["s"], s_stats = xlstm_path(torch)
    print(f"  (t) {VLM_ARCH}: prefill with M-RoPE positions, "
          "launch/serve.py's loop")
    by_path["t"], t_stats = vlm_path(torch)
    print(f"  (u) {AUDIO_ARCH}: prefill over {AUDIO_FRAMES} frames a row, "
          "the step check, launch/serve.py's loop, training, compose-then-"
          "matmul")
    by_path["u"], u_stats = audio_path(torch)
    zoo_stats["families"] = {"r": r_stats, "s": s_stats, "t": t_stats,
                             "u": u_stats}

    # (h) the scheme comparison under FLConfig's defaults, (i) semi-async
    # and sample weights
    counts, scheme_recs = schemes_path(torch)
    by_path.update(counts)

    # (j) the cohort trainer
    print(f"  (j) the cohort trainer, {ROUNDS} rounds each, beside the "
          "sequential trainer")
    by_path["j"], cohort_recs = cohort_path(torch)
    scheme_recs["j"] = cohort_recs

    # (k) the residual net on cifar10, (l) the RNN on shakespeare
    print(f"  (k) resnet on cifar10, (l) rnn on shakespeare, {ROUNDS} rounds "
          "each, sequential, then cohort beside it")
    counts, slice_recs = slice_path(torch)
    by_path.update(counts)
    scheme_recs.update(slice_recs)

    # (m) a virtual population of a million, checkpointed and resumed;
    # (n) the dataset smoke
    print(f"  (m) heroes over {M_POPULATION} virtual clients, "
          f"{M_ROUNDS} rounds, checkpointed and resumed in a new process")
    by_path["m"], scheme_recs["m"] = population_path(torch)
    print("  (n) the dataset smoke, one cohort round per loader")
    by_path["n"], scheme_recs["n"] = smoke_path(torch)
    # (o) telemetry on the card
    print(f"  (o) telemetry, {ROUNDS} rounds each, jsonl, beside the runs "
          "with it off")
    by_path["o"], scheme_recs["o"] = telemetry_path(torch)
    # (v) step 9's multi-device part on logical shards of the card
    print(f"  (v) the merge, the cohort trainer and the server state over "
          f"logical shards of the card, and {V_MOE_ARCH}'s expert-parallel "
          "MoE layer")
    by_path["v"], scheme_recs["v"] = mesh_path(torch)
    # (w) the production meshes, rank 0 of a fake world, in a new process
    print("  (w) the production meshes as rank 0 of 256 and 512: "
          + ", ".join(f"({k}) {a} {s} {'2x16x16' if mp else '16x16'}"
                      + "".join(f" {f}" for f in fl)
                      for k, (a, s, mp, fl) in W_PAIRS.items()))
    by_path["w"], scheme_recs["w"] = dryrun_path(torch)

    for counts in by_path.values():
        for k, n in counts.items():
            launches[k] += n
    for k in KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the main path")
    return launches, by_path, zoo_stats, scheme_recs


def trace_round(torch, label: str = "c", trainer: str = "sequential",
                per_round: int = 4) -> None:
    """Phase 4: one round of path (c)'s run (a fresh runner, so round 1
    at τ=10, with libraries already warm) under ``torch.profiler``, with
    ``trainer`` and ``per_round`` clients a round: the round's wall time,
    the device's busy time (sum of kernel self times), their ratio, and
    the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl import FLConfig, build_image_setup, build_runner

    scheme, knobs, _ = PATHS["c"]
    model, px, py, tb = build_image_setup(num_clients=10, device=DEVICE)
    cfg = FLConfig(num_clients=10, clients_per_round=per_round,
                   eval_every=1, trainer=trainer, **knobs)
    runner = build_runner(scheme, model, px, py, tb, cfg=cfg, device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels and memcpys only: the ops that launched them carry the same
    # device time again
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    launches = sum(e.count for e in device)
    print(f"phase 4: traced round 1 of ({label}), {trainer} trainer, "
          f"{per_round} clients: wall {wall:.4f} s, device "
          f"busy {busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall:.2f}% of "
          f"the wall), {launches} device kernels")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["resume"]:  # path (m)'s new process
        return resume_worker(sys.argv[2:])
    if sys.argv[1:2] == ["dryrun"]:  # path (w)'s new process
        return dryrun_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import kernels as rt
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 1

    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    secs = rt.build()
    print(f"phase 1: built {sorted(secs)} in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(per source {json.dumps({k: round(v, 2) for k, v in secs.items()})})")
    sass_counts(rt)

    records = check_kernels(torch)
    attention = check_attention(torch)
    zoo = records["compose"]["zoo"] = attention.pop("compose_zoo")
    records["compose"]["max_abs_err"] = max(
        records["compose"]["max_abs_err"], zoo["max_abs_err"])
    records.update(attention)
    records.update(check_ssd_rmsnorm(torch))
    launches, by_path, zoo_stats, scheme_recs = main_path(torch, rt)
    print(f"paths (g), (p)-(u) {json.dumps(zoo_stats)}")
    print(f"paths (h)-(o) {json.dumps(scheme_recs)}")
    trace_round(torch)
    trace_round(torch, "j", trainer="cohort", per_round=10)
    print(f"calibration {json.dumps(calibration_record(torch))}")

    kernels = []
    for name in rt.KERNELS:
        source, replaces = KERNEL_META[name]
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "call_ms": rec["call_ms"], "plain_call_ms": rec["plain_call_ms"],
            "shape": rec["shape"],
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
        })
        for extra in ("two_call_ms", "more_shapes", "at_scale", "path_g",
                      "ops_model_layout", "decode", "gemma",
                      "launch_floor_ms", "encoder", "cross_prefill",
                      "cross_decode", "zoo",
                      "no_grad", "cohort"):
            if extra in rec:
                kernels[-1][extra] = rec[extra]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
