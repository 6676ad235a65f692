#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It

1. builds the four CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel), prints the build seconds and the card's name
   and power limit, and turns TF32 off for matmuls and convolutions;
2. holds every kernel against its plain PyTorch version on the card, at
   the CNN's shapes for widths p = 1, 2, 3 (all three composition modes,
   strides 1 and 2, compose with a client axis C = 4), forward and
   gradient through each autograd Function, and times kernel, plain
   version and, where one PyTorch call computes the same function, that
   call (the port never calls it);
3. drives the port's main path — ``run_scheme``-style runs of 3 rounds on
   ``build_image_setup(num_clients=10)``, 4 clients per round, host merge:
   (a) heroes/materialize, (b) heroes/rank_space, (c) heroes/auto with the
   calibration pinned, (d) fedavg — with the launch counts set to 0 just
   before each run and read just after, and checks each run against the
   same run on the CPU (the plain versions, which the CPU tests hold to
   the JAX package);
4. traces one round of (c) with ``torch.profiler`` (device busy share,
   top kernels);
5. prints the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result.  Without a CUDA device, or outside a checkout, it exits 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FFMA FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

DENSE_TOL = 2e-5  # compose / rank_apply / compose_apply, f32 FFMA sums
CONV_TOL = 2e-4   # conv_rank: k*k*I-term sums, as in the CPU tests
GRAD_TOL = 1e-4   # gradients: the backward is plain PyTorch on both sides
CONV_GRAD_TOL = 5e-4  # conv gradients sum over every output pixel

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
}


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def device_ms(torch, fn, reps: int = 100, replays: int = 5) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed and timed with CUDA events, so the host's launch cost
    is not in the number."""
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


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    """Least time for the work on an H100 at full power: the larger of
    bytes over the memory rate and f32 FLOPs over the FFMA peak, in ms."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def check_kernels(torch, rt):
    """Phase 2.  Returns the timing records of the four kernels."""
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

    # conv_rank: all modes x p x stride at the 8x8 input, and conv3's 4x4
    conv_cases = []
    for mode in modes:
        for p in (1, 2, 3):
            for stride in (1, 2):
                conv_cases.append((mode, p, stride, 8))
    conv_cases += [("square", p, 2, 4) for p in (1, 2, 3)]
    for mode, p, stride, hw in conv_cases:
        g = 1 if mode == "grow_out" else p
        I = 3 if mode == "grow_out" else 8
        m = p * p if mode == "square" else p
        x, v, u = rn(16, hw, hw, g * I, scale=1.0), rn(9, I, 8), rn(m, 8, 8)
        u2 = _u2_conv_layout(u, p, mode).contiguous()
        got = conv_rank_kernel(x, v, u2, p=p, mode=mode, stride=stride)
        maxerr["conv_rank"] = max(maxerr["conv_rank"], err(
            torch, got, _fused_math(x, v, u2, p, mode, stride), CONV_TOL,
            f"conv_rank {mode} p={p} s={stride} x{tuple(x.shape)}"))
        err(torch, got, ref.conv_rank_ref(x, v, u, p, mode, stride),
            CONV_TOL, f"conv_rank {mode} p={p} s={stride} vs compose+conv")

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
    f32 = 4
    timings = {}
    # compose: conv2's (9,8,8) x (9,8,8) -> (9,8,72)
    v, u = rn(9, 8, 8), rn(9, 8, 8)
    vf, uf = v.reshape(72, 8), u.permute(1, 0, 2).reshape(8, 72)
    timings["compose"] = dict(
        shape="basis (9,8,8) x coeff (9,8,8) -> (9,8,72)",
        fn=lambda: compose_kernel(v, u), plain=lambda: ref.compose_ref(v, u),
        library=lambda: torch.matmul(vf, uf),
        nbytes=f32 * (v.numel() + u.numel() + 9 * 8 * 72),
        flops=2 * 9 * 8 * 8 * 9 * 8)
    # conv_rank: conv2 square p=3, x (16,8,8,24) stride 2 -> (16,4,4,24)
    xc, vc, uc = rn(16, 8, 8, 24, scale=1.0), rn(9, 8, 8), rn(9, 8, 8)
    u2c = _u2_conv_layout(uc, 3, "square").contiguous()
    timings["conv_rank"] = dict(
        shape="conv2 square p=3: x (16,8,8,24) s=2 -> (16,4,4,24)",
        fn=lambda: conv_rank_kernel(xc, vc, u2c, p=3, mode="square",
                                    stride=2),
        plain=lambda: _fused_math(xc, vc, u2c, 3, "square", 2),
        library=None,
        nbytes=f32 * (xc.numel() + vc.numel() + u2c.numel() + 16 * 16 * 24),
        flops=2 * 16 * 16 * (3 * 9 * 8 * 8 + 24 * 24))
    # dense primitives: fc grow_in p=3, xg (16,3,8), v (8,8), u2 (24,10)
    xg, vd, ud = rn(16, 3, 8, scale=1.0), rn(8, 8), rn(3, 8, 10)
    u2d = _u2_layout(ud, 3, "grow_in").contiguous()
    u3d = u2d.reshape(3, 8, 10).contiguous()
    dense_bytes = f32 * (xg.numel() + vd.numel() + u2d.numel() + 16 * 10)
    timings["rank_apply"] = dict(
        shape="fc grow_in p=3: xg (16,3,8) v (8,8) u2 (24,10) -> (16,10)",
        fn=lambda: rank_apply_kernel(xg, vd, u2d),
        plain=lambda: _fwd_math(xg, vd, u2d),
        library=lambda: torch.einsum("mai,ir,ard->md", xg, vd, u3d),
        nbytes=dense_bytes, flops=2 * (16 * 3 * 8 * 8 + 16 * 24 * 10))
    timings["compose_apply"] = dict(
        shape="fc grow_in p=3: xg (16,3,8) v (8,8) u3 (3,8,10) -> (16,10)",
        fn=lambda: compose_apply_kernel(xg, vd, u3d),
        plain=lambda: _compose_apply_math(xg, vd, u3d),
        library=lambda: torch.einsum("mai,ir,ard->md", xg, vd, u3d),
        nbytes=dense_bytes, flops=2 * (3 * 8 * 8 * 10 + 16 * 3 * 8 * 10))
    records = {}
    for name, t in timings.items():
        rec = {"ms": device_ms(torch, t["fn"]),
               "plain_ms": device_ms(torch, t["plain"]),
               "library_ms": (device_ms(torch, t["library"])
                              if t["library"] else None),
               "call_ms": call_ms(torch, t["fn"]),
               "plain_call_ms": call_ms(torch, t["plain"])}
        rec["bound_ms"], rec["bound_by"] = bound(t["nbytes"], t["flops"])
        rec["shape"] = t["shape"]
        rec["max_abs_err"] = maxerr[name]
        records[name] = rec
        print(f"  {name}: kernel_ms {rec['ms']:.5f} plain_ms "
              f"{rec['plain_ms']:.5f} library_ms {rec['library_ms']} "
              f"bound_ms {rec['bound_ms']:.6f} ({rec['bound_by']}) "
              f"call_ms {rec['call_ms']:.5f} plain_call_ms "
              f"{rec['plain_call_ms']:.5f} [{t['shape']}]")
    return records


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

PATHS = {
    "a": ("heroes", dict(forward_impl="materialize"), {"compose"}),
    "b": ("heroes", dict(forward_impl="rank_space"),
          {"compose", "conv_rank", "rank_apply"}),
    "c": ("heroes", dict(forward_impl="auto", fused_compose_gain=0.5,
                         conv_rank_overhead=1.0),
          {"compose", "conv_rank", "compose_apply"}),
    "d": ("fedavg", dict(forward_impl="materialize"), set()),
}
ROUNDS = 3


def run_path(torch, label, device):
    from repro_torch.fl import (FLConfig, build_image_setup, build_runner,
                                summarize)

    scheme, knobs, _ = PATHS[label]
    model, px, py, tb = build_image_setup(num_clients=10, device=device)
    cfg = FLConfig(num_clients=10, clients_per_round=4, agg_backend="host",
                   eval_every=1, **knobs)
    runner = build_runner(scheme, model, px, py, tb, cfg=cfg, device=device)
    secs = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        runner.run_round()
        if device != "cpu":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return runner, secs, summarize(runner.history)


def main_path(torch, rt):
    from repro_torch.convert import to_numpy
    from repro_torch.core.estimator import tree_leaves
    from repro_torch.kernels import KERNELS, LAUNCHES, reset_launches

    import numpy as np

    print(f"phase 3: main path, {ROUNDS} rounds each, 10 clients, 4 per "
          "round, host merge")
    launches = {k: 0 for k in KERNELS}
    by_path = {}
    for label, (scheme, knobs, expect) in PATHS.items():
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        runner, secs, summ = run_path(torch, label, DEVICE)
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
        by_path[label] = counts
        for k, n in counts.items():
            launches[k] += n
        hist = runner.history
        accs = [h.accuracy for h in hist]
        loss = runner.bound_state.loss0
        print(f"  ({label}) {scheme} {knobs}: seconds per round "
              f"{[round(s, 4) for s in secs]} mean {sum(secs) / ROUNDS:.4f}; "
              f"peak memory above the run's start {peak} B")
        print(f"      summarize {json.dumps(summ)}")
        print(f"      accuracy per round {accs}; loss0 {loss}; "
              f"launches {counts}")
        check(all(a is not None and math.isfinite(a) for a in accs),
              f"({label}) non-finite accuracy")
        check(math.isfinite(loss), f"({label}) non-finite loss")
        check(all(bool(torch.isfinite(t).all())
                  for t in tree_leaves(runner.params)),
              f"({label}) non-finite params")
        for k in expect:
            check(counts[k] > 0, f"({label}) never launched {k}")

        # the same run on the CPU: plain versions, same data and weights
        cpu, _, _ = run_path(torch, label, "cpu")
        n_test = int(cpu.test_batch["labels"].shape[0])
        for a, b in zip(hist, cpu.history):
            check((a.traffic_bytes, a.makespan, a.mean_tau) ==
                  (b.traffic_bytes, b.makespan, b.mean_tau),
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
    for k in KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the main path")
    return launches, by_path


def trace_round(torch, label: str = "c") -> None:
    """Phase 4: one round of path ``label`` (a fresh runner, so round 1 at
    τ=10, with libraries already warm) under ``torch.profiler``: the
    round's wall time, the device's busy time (sum of kernel self times),
    their ratio, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl import FLConfig, build_image_setup, build_runner

    scheme, knobs, _ = PATHS[label]
    model, px, py, tb = build_image_setup(num_clients=10, device=DEVICE)
    cfg = FLConfig(num_clients=10, clients_per_round=4, agg_backend="host",
                   eval_every=1, **knobs)
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
    print(f"phase 4: traced round 1 of ({label}): wall {wall:.4f} s, device "
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

    records = check_kernels(torch, rt)
    launches, by_path = main_path(torch, rt)
    trace_round(torch)

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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
