#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (odh_kubeflow_tpu_torch) on one
NVIDIA Hopper card: the quickest proof that the port builds, is right,
serves and trains on the GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure exits non-zero; no phase's failure is caught):
1. device: name, capability, power limit;
2. build: every kernel compiled from the sources in this checkout; the
   forward and backward libraries must each hold HGMMA (wgmma)
   instructions, and their C entries must choose the kernels by (dtype, d)
   as attention._fwd_kernel_for and attention._bwd_kernel_for say;
3. the forward kernels against their plain PyTorch version, at the shapes
   the serving and training paths give them and at others, bf16 and f32,
   with and without lse, each case naming the kernel and q tile it ran; the
   tensor-core kernel also at the tile edges (sq = sk in 63, 64, 65, 127,
   129, 2049; d 128 and 64; causal and full; 64- and 128-row q tiles;
   strided views; GQA 16/4 and 8/1) and at sq != sk;
3b. the backward kernels (dq, dk/dv; the tensor-core pair and the scalar
   pair) against their plain versions, at the training shape and others,
   each case naming the kernels it ran; the tensor-core pair also at the
   tile edges (sq = sk in 63, 64, 65, 127, 129, 2049; d 128 and 64; causal
   and full; GQA 16/4 on strided fused-qkv views and 8/1; sq != sk full);
   then through autograd with an lse cotangent;
4. timing (device time from CUDA-graph replays between CUDA events, median
   of 25): kernel, plain version, and the library SDPA as a yardstick only,
   beside the card's bound, with TFLOP/s, the share of the bound and the
   ratio to SDPA; and each call's time launched from Python; the
   tensor-core forward at the serving and 4x2048 shapes, the scalar forward
   in f32 at the serving shape; at the training shape, the forward with
   lse, dq and dk/dv (SDPA's backward, dq+dk+dv in one autograd call, is
   the pair's yardstick); the scalar dq and dk/dv at the f32 gradient
   check's shape;
5. the serving path at the full width of the repo's flagship model
   (vocab 32768, d_model 1024, 8 layers, 8 heads x 128, d_ff 4096, bf16;
   random weights from a seed): a ServingEngine behind ServingHTTPServer
   answers 8 concurrent POST /generate requests (prompt 128, max_new
   16..64); launch counts are zeroed just before and read just after: 8
   tensor-core forward launches per request, no scalar one; then an
   admission step and a burst step timed, and profiled for device time by
   kernel; then the demo model from build_engine_from_env({}) (f32, d 16:
   the scalar forward kernel's path, counted the same way), its f32 greedy
   tokens held against generate()'s;
6. the training path: a gradient check on the card (2-layer f32 model,
   loss and gradients through the scalar kernels against autograd through
   the reference attention), then make_train_step on the full-width bf16
   model (the bench.py train-step config, remat_policy "flash", batch 8 x
   2048): 1 warm-up and 5 timed steps with launch counts zeroed just before
   and read just after (8 tensor-core forward, 8 dq and 8 dk/dv launches per
   step, no scalar one), one step with remat_policy "" (twice the forward
   launches), host syncs in a step, and one profiled step.

The line before the last is a JSON object describing every kernel; the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

# published dense bf16 tensor-core FLOP/s, HBM bytes/s and f32 FLOP/s
# outside the tensor cores (NVIDIA data sheets), by a part of the name torch
# gives the card: the bound each kernel is held against, at the peak for the
# type its operations run in
PEAKS = {
    "H100 80GB HBM3": (989e12, 3.35e12, 67e12),  # H100 SXM
    "H100 PCIe": (756e12, 2.0e12, 51e12),
    "H200": (989e12, 4.8e12, 67e12),
}
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}
LSE_TOLERANCE = 1e-3
# gradients: max abs error relative to the plain result's max |grad|. bf16:
# about two bf16 ulps at the largest gradient (2**-8 relative is one); f32:
# summation order only (<= 2.4e-7 measured on the card)
BWD_TOLERANCE = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
MAIN_SHAPE = (1, 128, 8, 8, 128)  # one full-width prefill: b, s, h, hk, d
TIMING_SHAPE = (4, 2048, 8, 8, 128)
TRAIN_SHAPE = (8, 2048, 8, 8, 128)  # one layer's attention in the train step
GRAD_CHECK_SHAPE = (1, 512, 8, 8, 128)  # one layer's attention in phase 6's f32 gradient check
TENSOR_CORE_BWD = ("flash_bwd_dq", "flash_bwd_dkv")
SCALAR_BWD = ("flash_bwd_dq_scalar", "flash_bwd_dkv_scalar")
TRAIN_STEPS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def inputs(b, sq, sk, h, hk, d, dtype, seed, strided=False):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if strided:  # q/k/v as the model's views of one fused qkv projection
        qkv = rnd(b, sq, h + 2 * hk, d)
        q, k, v = qkv.split([h, hk, hk], dim=2)
        return q, k, v
    return rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d)


def work(b, sq, sk, h, hk, d, dtype, causal, with_lse):
    """(flops, bytes) the call needs: 4*d flops per visible (q, k) pair per
    head; q, k, v read once and out (and lse) written once."""
    if causal:
        pairs = sum(min(sk, i + 1) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4 * b * h * d * pairs
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * b * sq * h * d + 2 * b * sk * hk * d)
    if with_lse:
        nbytes += 4 * b * h * sq
    return flops, nbytes


def bwd_work(kind, b, sq, sk, h, hk, d, dtype, causal):
    """(flops, bytes) of one backward kernel: 6*d flops per visible pair
    and head for dq (three products), 8*d for dk/dv (four); q, k, v, dO,
    lse and delta read once, the outputs written once."""
    pairs = sum(min(sk, i + 1) for i in range(sq)) if causal else sq * sk
    flops = (6 if kind == "dq" else 8) * b * h * d * pairs
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * b * sq * h * d + 2 * b * sk * hk * d) + 2 * 4 * b * h * sq
    nbytes += item * (b * sq * h * d if kind == "dq" else 2 * b * sk * hk * d)
    return flops, nbytes


def count_sass(path, opcode):
    """How many instructions of `opcode` the library's SASS holds."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def tile_edge_cases(sms):
    """bf16 cases for the tensor-core kernel at its tile edges: sq = sk at
    each length, d 128 and 64, causal and full, each run once with 128-row
    q tiles (a "wide" batch whose grid of 128-row tiles covers the card's
    `sms` SMs, GQA 16/4) and once with 64-row tiles (one sequence, GQA 8/1
    or 4/1); strided fused-qkv views on the causal cases, lse on half; then
    sq != sk full attention at both widths (contiguous: a fused view has
    one length)."""
    cases = []
    for d in (128, 64):
        for s in (63, 64, 65, 127, 129, 2049):
            blocks = -(-s // 128)
            wide_b = -(-sms // (blocks * 16))
            narrow_h = 8 if blocks * 8 < sms else 4
            for causal in (True, False):
                tag = f"d{d} s{s} {'causal' if causal else 'full'}"
                cases.append((f"edge {tag} wide", wide_b, s, s, 16, 4, d, torch.bfloat16, causal,
                              causal, causal))
                cases.append((f"edge {tag} narrow", 1, s, s, narrow_h, 1, d, torch.bfloat16, causal,
                              not causal, causal))
        cases.append((f"sq!=sk full d{d} wide", 4, 300, 700, 16, 4, d, torch.bfloat16, False, True,
                       False))
        cases.append((f"sq!=sk full d{d} narrow", 1, 129, 63, 8, 1, d, torch.bfloat16, False, True,
                       False))
    return cases


def bwd_tile_edge_cases():
    """bf16 cases for the tensor-core backward pair at its tile edges (64-row
    warpgroup and streamed tiles, 128-row blocks): sq = sk at each length, d
    128 and 64, causal and full, once as GQA 16/4 on strided fused-qkv views
    and once as GQA 8/1 on contiguous tensors; then sq != sk full attention
    at both widths (contiguous: a fused view has one length)."""
    cases = []
    for d in (128, 64):
        for s in (63, 64, 65, 127, 129, 2049):
            for causal in (True, False):
                tag = f"d{d} s{s} {'causal' if causal else 'full'}"
                cases.append((f"bwd edge {tag} gqa 16/4 strided", 2, s, s, 16, 4, d, torch.bfloat16,
                              causal, True))
                cases.append((f"bwd edge {tag} gqa 8/1", 1, s, s, 8, 1, d, torch.bfloat16, causal,
                              False))
        cases.append((f"bwd sq!=sk full d{d} gqa 16/4", 2, 300, 700, 16, 4, d, torch.bfloat16, False,
                      False))
        cases.append((f"bwd sq!=sk full d{d} gqa 8/1", 1, 129, 63, 8, 1, d, torch.bfloat16, False,
                      False))
    return cases


def card_peaks(kind):
    for name, peaks in PEAKS.items():
        if name in kind:
            return peaks
    fail(f"no published peaks for {kind}: add its data-sheet rates to PEAKS")


def bound_ms(flops, nbytes, peaks, dtype=torch.bfloat16):
    t_ops = flops / peaks[0 if dtype == torch.bfloat16 else 2] * 1e3
    t_bytes = nbytes / peaks[1] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, runs=25, reps=10):
    """Device time of one call: `reps` calls captured in one CUDA graph,
    replayed `runs` times between CUDA events; the median per call. The
    graph takes the host's launch cost out, so a short kernel is timed, not
    the Python that launches it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = statistics.median(_event_ms(graph.replay) for _ in range(runs)) / reps
    del graph
    return ms


def eager_ms(fn, runs=25, reps=10):
    """Time of one call launched from Python, `reps` calls back to back
    between events: the host's launch cost included where it exceeds the
    device's work."""
    fn()
    torch.cuda.synchronize()

    def burst():
        for _ in range(reps):
            fn()

    return statistics.median(_event_ms(burst) for _ in range(runs)) / reps


def _matmul_type(name):
    """The operand type a cuBLAS kernel's name gives, where it gives one."""
    if name.startswith("nvjet_t") or any(w in name for w in ("bf16", "bfloat16")):
        return "bf16"
    if any(w in name for w in ("sgemm", "f32f32_f32f32", "nvjet_s", "float, float, float")):
        return "f32"
    return "type unnamed"


def device_split(prof, wall_ms):
    """Device time of a profiled run by kernel group, beside the host
    clock's time for the same work unprofiled (the profiler slows the
    host); the matmul group also by operand type, with its largest kernels
    by name."""
    from torch.autograd import DeviceType

    groups, matmuls, launches = {}, {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        ms = e.device_time_total / 1e3
        # each "_scalar" name before its prefix, so the groups stay apart
        flash = [k for k in ("flash_fwd_scalar", "flash_bwd_dq_scalar", "flash_bwd_dkv_scalar",
                             "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if k in name]
        if flash:
            group = flash[0]
        elif any(w in name for w in ("gemm", "gemv", "xmma", "cutlass", "splitk", "nvjet")):
            group = "matmul"
            n, t = matmuls.get(e.name, (0, 0.0))
            matmuls[e.name] = (n + 1, t + ms)
        elif "memcpy" in name or "memset" in name:
            group = "copy"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + ms
        launches += 1
    busy = sum(groups.values())
    if busy == 0:
        return "the profiler saw no device time: not measured"
    parts = ", ".join(f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    by_type = {}
    for name, (_, t) in matmuls.items():
        kind = _matmul_type(name.lower())
        by_type[kind] = by_type.get(kind, 0.0) + t
    top = sorted(matmuls.items(), key=lambda kv: -kv[1][1])[:6]
    split = ", ".join(f"{k} {t:.3f} ms" for k, t in sorted(by_type.items(), key=lambda kv: -kv[1]))
    largest = "; ".join(f"{t:.3f} ms in {n}x {name[:90]}" for name, (n, t) in top)
    return (f"{busy:.3f} ms busy in {launches} device ops, {busy / wall_ms:.1%} of the "
            f"unprofiled {wall_ms:.2f} ms ({parts})"
            + (f"\n    matmul by operand type: {split}\n    largest matmul kernels: {largest}"
               if matmuls else ""))


def _grad_err(got, want):
    """max |got - want| over max |want|, in f32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def check_backward(attention):
    """Phase 3b: each backward kernel against its plain version on the same
    inputs (lse from the forward kernel, delta = rowsum(dO * out)), each
    case naming the pair of kernels it launched (read from the launch
    counts), then autograd through the op with an lse cotangent against the
    plain versions. Returns each kernel's max abs error at its main-path
    shape (the training shape; the gradient check's for the scalar pair)."""
    cases = [
        # (label, b, sq, sk, h, hk, d, dtype, causal, strided)
        ("training shape", *TRAIN_SHAPE[:2], TRAIN_SHAPE[1], *TRAIN_SHAPE[2:], torch.bfloat16, True, True),
        ("1x128", 1, 128, 128, 8, 8, 128, torch.bfloat16, True, True),
        ("gqa 16/4", 2, 2048, 2048, 16, 4, 128, torch.bfloat16, True, False),
        ("ragged 200", 1, 200, 200, 8, 8, 128, torch.bfloat16, True, False),
        ("sq!=sk full", 2, 300, 700, 8, 4, 128, torch.bfloat16, False, False),
        ("f32 gradient-check shape", *GRAD_CHECK_SHAPE[:2], GRAD_CHECK_SHAPE[1], *GRAD_CHECK_SHAPE[2:],
         torch.float32, True, True),
        ("f32 d64 ragged gqa", 2, 333, 333, 8, 2, 64, torch.float32, True, False),
        ("f32 d32 sq!=sk full", 1, 100, 260, 4, 4, 32, torch.float32, False, False),
        ("f32 d16 gqa", 1, 37, 37, 4, 2, 16, torch.float32, True, True),
        ("bf16 d32 full", 1, 96, 96, 4, 4, 32, torch.bfloat16, False, False),
        *bwd_tile_edge_cases(),
    ]
    errors, main_err, ran = [], {}, set()
    for i, (label, b, sq, sk, h, hk, d, dtype, causal, strided) in enumerate(cases):
        q, k, v = inputs(b, sq, sk, h, hk, d, dtype, seed=200 + i, strided=strided)
        dout = inputs(b, sq, sq, h, h, d, dtype, seed=300 + i)[0]
        out, lse = attention.flash_attention(q, k, v, causal=causal, with_lse=True)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, dout, lse, delta, causal)
        before = dict(attention.launch_counts)
        got = (attention.flash_bwd_dq(*args), *attention.flash_bwd_dkv(*args))
        launched = tuple(n for n in attention.launch_counts if attention.launch_counts[n] != before[n])
        want = (attention.flash_bwd_dq_plain(*args), *attention.flash_bwd_dkv_plain(*args))
        torch.cuda.synchronize()
        errs = [_grad_err(g, w) for g, w in zip(got, want)]
        ok = (all(g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want))
              and all(torch.isfinite(g.float()).all().item() for g in got)
              and max(errs) <= BWD_TOLERANCE[dtype]
              and launched == attention._bwd_kernel_for(dtype, d))
        ran.update(launched)
        print(f"  {label} [{', '.join(launched)}]: dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} "
              f"of max |grad| (tol {BWD_TOLERANCE[dtype]:.0e})" + ("" if ok else "  <-- FAIL"), flush=True)
        if not ok:
            errors.append(label)
        if label in ("training shape", "f32 gradient-check shape"):
            abs_errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
            dq_name, dkv_name = attention._bwd_kernel_for(dtype, d)
            main_err.update({dq_name: abs_errs[0], dkv_name: max(abs_errs[1:])})
    if ran != set(TENSOR_CORE_BWD + SCALAR_BWD):
        errors.append(f"kernels run {sorted(ran)}")
    # through autograd: a loss reading out and lse, so g_lse enters as delta - g_lse
    b, s, h, hk, d = 2, 256, 8, 2, 128
    q, k, v = (t.requires_grad_() for t in inputs(b, s, s, h, hk, d, torch.bfloat16, seed=400))
    g_out = inputs(b, s, s, h, h, d, torch.bfloat16, seed=401)[0]
    g_lse = torch.randn(b, h, s, device="cuda", generator=torch.Generator(device="cuda").manual_seed(402))
    before = dict(attention.launch_counts)
    out, lse = attention.flash_attention(q, k, v, causal=True, with_lse=True)
    got = torch.autograd.grad((out, lse), (q, k, v), (g_out, g_lse))
    launched = {n: attention.launch_counts[n] - before[n] for n in before}
    delta = (g_out.float() * out.detach().float()).sum(-1).transpose(1, 2) - g_lse
    args = (q.detach(), k.detach(), v.detach(), g_out, lse.detach(), delta.contiguous(), True)
    want = (attention.flash_bwd_dq_plain(*args), *attention.flash_bwd_dkv_plain(*args))
    errs = [_grad_err(g, w) for g, w in zip(got, want)]
    ok = (max(errs) <= BWD_TOLERANCE[torch.bfloat16]
          and launched == {"flash_fwd": 1, "flash_fwd_scalar": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                           "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0})
    print(f"  autograd with g_lse (b{b} s{s} h{h} hk{hk} bf16): dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
          f"dv {errs[2]:.3e}; launches {launched}" + ("" if ok else "  <-- FAIL"), flush=True)
    if not ok:
        errors.append("autograd with g_lse")
    if errors:
        fail(f"the backward kernels disagree with their plain versions: {errors}")
    return main_err


def sdpa_backward_ms(qt, kt, vt, dout_t):
    """(backward ms, forward-under-grad ms) of SDPA on (b, h, s, d) inputs
    that require grad, by CUDA-graph replay: forward and backward captured
    together, less the forward under grad alone."""
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_bwd():
        return torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dout_t)

    fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), runs=10, reps=5)
    return time_ms(fwd_bwd, runs=10, reps=5) - fwd_ms, fwd_ms


def time_kernel_rows(rows, peaks, smi, dtype, shape):
    """Each row (kernel, plain, (flops, bytes), library ms, library name)
    timed by CUDA-graph replay beside its plain version, its bound at the
    peak for `dtype` and its library yardstick; printed and returned by
    name."""
    timings = {}
    for name, (kernel, plain, (flops, nbytes), library_ms, library) in rows.items():
        b_ms, b_by = bound_ms(flops, nbytes, peaks, dtype)
        t = {"ms": time_ms(kernel, runs=10, reps=5), "plain_ms": time_ms(plain, runs=10, reps=3),
             "library_ms": library_ms, "library": library, "bound_ms": b_ms, "bound_by": b_by,
             "flops": flops, "bytes": nbytes, "shape": shape}
        timings[name] = t
        print(f"  {name} {shape}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"{library} {library_ms:.4f} ms; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
              f"bound {b_ms:.4f} ms ({b_by}); kernel at {flops / (t['ms'] * 1e-3) / 1e12:.2f} "
              f"TFLOP/s, {b_ms / t['ms']:.3%} of bound, {t['ms'] / library_ms:.2f}x the "
              f"library's time on {smi}", flush=True)
    return timings


def time_scalar_bwd_kernels(attention, peaks, smi):
    """Phase 4 for the scalar backward pair at its main-path shape, phase
    6's f32 gradient check (one layer: b1 s512 h8 d128, causal), bound at
    the f32 peak outside the tensor cores; SDPA's f32 backward (dq+dk+dv in
    one autograd call, TF32 off) is the pair's yardstick."""
    b, s, h, hk, d = GRAD_CHECK_SHAPE
    q, k, v = inputs(b, s, s, h, hk, d, torch.float32, seed=510, strided=True)
    dout = inputs(b, s, s, h, h, d, torch.float32, seed=511)[0]
    out, lse = attention.flash_attention(q, k, v, causal=True, with_lse=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    sdpa_bwd = sdpa_backward_ms(qt, kt, vt, dout.transpose(1, 2).contiguous())[0]
    library = "SDPA f32 backward (its default backend), dq+dk+dv in one call"
    rows = {
        "flash_bwd_dq_scalar": (lambda: attention.flash_bwd_dq(*args),
                                lambda: attention.flash_bwd_dq_plain(*args),
                                bwd_work("dq", b, s, s, h, hk, d, torch.float32, True), sdpa_bwd,
                                library),
        "flash_bwd_dkv_scalar": (lambda: attention.flash_bwd_dkv(*args),
                                 lambda: attention.flash_bwd_dkv_plain(*args),
                                 bwd_work("dkv", b, s, s, h, hk, d, torch.float32, True), sdpa_bwd,
                                 library),
    }
    return time_kernel_rows(rows, peaks, smi, torch.float32, f"b{b} s{s} h{h} hk{hk} d{d} f32 causal")


def time_training_kernels(attention, peaks, smi):
    """Phase 4 at the training shape: the forward with lse, dq and dk/dv,
    each beside its plain version, its bound and a library yardstick (SDPA
    forward; for the pair, SDPA's backward, dq+dk+dv in one autograd call
    on the backend SDPA picks, timed by CUDA-graph replay as the kernels
    are: forward and backward captured together, less the forward under
    grad alone). Printed beside it: the same backward launched from Python,
    and aten's flash (FlashAttention-2) backward alone by graph replay."""
    b, s, h, hk, d = TRAIN_SHAPE
    q, k, v = inputs(b, s, s, h, hk, d, torch.bfloat16, seed=500, strided=True)
    dout = inputs(b, s, s, h, h, d, torch.bfloat16, seed=501)[0]
    out, lse = attention.flash_attention(q, k, v, causal=True, with_lse=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_dout = dout.transpose(1, 2).contiguous()
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), runs=10, reps=5)
    sdpa_bwd_ms, sdpa_fwd_grad_ms = sdpa_backward_ms(qt, kt, vt, sdpa_dout)
    sdpa_out = sdpa(qt, kt, vt, is_causal=True)
    sdpa_bwd_eager_ms = eager_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), sdpa_dout,
                                                             retain_graph=True), runs=10, reps=5)
    aten = torch.ops.aten
    with torch.no_grad():
        qd, kd, vd = qt.detach(), kt.detach(), vt.detach()
        fo, flse, cq, ck, mq, mk, seed, offset, _ = aten._scaled_dot_product_flash_attention(
            qd, kd, vd, 0.0, True)

        def fa2_bwd():
            return aten._scaled_dot_product_flash_attention_backward(
                sdpa_dout, qd, kd, vd, fo, flse, cq, ck, mq, mk, 0.0, True, seed, offset)

        fa2_bwd_ms = time_ms(fa2_bwd, runs=10, reps=5)
    print(f"  SDPA backward (dq+dk+dv) b{b} s{s} by CUDA-graph replay: {sdpa_bwd_ms:.4f} ms "
          f"(forward+backward less the forward under grad, {sdpa_fwd_grad_ms:.4f} ms); "
          f"launched from Python {sdpa_bwd_eager_ms:.4f} ms; aten flash (FA2) backward "
          f"{fa2_bwd_ms:.4f} ms", flush=True)
    shape = f"b{b} s{s} h{h} hk{hk} d{d} bf16 causal"
    rows = {
        "flash_fwd": (lambda: attention.flash_attention(q, k, v, causal=True, with_lse=True),
                      lambda: attention.flash_attention_plain(q, k, v, causal=True, with_lse=True),
                      work(b, s, s, h, hk, d, torch.bfloat16, True, True), sdpa_fwd_ms,
                      "SDPA forward (no lse)"),
        "flash_bwd_dq": (lambda: attention.flash_bwd_dq(*args),
                         lambda: attention.flash_bwd_dq_plain(*args),
                         bwd_work("dq", b, s, s, h, hk, d, torch.bfloat16, True), sdpa_bwd_ms,
                         "SDPA backward (its default backend), dq+dk+dv in one call"),
        "flash_bwd_dkv": (lambda: attention.flash_bwd_dkv(*args),
                          lambda: attention.flash_bwd_dkv_plain(*args),
                          bwd_work("dkv", b, s, s, h, hk, d, torch.bfloat16, True), sdpa_bwd_ms,
                          "SDPA backward (its default backend), dq+dk+dv in one call"),
    }
    timings = time_kernel_rows(rows, peaks, smi, torch.bfloat16, shape)
    pair = timings["flash_bwd_dq"]["ms"] + timings["flash_bwd_dkv"]["ms"]
    pair_bound = sum(bound_ms(timings[n]["flops"], timings[n]["bytes"], peaks)[0]
                     for n in TENSOR_CORE_BWD)
    print(f"  backward pair (dq + dk/dv) {shape}: {pair:.4f} ms, {pair_bound / pair:.3%} of the "
          f"pair's bound {pair_bound:.4f} ms, {pair / sdpa_bwd_ms:.2f}x SDPA's backward on {smi}",
          flush=True)
    return timings


def host_split_us(attention, q, k, v):
    """Host-clock cost in µs of one no-lse forward call on q/k/v (CUDA
    tensors), the mean of 2000 back-to-back calls after 50 warm-ups, split
    into the public function, the registered op alone, and the C entry
    alone (its tensor maps and the launch). Launched from Python, a short
    kernel's call costs its host path, not its device time."""
    b, sq, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib, entry = attention._entry("odh_flash_fwd")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            attention._DTYPE_CODES[q.dtype], b, sq, k.shape[1], h, k.shape[2], d,
            *(attention._strides(t) for t in (q, k, v)), 1, d**-0.5 * attention.LOG2E,
            torch.cuda.current_stream().cuda_stream)
    calls = {
        "public flash_attention": lambda: attention.flash_attention(q, k, v, causal=True),
        "registered op": lambda: torch.ops.odh_kubeflow_tpu_torch.flash_fwd(q, k, v, True, False),
        "C entry": lambda: entry(*args),
    }
    split = {}
    for name, fn in calls.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        split[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    return split


def count_sync_warnings(fn):
    """Runs fn under torch's CUDA sync debug mode "warn" and returns the
    number of host-device synchronisations it reported."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def train_phase(attention, peaks, smi):
    """Phase 6: the gradient check on the card, then the full-width train
    step. Returns the launch counts of the timed steps and the numbers
    printed."""
    from odh_kubeflow_tpu_torch.models import TransformerConfig, init_params, loss_fn, make_train_step
    from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map

    full = dict(vocab=32768, d_model=1024, n_heads=8, d_ff=4096, max_seq=2048)
    # gradient check: 2 layers in f32 (head_dim 128, seq 512), loss and
    # gradients through the kernels against autograd through mha_reference
    cfg32 = TransformerConfig(**full, n_layers=2, dtype=torch.float32, use_flash=True,
                              remat=True, remat_policy="flash")
    params = init_params(torch.Generator().manual_seed(1), cfg32, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg32.vocab, (1, 512)), device="cuda")
    results = []
    for cfg in (cfg32, TransformerConfig(**{**cfg32.__dict__, "use_flash": False, "remat": False})):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        before = dict(attention.launch_counts)
        loss = loss_fn(live, {"tokens": tokens}, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        launched = {n: attention.launch_counts[n] - before[n] for n in before}
        results.append((loss.detach(), grads, launched))
    (loss_k, grads_k, launched), (loss_r, grads_r, _) = results
    loss_err = abs((loss_k - loss_r) / loss_r).item()
    grad_err = max(_grad_err(g, w) for g, w in zip(grads_k, grads_r))
    print(f"  gradient check (2 layers f32, 1x512): loss {loss_k.item():.6f} vs reference "
          f"{loss_r.item():.6f} (rel err {loss_err:.3e}), grads max rel err {grad_err:.3e} "
          f"(tol 1e-4); kernel launches {launched}", flush=True)
    if not (loss_err <= 1e-4 and grad_err <= 1e-4):
        fail("loss or gradients through the kernels disagree with the reference attention")
    if min(launched[n] for n in ("flash_fwd_scalar",) + SCALAR_BWD) < cfg32.n_layers:
        fail(f"the gradient check did not run through the scalar kernels: {launched}")
    del params, grads_k, grads_r, results

    # the full-width train step: bench.py's train-step config
    cfg = TransformerConfig(**full, n_layers=8, dtype=torch.bfloat16, use_flash=True,
                            remat=True, remat_policy="flash")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    b, s = TRAIN_SHAPE[:2]
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (b, s)),
                                       device="cuda")}
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    params, state, first = step(params, state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [first]
    attention.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = dict(attention.launch_counts)
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).tolist()  # the one host copy of the losses
    tokens_per_s = b * s / (step_ms * 1e-3)
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * s  # bench.py's count
    mfu = flops_per_token * tokens_per_s / peaks[0]
    print(f"  {n_params / 1e6:.1f}M params, batch {b}x{s}, remat_policy flash: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} (warm-up first)", flush=True)
    print(f"  {step_ms:.2f} ms per step (CUDA events; host clock {host_ms:.2f} ms), "
          f"{tokens_per_s:.0f} tokens/s, model FLOPs {flops_per_token * b * s / 1e12:.2f} TFLOP "
          f"per step = {mfu:.2%} of the bf16 peak; peak memory {peak_gb:.2f} GB; launches in "
          f"{TRAIN_STEPS} steps {launches} on {smi}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train-step losses not finite and falling: {losses}")
    # every launch of the step runs a tensor-core kernel
    want = {"flash_fwd": cfg.n_layers, "flash_fwd_scalar": 0, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
    if {n: c / TRAIN_STEPS for n, c in launches.items()} != want:
        fail(f"launches per step {launches} over {TRAIN_STEPS} steps, want {want} per step")

    syncs = count_sync_warnings(lambda: step(params, state, batch))
    print(f"  host syncs inside one step (sync debug mode): {syncs} (target 0)", flush=True)

    attention.reset_launch_counts()
    step_none, _ = make_train_step(TransformerConfig(**{**cfg.__dict__, "remat_policy": ""}), opt)
    step_none(params, state, batch)
    torch.cuda.synchronize()
    if attention.launch_counts["flash_fwd"] != 2 * cfg.n_layers or attention.launch_counts["flash_fwd_scalar"]:
        fail(f"remat_policy '' launched {dict(attention.launch_counts)} in one step, want "
             f"flash_fwd {2 * cfg.n_layers} and flash_fwd_scalar 0")
    print(f"  one step with remat_policy '': launches {dict(attention.launch_counts)}", flush=True)

    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    print(f"  one step, device time: {device_split(prof, step_ms)}", flush=True)
    return launches, launched


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA card")
    try:
        from odh_kubeflow_tpu_torch.device import hopper_present
        from odh_kubeflow_tpu_torch.models import TransformerConfig, forward, generate, init_params
        from odh_kubeflow_tpu_torch.ops import _build, attention
        from odh_kubeflow_tpu_torch.serving.engine import ServingEngine
        from odh_kubeflow_tpu_torch.serving.server import ServingHTTPServer, build_engine_from_env
    except ImportError as e:
        fail(f"the port's package is not importable from here: {e}")
    if any(m == "jax" or m.startswith("jax.") or m == "odh_kubeflow_tpu"
           or m.startswith("odh_kubeflow_tpu.") for m in sys.modules):
        fail("the port pulled in jax or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device {kind} capability {cap} torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    if not hopper_present(0):
        fail(f"{kind} (capability {cap}) is not a Hopper card; the kernels are sm_90a")
    peaks = card_peaks(kind)

    phase("2 build")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, info in _build.build_info.items():
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "error", "warning", "Performance")):
                print(f"  {name}: {line.strip()}")
    for lib in ("flash_fwd", "flash_bwd"):
        hgmma = count_sass(_build.library_path(lib), "HGMMA")
        print(f"  {lib} library: {hgmma} HGMMA (wgmma) instructions in its SASS", flush=True)
        if hgmma == 0:
            fail(f"the {lib} library holds no HGMMA instructions: no tensor-core kernel was built")
    for dtype in (torch.float32, torch.bfloat16):
        for d in attention.HEAD_DIMS:
            built = attention.fwd_launch_plan(dtype, 1, 128, 8, d)[0]
            if built != attention._fwd_kernel_for(dtype, d):
                fail(f"{dtype} d{d}: the C entry launches the {built} kernel, "
                     f"attention._fwd_kernel_for says {attention._fwd_kernel_for(dtype, d)}")
            built = attention.bwd_kernels_built(dtype, d)
            if built != attention._bwd_kernel_for(dtype, d):
                fail(f"{dtype} d{d}: the C entry launches the {built} backward kernels, "
                     f"attention._bwd_kernel_for says {attention._bwd_kernel_for(dtype, d)}")
    print("  kernels by (dtype, d), C entries = Python mirrors: " + ", ".join(
        f"{DTYPE_NAMES[dt]} d{d} {attention._fwd_kernel_for(dt, d)} + "
        f"{'/'.join(attention._bwd_kernel_for(dt, d))}"
        for dt in (torch.float32, torch.bfloat16) for d in attention.HEAD_DIMS), flush=True)

    phase("3 flash_fwd kernels vs plain")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [
        # (label, b, sq, sk, h, hk, d, dtype, causal, with_lse, strided)
        ("main-path prefill", *MAIN_SHAPE[:2], 128, *MAIN_SHAPE[2:], torch.bfloat16, True, False, True),
        ("main-path prefill lse", 1, 128, 128, 8, 8, 128, torch.bfloat16, True, True, True),
        ("4x2048 causal", 4, 2048, 2048, 8, 8, 128, torch.bfloat16, True, False, False),
        ("4x2048 causal lse", 4, 2048, 2048, 8, 8, 128, torch.bfloat16, True, True, False),
        ("training shape 8x2048 lse", 8, 2048, 2048, 8, 8, 128, torch.bfloat16, True, True, True),
        ("4x2048 non-causal", 4, 2048, 2048, 8, 8, 128, torch.bfloat16, False, False, False),
        ("gqa 16/4", 2, 2048, 2048, 16, 4, 128, torch.bfloat16, True, True, False),
        ("ragged 200", 1, 200, 200, 8, 8, 128, torch.bfloat16, True, True, False),
        ("sq!=sk non-causal", 2, 300, 700, 8, 4, 128, torch.bfloat16, False, True, False),
        ("f32 main-path", 1, 128, 128, 8, 8, 128, torch.float32, True, True, True),
        ("f32 ragged gqa", 2, 333, 333, 8, 2, 64, torch.float32, True, True, False),
        ("f32 sq!=sk", 1, 100, 260, 4, 4, 32, torch.float32, False, True, False),
        ("f32 demo-model d16", 1, 37, 37, 4, 2, 16, torch.float32, True, False, True),
        ("bf16 d64 gqa", 2, 130, 130, 8, 2, 64, torch.bfloat16, True, True, False),
        ("bf16 d32 non-causal", 1, 96, 96, 4, 4, 32, torch.bfloat16, False, False, False),
        *tile_edge_cases(sms),
    ]
    errors, plans = [], set()
    main_err = train_fwd_err = f32_main_err = 0.0
    for i, (label, b, sq, sk, h, hk, d, dtype, causal, with_lse, strided) in enumerate(cases):
        q, k, v = inputs(b, sq, sk, h, hk, d, dtype, seed=i, strided=strided)
        kernel, tile_q = attention.fwd_launch_plan(dtype, b, sq, h, d)
        plans.add((kernel, tile_q))
        got = attention.flash_attention(q, k, v, causal=causal, with_lse=with_lse)
        ref = attention.flash_attention_plain(q, k, v, causal=causal, with_lse=with_lse)
        torch.cuda.synchronize()
        out, lse = got if with_lse else (got, None)
        ref_out, ref_lse = ref if with_lse else (ref, None)
        if out.shape != ref_out.shape or out.dtype != q.dtype:
            fail(f"{label}: out {tuple(out.shape)} {out.dtype}, want {tuple(ref_out.shape)} {q.dtype}")
        err = (out.float() - ref_out.float()).abs().max().item()
        ok = torch.isfinite(out.float()).all().item() and err <= TOLERANCE[dtype]
        msg = f"  {label} [{kernel}, {tile_q}-row q tiles]: out max_abs_err {err:.3e} (tol {TOLERANCE[dtype]:.0e})"
        if with_lse:
            lse_err = (lse - ref_lse).abs().max().item()
            ok = ok and lse_err <= LSE_TOLERANCE
            msg += f", lse {lse_err:.3e} (tol {LSE_TOLERANCE:.0e})"
        print(msg + ("" if ok else "  <-- FAIL"), flush=True)
        if not ok:
            errors.append(label)
        if label.startswith("main-path prefill"):
            main_err = max(main_err, err)
        if label.startswith("training shape"):
            train_fwd_err = err
        if label == "f32 main-path":
            f32_main_err = err
    if errors:
        fail(f"flash_fwd disagrees with its plain version: {errors}")
    if not {("flash_fwd", 64), ("flash_fwd", 128), ("flash_fwd_scalar", 64)} <= plans:
        fail(f"phase 3 did not run every forward kernel and q tile: {sorted(plans)}")

    phase("3b flash_bwd_dq / flash_bwd_dkv kernels vs plain")
    bwd_err = check_backward(attention)

    phase("4 timing")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for tag, (b, s, h, hk, d), dtype in (("main", MAIN_SHAPE, torch.bfloat16),
                                          ("large", TIMING_SHAPE, torch.bfloat16),
                                          ("scalar main", MAIN_SHAPE, torch.float32)):
        q, k, v = inputs(b, s, s, h, hk, d, dtype, seed=100)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops, nbytes = work(b, s, s, h, hk, d, dtype, True, False)
        b_ms, b_by = bound_ms(flops, nbytes, peaks, dtype)
        def kernel():
            return attention.flash_attention(q, k, v, causal=True)

        def library():
            return sdpa(qt, kt, vt, is_causal=True)

        t = {
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: attention.flash_attention_plain(q, k, v, causal=True)),
            "library_ms": time_ms(library),
            "eager_ms": eager_ms(kernel), "library_eager_ms": eager_ms(library),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
            "shape": f"b{b} s{s} h{h} hk{hk} d{d} {DTYPE_NAMES[dtype]} causal",
            "kernel": attention._fwd_kernel_for(dtype, d),
        }
        timings[tag] = t
        print(f"  {t['kernel']} kernel, {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms (device, CUDA graph); "
              f"launched from Python: kernel {t['eager_ms']:.4f} ms, sdpa "
              f"{t['library_eager_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
              f"bound {b_ms:.4f} ms ({b_by}); kernel at {flops / (t['ms'] * 1e-3) / 1e12:.2f} "
              f"TFLOP/s, {b_ms / t['ms']:.3%} of bound, {t['ms'] / t['library_ms']:.2f}x SDPA's "
              f"time on {smi}", flush=True)
    q, k, v = inputs(*MAIN_SHAPE[:2], MAIN_SHAPE[1], *MAIN_SHAPE[2:], torch.bfloat16, seed=101,
                     strided=True)
    split = host_split_us(attention, q, k, v)
    print("  tensor-core forward, serving shape, host clock per call: " + ", ".join(
        f"{name} {us:.1f} us" for name, us in split.items()), flush=True)
    train_timings = time_training_kernels(attention, peaks, smi)
    train_timings.update(time_scalar_bwd_kernels(attention, peaks, smi))

    phase("5 serving path, full width")
    cfg = TransformerConfig(
        vocab=32768, d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
        max_seq=2048, dtype=torch.bfloat16, use_flash=True, remat=False,
    )
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    n_params = sum(t.numel() for t in [params["embed"], params["unembed"], *params["layers"].values()])
    print(f"  init {n_params / 1e6:.1f}M params in {time.perf_counter() - t0:.1f} s")

    # the flash kernel against the reference attention through the whole
    # model, in f32 on the same weights
    params32 = {k: v.float() for k, v in params.items() if k != "layers"}
    params32["layers"] = {k: v.float() for k, v in params["layers"].items()}
    probe = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, 128)), device="cuda")
    cfg32 = TransformerConfig(**{**cfg.__dict__, "dtype": torch.float32})
    cfg32_ref = TransformerConfig(**{**cfg32.__dict__, "use_flash": False})
    logit_err = (forward(params32, probe, cfg32) - forward(params32, probe, cfg32_ref)).abs().max().item()
    print(f"  f32 forward logits, flash kernel vs reference attention: max_abs_err {logit_err:.3e} (tol 2e-3)")
    if not logit_err <= 2e-3:
        fail(f"forward through the kernel disagrees with the reference: {logit_err}")
    del params32

    engine = ServingEngine(params, cfg, max_slots=8, max_seq=512, decode_burst=8,
                           check_syncs=True, device="cuda")
    warm = engine.submit(list(range(1, 129)), max_new=9)  # first-use allocations and handles
    if not engine.run_until_idle(timeout=300) or warm.result != "ok":
        fail("warm-up request did not complete")
    server = ServingHTTPServer(engine, host="127.0.0.1", port=0)
    host, port = server.start()
    engine.start()
    rng = np.random.default_rng(0)
    max_news = [16, 64, 24, 48, 32, 56, 40, 16]
    prompts = [rng.integers(0, cfg.vocab, 128).tolist() for _ in max_news]
    replies = {}

    def post(i):
        body = json.dumps({"prompt": prompts[i], "max_new": max_news[i]}).encode()
        req = urllib.request.Request(f"http://{host}:{port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            replies[i] = (resp.status, json.loads(resp.read()))

    attention.reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = dict(attention.launch_counts)
    stats = engine.stats()
    server.stop()
    if any(th.is_alive() for th in threads) or len(replies) != len(prompts):
        fail(f"only {len(replies)} of {len(prompts)} requests came back")
    n_tokens = 0
    for i, (status, body) in sorted(replies.items()):
        toks = body.get("tokens", [])
        if status != 200 or len(toks) != max_news[i] or not all(0 <= t < cfg.vocab for t in toks):
            fail(f"request {i}: status {status}, {len(toks)} tokens, want {max_news[i]} in range")
        n_tokens += len(toks)
    ttfts = sorted(body["ttft_s"] for _, body in replies.values())
    print(f"  {len(replies)} requests, {n_tokens} tokens in {wall:.3f} s: "
          f"{n_tokens / wall:.1f} tokens/s over HTTP; TTFT median "
          f"{statistics.median(ttfts) * 1e3:.2f} ms, max {ttfts[-1] * 1e3:.2f} ms; "
          f"host_syncs_last_burst {stats['host_syncs_last_burst']}; launches {launches}",
          flush=True)
    if stats["host_syncs_last_burst"] != 1:
        fail(f"host_syncs_last_burst {stats['host_syncs_last_burst']}, want 1")
    # every forward launch of the serving path runs the tensor-core kernel
    want = cfg.n_layers * len(prompts)
    if launches["flash_fwd"] != want or launches["flash_fwd_scalar"]:
        fail(f"forward launches on the serving path {launches}, want flash_fwd {want} "
             "and flash_fwd_scalar 0")

    same = total = first_same = 0
    for i, (_, body) in sorted(replies.items()):
        ref = generate(params, [prompts[i]], cfg, max_news[i], max_seq=512, device="cuda")[0].tolist()
        same += sum(a == b for a, b in zip(body["tokens"], ref))
        total += len(ref)
        first_same += body["tokens"][0] == ref[0]
    print(f"  token agreement with generate(): {same}/{total} ({same / total:.3f}); "
          f"first tokens {first_same}/{len(replies)}")
    if first_same != len(replies):
        fail("the engine's first tokens (prefill logits) differ from generate()'s")

    # where the serving time goes: one step that admits all 8 prompts
    # (8 prefills) and runs a burst, then a burst alone; host clock around
    # each (a step ends in the engine's host copy), then the same two steps
    # again under torch.profiler for the device time by kernel
    walls = {}
    for profiled in (False, True):
        for p in prompts:
            engine.submit(p, max_new=1 + 2 * engine.decode_burst)
        for label in ("admit 8 + burst", "burst alone"):
            if profiled:
                with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
                ]) as prof:
                    engine.step()
                print(f"  {label}, device time: {device_split(prof, walls[label])}")
            else:
                t0 = time.perf_counter()
                engine.step()
                walls[label] = (time.perf_counter() - t0) * 1e3
                print(f"  {label}: {walls[label]:.2f} ms host clock; "
                      f"{walls[label] / engine.decode_burst:.3f} ms per burst step")
        if not engine.idle():
            fail("two steps did not finish requests of 1 + 2 bursts")

    demo = build_engine_from_env({}).start()
    handle = demo.submit([1, 2, 3, 4], max_new=8)
    ok = handle.wait(timeout=120) and handle.result == "ok" and len(handle.tokens) == 8
    demo.stop()
    print(f"  demo model (build_engine_from_env): {handle.result} {handle.tokens}")
    if not ok:
        fail("the demo engine did not serve its request")
    # f32 on the card: the engine's greedy tokens against generate()'s
    demo_prompts = [[1, 2, 3, 4], [9, 8, 7], [100, 200, 300, 400, 500], [42]]
    attention.reset_launch_counts()
    handles = [demo.submit(p, max_new=24) for p in demo_prompts]
    if not demo.run_until_idle(timeout=120):
        fail("the demo engine did not finish")
    demo_launches = dict(attention.launch_counts)
    print(f"  demo model (f32, d{demo.cfg.head_dim}): launches for "
          f"{len(demo_prompts)} requests {demo_launches}")
    if demo_launches["flash_fwd_scalar"] != demo.cfg.n_layers * len(demo_prompts):
        fail(f"the demo model's forward launches {demo_launches}, want flash_fwd_scalar "
             f"{demo.cfg.n_layers * len(demo_prompts)}")
    same = sum(
        h.tokens == generate(demo.params, [p], demo.cfg, 24, max_seq=demo.max_seq,
                             device="cuda")[0].tolist()
        for h, p in zip(handles, demo_prompts)
    )
    print(f"  demo model f32: engine tokens equal generate()'s for {same}/{len(handles)} requests")

    phase("6 training path, full width")
    train_launches, grad_check_launches = train_phase(attention, peaks, smi)

    def timing_keys(t):
        return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")}

    main, scalar = timings["main"], timings["scalar main"]
    src = "odh_kubeflow_tpu_torch/ops/csrc/"
    kernels = [{
        "name": "flash_fwd",
        "variant": "tensor cores (wgmma, TMA): bf16 at d 64 and 128",
        "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": "odh_kubeflow_tpu/ops/attention.py:176",
        # both main paths launch it: 8 per request served, 8 per train step
        "launches": launches["flash_fwd"] + train_launches["flash_fwd"],
        "launches_by_path": {"serve": launches["flash_fwd"], "train": train_launches["flash_fwd"]},
        "max_abs_err": main_err,
        **timing_keys(main),
        "eager_ms": main["eager_ms"],
        "train": {**timing_keys(train_timings["flash_fwd"]), "max_abs_err": train_fwd_err,
                  "library": train_timings["flash_fwd"]["library"]},
    }, {
        "name": "flash_fwd_scalar",
        "variant": "scalar f32 FMAs: f32 at every d, bf16 at d 16 and 32",
        "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": "odh_kubeflow_tpu/ops/attention.py:176",
        # the demo model's serving path (f32, d 16)
        "launches": demo_launches["flash_fwd_scalar"],
        "launches_by_path": {"serve demo model": demo_launches["flash_fwd_scalar"]},
        "max_abs_err": f32_main_err,
        **timing_keys(scalar),
        "eager_ms": scalar["eager_ms"],
    }]
    for name, fn, line, variant, launched, path in (
            ("flash_bwd_dq", "_flash_bwd_dq_kernel", 464, "tensor cores (wgmma, TMA): bf16 at d 64 and 128",
             train_launches, "train"),
            ("flash_bwd_dkv", "_flash_bwd_dkv_kernel", 505, "tensor cores (wgmma, TMA): bf16 at d 64 and 128",
             train_launches, "train"),
            # the f32 gradient check of phase 6 (2 layers)
            ("flash_bwd_dq_scalar", "_flash_bwd_dq_kernel", 464,
             "scalar f32 FMAs: f32 at every d, bf16 at d 16 and 32", grad_check_launches, "f32 gradient check"),
            ("flash_bwd_dkv_scalar", "_flash_bwd_dkv_kernel", 505,
             "scalar f32 FMAs: f32 at every d, bf16 at d 16 and 32", grad_check_launches, "f32 gradient check")):
        t = train_timings[name]
        kernels.append({
            "name": name,
            "variant": variant,
            "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": f"odh_kubeflow_tpu/ops/attention.py:{line} ({fn})",
            "launches": launched[name],
            "launches_by_path": {path: launched[name]},
            "max_abs_err": bwd_err[name],
            **timing_keys(t),
            "library": t["library"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
