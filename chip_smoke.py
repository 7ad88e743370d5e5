#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (odh_kubeflow_tpu_torch) on one
NVIDIA Hopper card: the quickest proof that the port builds, is right and
serves on the GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure exits non-zero; no phase's failure is caught):
1. device: name, capability, power limit;
2. build: every kernel compiled from the sources in this checkout;
3. each kernel against its plain PyTorch version, at the shapes the serving
   path gives it and at larger ones, bf16 and f32, with and without lse;
4. timing (device time from CUDA-graph replays between CUDA events, median
   of 25): kernel, plain version, and the library SDPA as a yardstick only,
   beside the card's bound; and each call's time launched from Python;
5. the serving path at the full width of the repo's flagship model
   (vocab 32768, d_model 1024, 8 layers, 8 heads x 128, d_ff 4096, bf16;
   random weights from a seed): a ServingEngine behind ServingHTTPServer
   answers 8 concurrent POST /generate requests (prompt 128, max_new
   16..64); launch counts are zeroed just before and read just after;
   then an admission step and a burst step timed, and profiled for device
   time by kernel; then the demo model from build_engine_from_env({}),
   its f32 greedy tokens held against generate()'s.

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

import numpy as np
import torch

# published dense bf16 tensor-core FLOP/s and HBM bytes/s (NVIDIA data
# sheets), by a part of the name torch gives the card: the bound each kernel
# is held against
PEAKS = {
    "H100 80GB HBM3": (989e12, 3.35e12),  # H100 SXM
    "H100 PCIe": (756e12, 2.0e12),
    "H200": (989e12, 4.8e12),
}
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOLERANCE = 1e-3
MAIN_SHAPE = (1, 128, 8, 8, 128)  # one full-width prefill: b, s, h, hk, d
TIMING_SHAPE = (4, 2048, 8, 8, 128)


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


def card_peaks(kind):
    for name, peaks in PEAKS.items():
        if name in kind:
            return peaks
    fail(f"no published peaks for {kind}: add its data-sheet rates to PEAKS")


def bound_ms(flops, nbytes, peaks):
    t_ops = flops / peaks[0] * 1e3
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


def device_split(prof, wall_ms):
    """Device time of a profiled run by kernel group, beside the host
    clock's time for the same work unprofiled (the profiler slows the
    host)."""
    from torch.autograd import DeviceType

    groups, launches = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        if "flash_fwd" in name:
            group = "flash_fwd"
        elif any(w in name for w in ("gemm", "gemv", "xmma", "cutlass", "splitk", "nvjet")):
            group = "matmul"
        elif "memcpy" in name or "memset" in name:
            group = "copy"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + e.device_time_total / 1e3
        launches += 1
    busy = sum(groups.values())
    if busy == 0:
        return "the profiler saw no device time: not measured"
    parts = ", ".join(f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    return (f"{busy:.3f} ms busy in {launches} device ops, {busy / wall_ms:.1%} of the "
            f"unprofiled {wall_ms:.2f} ms ({parts})")


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
            if any(w in line for w in ("registers", "spill", "error", "warning")):
                print(f"  {name}: {line.strip()}")

    phase("3 flash_fwd kernel vs plain")
    cases = [
        # (label, b, sq, sk, h, hk, d, dtype, causal, with_lse, strided)
        ("main-path prefill", *MAIN_SHAPE[:2], 128, *MAIN_SHAPE[2:], torch.bfloat16, True, False, True),
        ("main-path prefill lse", 1, 128, 128, 8, 8, 128, torch.bfloat16, True, True, True),
        ("4x2048 causal", 4, 2048, 2048, 8, 8, 128, torch.bfloat16, True, False, False),
        ("4x2048 causal lse", 4, 2048, 2048, 8, 8, 128, torch.bfloat16, True, True, False),
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
    ]
    errors = []
    main_err = 0.0
    for i, (label, b, sq, sk, h, hk, d, dtype, causal, with_lse, strided) in enumerate(cases):
        q, k, v = inputs(b, sq, sk, h, hk, d, dtype, seed=i, strided=strided)
        got = attention.flash_attention(q, k, v, causal=causal, with_lse=with_lse)
        ref = attention.flash_attention_plain(q, k, v, causal=causal, with_lse=with_lse)
        torch.cuda.synchronize()
        out, lse = got if with_lse else (got, None)
        ref_out, ref_lse = ref if with_lse else (ref, None)
        if out.shape != ref_out.shape or out.dtype != q.dtype:
            fail(f"{label}: out {tuple(out.shape)} {out.dtype}, want {tuple(ref_out.shape)} {q.dtype}")
        err = (out.float() - ref_out.float()).abs().max().item()
        ok = torch.isfinite(out.float()).all().item() and err <= TOLERANCE[dtype]
        msg = f"  {label}: out max_abs_err {err:.3e} (tol {TOLERANCE[dtype]:.0e})"
        if with_lse:
            lse_err = (lse - ref_lse).abs().max().item()
            ok = ok and lse_err <= LSE_TOLERANCE
            msg += f", lse {lse_err:.3e} (tol {LSE_TOLERANCE:.0e})"
        print(msg + ("" if ok else "  <-- FAIL"), flush=True)
        if not ok:
            errors.append(label)
        if label.startswith("main-path prefill"):
            main_err = max(main_err, err)
    if errors:
        fail(f"flash_fwd disagrees with its plain version: {errors}")

    phase("4 timing")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for tag, (b, s, h, hk, d) in (("main", MAIN_SHAPE), ("large", TIMING_SHAPE)):
        q, k, v = inputs(b, s, s, h, hk, d, torch.bfloat16, seed=100)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops, nbytes = work(b, s, s, h, hk, d, torch.bfloat16, True, False)
        b_ms, b_by = bound_ms(flops, nbytes, peaks)
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
            "shape": f"b{b} s{s} h{h} hk{hk} d{d} bf16 causal",
        }
        timings[tag] = t
        print(f"  {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"sdpa {t['library_ms']:.4f} ms (device, CUDA graph); launched from "
              f"Python: kernel {t['eager_ms']:.4f} ms, sdpa {t['library_eager_ms']:.4f} ms; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, bound {b_ms:.4f} ms "
              f"({b_by}); kernel at {flops / (t['ms'] * 1e-3) / 1e12:.2f} TFLOP/s "
              f"({b_ms / t['ms']:.3%} of bound) on {smi}", flush=True)

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
    want = cfg.n_layers * len(prompts)
    if launches["flash_fwd"] != want:
        fail(f"flash_fwd launched {launches['flash_fwd']} times on the serving path, want {want}")

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
    handles = [demo.submit(p, max_new=24) for p in demo_prompts]
    if not demo.run_until_idle(timeout=120):
        fail("the demo engine did not finish")
    same = sum(
        h.tokens == generate(demo.params, [p], demo.cfg, 24, max_seq=demo.max_seq,
                             device="cuda")[0].tolist()
        for h, p in zip(handles, demo_prompts)
    )
    print(f"  demo model f32: engine tokens equal generate()'s for {same}/{len(handles)} requests")

    main = timings["main"]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "odh_kubeflow_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "odh_kubeflow_tpu/ops/attention.py:176",
        "launches": launches["flash_fwd"],
        "max_abs_err": main_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "eager_ms": main["eager_ms"],
        "shape": main["shape"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
