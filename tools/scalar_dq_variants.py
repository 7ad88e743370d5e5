#!/usr/bin/env python3
"""Times the scalar dq kernel (odh_kubeflow_tpu_torch/ops/csrc/flash_bwd.cu,
flash_bwd_dq_scalar_kernel) against variants of its launch geometry on one
NVIDIA Hopper card, at phase 6's f32 gradient-check shape (b1 s512 h8 d128,
causal): the design as built, its cluster cap raised from 2 to 4 blocks,
and 32-key tiles with 8 lanes a row (4 x 4 scores a thread, 128 threads)
under either cap.

    python3 tools/scalar_dq_variants.py     # from the repository root

Each variant is flash_bwd.cu with its constants substituted, compiled into a
library of its own beside the built one (the variant sources are written
next to flash_bwd.cu and removed at exit). Every variant's dq is held
against flash_bwd_dq_plain at a few shapes (within 1e-5 of the largest f32
gradient, 1e-2 in bf16) before the variants are timed in turns, A B C D D C
B A, by CUDA-graph replay (chip_smoke.time_ms). Exits non-zero if a variant
fails to build or disagrees.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from odh_kubeflow_tpu_torch.ops import _build, attention  # noqa: E402

# library name -> (label, substitutions of flash_bwd.cu); the first is the
# built source itself
VARIANTS = {
    "flash_bwd": ("as built: 64-key tiles, 16 lanes, clusters of at most 2", []),
    "dq_max4": ("clusters of at most 4", [("DQ_MAX_SPLIT = 2;", "DQ_MAX_SPLIT = 4;")]),
    "dq_k32": ("32-key tiles, 8 lanes, at most 2",
               [("DQ_BK = 64;", "DQ_BK = 32;"), ("LANES = D == 16 ? 8 : 16;", "LANES = 8;")]),
    "dq_k32_max4": ("32-key tiles, 8 lanes, at most 4",
                    [("DQ_MAX_SPLIT = 2;", "DQ_MAX_SPLIT = 4;"), ("DQ_BK = 64;", "DQ_BK = 32;"),
                     ("LANES = D == 16 ? 8 : 16;", "LANES = 8;")]),
}
ENTRIES = ("odh_flash_bwd_dq", "odh_flash_bwd_dq_k_split")
CHECKS = [  # b, sq, sk, h, hk, d, dtype, causal, strided
    (*cs.GRAD_CHECK_SHAPE[:2], cs.GRAD_CHECK_SHAPE[1], *cs.GRAD_CHECK_SHAPE[2:], torch.float32, True, True),
    (1, 512, 512, 8, 8, 128, torch.float32, False, False),
    (2, 333, 333, 8, 2, 64, torch.float32, True, False),
    (1, 100, 260, 4, 4, 32, torch.float32, False, False),
    (1, 37, 37, 4, 2, 16, torch.float32, True, True),
    (1, 96, 96, 4, 4, 32, torch.bfloat16, False, False),
    (1, 129, 129, 4, 2, 16, torch.bfloat16, True, True),
    (3, 513, 513, 2, 1, 64, torch.float32, True, False),
    (1, 513, 513, 1, 1, 64, torch.float32, True, False),
    (4, 65, 65, 8, 2, 128, torch.float32, False, True),
]


def use(lib):
    """Point the dq wrapper and its split entry at one variant's library."""
    for entry in ENTRIES:
        attention._SIGNATURES[entry] = (lib, attention._SIGNATURES[entry][1])


def check(lib):
    """Worst dq error over its tolerance at CHECKS, or a failure."""
    use(lib)
    worst = 0.0
    for i, (b, sq, sk, h, hk, d, dtype, causal, strided) in enumerate(CHECKS):
        q, k, v = cs.inputs(b, sq, sk, h, hk, d, dtype, seed=700 + i, strided=strided)
        dout = cs.inputs(b, sq, sq, h, h, d, dtype, seed=800 + i)[0]
        out, lse = attention.flash_attention(q, k, v, causal=causal, with_lse=True)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, dout, lse, delta, causal)
        err = cs._grad_err(attention.flash_bwd_dq(*args), attention.flash_bwd_dq_plain(*args))
        if not err <= cs.BWD_TOLERANCE[dtype]:
            cs.fail(f"{lib}: dq at {(b, sq, sk, h, hk, d, dtype, causal)} off by {err:.3e}")
        worst = max(worst, err / cs.BWD_TOLERANCE[dtype])
    return worst


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    source = (_build.CSRC / "flash_bwd.cu").read_text()
    written = []
    try:
        for lib, (_, subs) in VARIANTS.items():
            if not subs:
                continue
            text = source
            for old, new in subs:
                if text.count(old) != 1:
                    cs.fail(f"{lib}: flash_bwd.cu holds {text.count(old)} of {old!r}, not 1")
                text = text.replace(old, new)
            path = _build.CSRC / f"_variant_{lib}.cu"
            path.write_text(text)
            written.append(path)
            _build.SOURCES[lib] = path.name
        _build.build_all(list(VARIANTS))
        for lib, (label, _) in VARIANTS.items():
            regs = [line for line in cs.ptxas_summary(_build.build_info[lib]["log"])
                    if "dq_scalar f32 d128: 64 rows" in line]
            print(f"{lib} ({label}): dq within {check(lib):.3e} of its tolerance at {len(CHECKS)} "
                  f"shapes; {'; '.join(regs)}", flush=True)

        b, s, h, hk, d = cs.GRAD_CHECK_SHAPE
        q, k, v = cs.inputs(b, s, s, h, hk, d, torch.float32, seed=510, strided=True)
        dout = cs.inputs(b, s, s, h, h, d, torch.float32, seed=511)[0]
        out, lse = attention.flash_attention(q, k, v, causal=True, with_lse=True)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, dout, lse, delta, True)
        flops, nbytes = cs.bwd_work("dq", b, s, s, h, hk, d, torch.float32, True)
        bound = cs.bound_ms(flops, nbytes, cs.card_peaks(torch.cuda.get_device_name(0)), torch.float32)[0]
        times = {lib: [] for lib in VARIANTS}
        for lib in list(VARIANTS) + list(VARIANTS)[::-1]:
            use(lib)
            times[lib].append(cs.time_ms(lambda: attention.flash_bwd_dq(*args)))
        shape = f"b{b} s{s} h{h} hk{hk} d{d} f32 causal"
        for lib, (label, _) in VARIANTS.items():
            use(lib)
            split = attention.scalar_splits(torch.float32, d, b, s, s, h, hk, True)[2]
            best = min(times[lib])
            print(f"{lib} ({label}) at {shape}, {split}-block clusters: "
                  f"{', '.join(f'{t:.4f}' for t in times[lib])} ms; {bound / best:.2%} of the "
                  f"{bound:.4f} ms bound, {flops / best / 1e9:.2f} TFLOP/s on {smi}", flush=True)
        use("flash_bwd")
    finally:
        for path in written:
            path.unlink(missing_ok=True)


if __name__ == "__main__":
    main()
