"""Flash attention for the port: a hand-written Hopper kernel and its plain
PyTorch version (counterpart of odh_kubeflow_tpu/ops/attention.py).

Layout at every public function: q (batch, seq, heads, head_dim), k/v
(batch, seq, kv_heads, head_dim) with heads % kv_heads == 0. GQA is native:
head j attends kv head j // (heads // kv_heads) and K/V are never expanded.

``flash_attention`` dispatches on the tensors' device: on a CUDA tensor it
launches the kernel in ``csrc/flash_fwd.cu`` (which replaces the TPU's
``_flash_kernel``) or raises; on a CPU tensor it runs
``flash_attention_plain``, the same arithmetic in straightforward f32 torch.
There is no fallback from the card to the plain version.
"""
import ctypes
from typing import Tuple

import torch

from ..device import DeviceLike, require_hopper, resolve_device
from . import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # ln -> log2 folds into the score scale
LN2 = 0.6931471805599453
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535  # the kernel's grid.y is batch * heads

# kernel name -> launches since the last reset_launch_counts(); each wrapper
# adds one where it launches its kernel and nowhere else
launch_counts = {"flash_fwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def mha_reference(q, k, v, causal: bool = True):
    """Reference attention, GQA-aware, f32 accumulation; the causal mask is
    top-left aligned (q_pos >= k_pos)."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = q.reshape(b, sq, hk, g, d).float()
    s = torch.einsum("bqkgd,bnkd->bkgqn", qg, k.float()) * d**-0.5
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqn,bnkd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention_plain(q, k, v, causal: bool = True, with_lse: bool = False):
    """The kernel's semantics in plain f32 torch: log2-domain scores, p
    rounded to the input dtype before the P.V product, out divided by
    max(l, 1e-30), lse = m*ln2 + ln(max(l, 1e-30)) as (b, h, sq). The causal
    mask is top-left aligned (q_pos >= k_pos). Returns out, or (out, lse)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q.reshape(b, sq, hk, g, d).float()
    s = torch.einsum("bqkgd,bnkd->bkgqn", qg, k.float()) * (d**-0.5 * LOG2E)
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # (b, hk, g, sq, 1)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bkgqn,bnkd->bqkgd", p.to(q.dtype).float(), v.float())
    out = (pv / l.permute(0, 3, 1, 2, 4)).reshape(b, sq, h, d).to(q.dtype)
    if not with_lse:
        return out
    lse = (m * LN2 + torch.log(l)).reshape(b, h, sq)
    return out, lse


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (b, sq, h, d) and k/v (b, sk, hk, d); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on batch or "
            "head_dim, or heads is not a multiple of kv_heads"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} unsupported: the kernel has {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"dtypes {q.dtype}/{k.dtype}/{v.dtype} unsupported: q, k and v "
            "must share one of float32, bfloat16"
        )


def flash_attention(q, k, v, causal: bool = True, with_lse: bool = False,
                    device: DeviceLike = "cuda"):
    """Fused attention; returns out (q's dtype), or (out, lse (b, h, sq)
    f32) with `with_lse`. `device` names where the caller means to run and
    must be where q/k/v lie: a CUDA tensor launches the Hopper kernel, a CPU
    tensor runs `flash_attention_plain`."""
    dev = resolve_device(device)
    for t in (q, k, v):
        if t.device.type != dev.type or (dev.index is not None and t.device != dev):
            raise ValueError(f"tensor on {t.device}, but device={dev}")
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, with_lse=with_lse)
    out, lse = _flash_fwd_op(q, k, v, causal, with_lse)
    return (out, lse) if with_lse else out


_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_fwd")
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.odh_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [i64p] * 3
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        lib.odh_flash_fwd.restype = ctypes.c_int
        lib.odh_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odh_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@torch.library.custom_op(
    "odh_kubeflow_tpu_torch::flash_fwd", mutates_args=(), device_types="cuda"
)
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel as a registered op. lse is an empty tensor when
    `with_lse` is false (the inference variant writes none)."""
    require_hopper(q.device)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel grid's {_MAX_GRID_Y}")
    # strides are read in place; only the last dim must be contiguous
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    lib = _kernel_lib()

    def strides(t):
        return (ctypes.c_int64 * 3)(*t.stride()[:3])

    with torch.cuda.device(q.device):
        err = lib.odh_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            _DTYPE_CODES[q.dtype], b, sq, sk, h, hk, d,
            strides(q), strides(k), strides(v),
            int(causal), d**-0.5 * LOG2E,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            "flash_fwd launch failed: " + lib.odh_cuda_error_string(err).decode()
        )
    launch_counts["flash_fwd"] += 1
    return out, lse
