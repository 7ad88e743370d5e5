"""Flash attention for the port: hand-written Hopper kernels and their plain
PyTorch versions (counterpart of odh_kubeflow_tpu/ops/attention.py).

Layout at every public function: q (batch, seq, heads, head_dim), k/v
(batch, seq, kv_heads, head_dim) with heads % kv_heads == 0. GQA is native:
head j attends kv head j // (heads // kv_heads) and K/V are never expanded.

``flash_attention`` is differentiable (the counterpart of ``_flash_diff``).
Its forward is the op ``odh_kubeflow_tpu_torch::flash_fwd``: on a CUDA
tensor one of the two kernels in ``csrc/flash_fwd.cu`` (which replace the
TPU's ``_flash_kernel``; ``_fwd_kernel_for`` names which), on a CPU tensor
``flash_attention_plain``. Its backward
computes delta = rowsum(dO * O) - g_lse and then runs ``flash_bwd_dq`` and
``flash_bwd_dkv``: on CUDA tensors a pair of kernels in ``csrc/flash_bwd.cu``
(which replace ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``;
``_bwd_kernel_for`` names which pair), on CPU tensors ``flash_bwd_dq_plain``
and ``flash_bwd_dkv_plain``. The plain versions are the kernels' arithmetic
in straightforward f32 torch. There is no fallback from the card to a plain
version, nor from one kernel to another.
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
_MAX_GRID_Y = 65535  # the kernels' grid.y is batch * heads

# kernel name -> launches since the last reset_launch_counts(); each wrapper
# adds one where it launches its kernel and nowhere else. "flash_fwd",
# "flash_bwd_dq" and "flash_bwd_dkv" are the tensor-core kernels, the names
# ending in "_scalar" the scalar ones
launch_counts = {"flash_fwd": 0, "flash_fwd_scalar": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                 "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}


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


def _scores(q, k, causal: bool):
    """log2-domain scores (b, hk, g, sq, sk) in f32, masked with -1e30 where
    the top-left aligned causal mask hides a key."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hk, h // hk, d).float()
    s = torch.einsum("bqkgd,bnkd->bkgqn", qg, k.float()) * (d**-0.5 * LOG2E)
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    return s


def flash_attention_plain(q, k, v, causal: bool = True, with_lse: bool = False):
    """The kernel's semantics in plain f32 torch: log2-domain scores, p
    rounded to the input dtype before the P.V product, out divided by
    max(l, 1e-30), lse = m*ln2 + ln(max(l, 1e-30)) as (b, h, sq). The causal
    mask is top-left aligned (q_pos >= k_pos). Returns out, or (out, lse)."""
    b, sq, h, d = q.shape
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)  # (b, hk, g, sq, 1)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bkgqn,bnkd->bqkgd", p.to(q.dtype).float(), v.float())
    out = (pv / l.permute(0, 3, 1, 2, 4)).reshape(b, sq, h, d).to(q.dtype)
    if not with_lse:
        return out
    lse = (m * LN2 + torch.log(l)).reshape(b, h, sq)
    return out, lse


def _recompute_p_ds(q, k, v, dout, lse, delta, causal: bool):
    """The backward kernels' shared recompute (`_recompute_p_ds` of the
    reference), grouped (b, hk, g, sq, sk) in f32: p = exp2(s - lse*log2e)
    and ds = p * (dO.v^T - delta) * d**-0.5."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    stat = (b, hk, h // hk, sq, 1)
    p = torch.exp2(_scores(q, k, causal) - lse.reshape(stat) * LOG2E)
    og = dout.reshape(b, sq, hk, h // hk, d).float()
    dp = torch.einsum("bqkgd,bnkd->bkgqn", og, v.float())
    return p, p * (dp - delta.reshape(stat)) * d**-0.5


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool = True):
    """dq = sum_k ds.K with ds rounded to K's dtype first, accumulated in
    f32 and returned in q's dtype. lse and delta are f32 (b, h, sq)."""
    b, sq, h, d = q.shape
    _, ds = _recompute_p_ds(q, k, v, dout, lse, delta, causal)
    dq = torch.einsum("bkgqn,bnkd->bqkgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, sq, h, d).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool = True):
    """(dk, dv): dK = sum ds^T.Q with ds rounded to Q's dtype first, dV =
    sum p^T.dO with p rounded to dO's dtype first, each summed over the q
    rows and the GQA group in f32 and returned in k's/v's dtype."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    p, ds = _recompute_p_ds(q, k, v, dout, lse, delta, causal)
    qg = q.reshape(b, sq, hk, h // hk, d).float()
    og = dout.reshape(b, sq, hk, h // hk, d).float()
    dk = torch.einsum("bkgqn,bqkgd->bnkd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bkgqn,bqkgd->bnkd", p.to(dout.dtype).float(), og)
    return dk.to(k.dtype), dv.to(v.dtype)


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


def _on_tensor_cores(dtype: torch.dtype, d: int, what: str) -> bool:
    """The rule both kernel choices follow, as the C side's
    ``odh_flash::kernel_choice`` (``csrc/flash_common.cuh``) does: the
    tensor-core kernels take bf16 at d 64 and 128, the scalar ones f32 at
    every d and bf16 at d 16 and 32; the tensor cores have no f32 product,
    and TF32 would break the f32 gates. Raises ValueError for what no
    `what` kernel takes."""
    if dtype not in _DTYPE_CODES or d not in HEAD_DIMS:
        raise ValueError(f"no {what} kernel for {dtype} at head_dim {d}")
    return dtype == torch.bfloat16 and d in (64, 128)


def _fwd_kernel_for(dtype: torch.dtype, d: int) -> str:
    """Which forward kernel a CUDA launch runs, by (dtype, d) alone, named
    as in `launch_counts` ("flash_fwd": the tensor-core kernel,
    "flash_fwd_scalar": the scalar one); the mirror of the C entry
    ``odh_flash_fwd_kernel`` in ``csrc/flash_fwd.cu``."""
    return "flash_fwd" if _on_tensor_cores(dtype, d, "forward") else "flash_fwd_scalar"


def _bwd_kernel_for(dtype: torch.dtype, d: int) -> Tuple[str, str]:
    """Which (dq, dk/dv) kernels a CUDA backward launch runs, by (dtype, d)
    alone, named as in `launch_counts`; the mirror of the C entry
    ``odh_flash_bwd_kernel`` in ``csrc/flash_bwd.cu``."""
    if _on_tensor_cores(dtype, d, "backward"):
        return "flash_bwd_dq", "flash_bwd_dkv"
    return "flash_bwd_dq_scalar", "flash_bwd_dkv_scalar"


def _tma_problem(t: torch.Tensor):
    """Why TMA cannot read `t` (b, s, heads, d) in place, or None when it
    can: the last dim contiguous, the base address 16-byte aligned, and the
    batch, seq and head strides multiples of 16 bytes (a dim of size 1 has
    no stride that matters)."""
    strides, shape, item = t.stride(), t.shape, t.element_size()
    if strides[3] != 1:
        return f"last dim has stride {strides[3]}, not 1"
    if t.data_ptr() % 16:
        return f"base address {t.data_ptr():#x} is not 16-byte aligned"
    for dim, name in enumerate(("batch", "seq", "head")):
        if shape[dim] > 1 and (strides[dim] * item) % 16:
            return f"{name} stride of {strides[dim] * item} bytes is not a multiple of 16"
    return None


def _tma_readable_dout(dout: torch.Tensor) -> torch.Tensor:
    """dO as the tensor-core backward kernels read it: in place where TMA
    can read it (`_tma_problem` names no problem and no dim of size > 1 is a
    stride-0 broadcast), else a contiguous copy in a fresh (aligned)
    allocation. dO comes from autograd with whatever strides the loss gave
    it (an expanded gradient has stride 0); this is a layout copy, not
    another kernel."""
    broadcast = any(st == 0 and n > 1 for st, n in zip(dout.stride(), dout.shape))
    if broadcast or _tma_problem(dout) is not None:
        return dout.clone(memory_format=torch.contiguous_format)
    return dout


def _check_bwd(q, k, v, dout, lse, delta) -> None:
    _check(q, k, v)
    b, sq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dO {tuple(dout.shape)} {dout.dtype} must match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(b, h, sq)}; got {t.dtype} {tuple(t.shape)}")


def flash_attention(q, k, v, causal: bool = True, with_lse: bool = False,
                    device: DeviceLike = "cuda"):
    """Fused attention; returns out (q's dtype), or (out, lse (b, h, sq)
    f32) with `with_lse`. `device` names where the caller means to run and
    must be where q/k/v lie: a CUDA tensor launches the Hopper kernels, a
    CPU tensor runs the plain versions.

    Differentiable: with grad mode on and q, k or v requiring grad, the
    forward runs its with-lse variant and saves (q, k, v, out, lse) for the
    backward; a gradient reaching lse enters the backward as delta - g_lse.
    Otherwise (inference) it runs the no-lse variant and saves nothing."""
    dev = resolve_device(device)
    for t in (q, k, v):
        if t.device.type != dev.type or (dev.index is not None and t.device != dev):
            raise ValueError(f"tensor on {t.device}, but device={dev}")
    _check(q, k, v)
    training = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    out, lse = _flash_fwd_op(q, k, v, causal, with_lse or training)
    return (out, lse) if with_lse else out


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True):
    """dq of flash attention: a kernel on CUDA tensors (`_bwd_kernel_for`
    names which), the plain version on CPU tensors. lse and delta (=
    rowsum(dO * out) - g_lse) are f32 (b, h, sq)."""
    _check_bwd(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    kernel = _bwd_kernel_for(q.dtype, q.shape[3])[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("odh_flash_bwd_dq", kernel, q, k, v, dout, lse, delta, (dq,), causal)
    launch_counts[kernel] += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True):
    """(dk, dv) of flash attention, summed over each kv head's GQA group:
    a kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_bwd(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal)
    kernel = _bwd_kernel_for(q.dtype, q.shape[3])[1]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("odh_flash_bwd_dkv", kernel, q, k, v, dout, lse, delta, (dk, dv), causal)
    launch_counts[kernel] += 1
    return dk, dv


_P = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64x3 = ctypes.c_int64 * 3
# C entry point -> (library, argtypes); see the extern "C" functions in csrc/
_SIGNATURES = {
    "odh_flash_fwd": ("flash_fwd", [_P] * 5 + [ctypes.c_int] * 7 + [_I64P] * 3
                      + [ctypes.c_int, ctypes.c_float, _P]),
    "odh_flash_fwd_kernel": ("flash_fwd", [ctypes.c_int] * 2),
    "odh_flash_fwd_tile_q": ("flash_fwd", [ctypes.c_int] * 5),
    "odh_flash_bwd_dq": ("flash_bwd", [_P] * 7 + [ctypes.c_int] * 7 + [_I64P] * 4
                         + [ctypes.c_int, ctypes.c_float, ctypes.c_float, _P]),
    "odh_flash_bwd_dkv": ("flash_bwd", [_P] * 8 + [ctypes.c_int] * 7 + [_I64P] * 4
                          + [ctypes.c_int, ctypes.c_float, ctypes.c_float, _P]),
    "odh_flash_bwd_kernel": ("flash_bwd", [ctypes.c_int] * 2),
    "odh_flash_bwd_dkv_tile_k": ("flash_bwd", [ctypes.c_int] * 5),
    "odh_flash_bwd_dq_tile_q": ("flash_bwd", [ctypes.c_int] * 5),
    "odh_flash_fwd_key_split": ("flash_fwd", [ctypes.c_int] * 7),
    "odh_flash_bwd_dkv_q_split": ("flash_bwd", [ctypes.c_int] * 7),
    "odh_flash_bwd_dq_k_split": ("flash_bwd", [ctypes.c_int] * 7),
}


def _entry(fn_name: str):
    """(library, C function) with its argtypes declared; built on first use."""
    lib_name, argtypes = _SIGNATURES[fn_name]
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.odh_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odh_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _scalar_tile(rows: int, groups: int, sms: int) -> int:
    """Rows per block of the scalar forward and dq (q rows; `groups` =
    batch * heads) and dk/dv (k rows; batch * kv_heads) kernels on a card
    of `sms` SMs: 64, else 32, where that tile's grid split over 2-block
    clusters gives at least three quarters of the SMs a block, else 16. A larger tile
    gives each thread more FMAs per shared-memory load; a smaller one fills
    more of the card. The mirror of ``odh_flash::scalar_tile`` in
    ``csrc/flash_common.cuh``."""
    for tile in (64, 32):
        if 8 * groups * -(-rows // tile) >= 3 * sms:
            return tile
    return 16


def _scalar_split(rows: int, groups: int, tile: int, inner: int, max_split: int, sms: int) -> int:
    """Blocks per cluster of a scalar kernel: the blocks of a cluster share
    the `inner` tiles of one row tile; it doubles, up to `max_split`, while
    the grid still leaves SMs idle and the longest row block has two inner
    tiles for each block. The mirror of ``odh_flash::scalar_split``."""
    blocks = groups * -(-rows // tile)
    split = 1
    while split < max_split and blocks * split < sms and inner >= 2 * split:
        split *= 2
    return split


_DQ_KEY_TILE = 64  # the scalar dq kernel's keys per K/V tile (DQ_BK in csrc/flash_bwd.cu)
_DQ_MAX_SPLIT = 2  # and its largest cluster (DQ_MAX_SPLIT)


def _scalar_dq_plan(b: int, sq: int, sk: int, h: int, causal: bool, sms: int) -> Tuple[int, int]:
    """(q rows per block, blocks per cluster) of a scalar dq launch on a
    card of `sms` SMs: the forward's tile rule over batch * heads row
    blocks, and clusters that split the key tiles the longest rows see. The
    mirror of ``dq_tile_q`` and ``dq_k_split`` in ``csrc/flash_bwd.cu``."""
    tile = _scalar_tile(sq, b * h, sms)
    keys = min(sk, sq) if causal else sk
    return tile, _scalar_split(sq, b * h, tile, -(-keys // _DQ_KEY_TILE), _DQ_MAX_SPLIT, sms)


def fwd_launch_plan(dtype: torch.dtype, b: int, sq: int, h: int, d: int) -> Tuple[str, int]:
    """(kernel, q rows per block) that a CUDA forward launch at this shape
    runs, as the built library's C entry decides them (it builds the library
    on first use); for checking the Python mirrors and reporting on the card."""
    _, choose = _entry("odh_flash_fwd_kernel")
    _, tile_q = _entry("odh_flash_fwd_tile_q")
    code = _DTYPE_CODES[dtype]
    kernel = {1: "flash_fwd", 0: "flash_fwd_scalar"}.get(choose(code, d))
    if kernel is None:
        raise ValueError(f"no forward kernel for {dtype} at head_dim {d}")
    return kernel, tile_q(code, d, b, sq, h)


def bwd_kernels_built(dtype: torch.dtype, d: int) -> Tuple[str, str]:
    """(dq, dk/dv) kernels that a CUDA backward launch runs, as the built
    library's C entry decides them (it builds the library on first use);
    for checking the Python mirror `_bwd_kernel_for` on the card."""
    _, choose = _entry("odh_flash_bwd_kernel")
    pair = {1: ("flash_bwd_dq", "flash_bwd_dkv"),
            0: ("flash_bwd_dq_scalar", "flash_bwd_dkv_scalar")}.get(choose(_DTYPE_CODES[dtype], d))
    if pair is None:
        raise ValueError(f"no backward kernel for {dtype} at head_dim {d}")
    return pair


def bwd_dkv_launch_plan(dtype: torch.dtype, b: int, sk: int, hk: int, d: int) -> Tuple[str, int]:
    """(dk/dv kernel, k rows per block) that a CUDA dk/dv launch at this
    shape runs, as the built library's C entries decide them (it builds the
    library on first use): 128 for the tensor-core kernel, the grid's choice
    (`_scalar_tile`) for the scalar one."""
    kernel = bwd_kernels_built(dtype, d)[1]
    _, tile_k = _entry("odh_flash_bwd_dkv_tile_k")
    return kernel, tile_k(_DTYPE_CODES[dtype], d, b, sk, hk)


def bwd_dq_launch_plan(dtype: torch.dtype, b: int, sq: int, h: int, d: int) -> Tuple[str, int]:
    """(dq kernel, q rows per block) that a CUDA dq launch at this shape
    runs, as the built library's C entries decide them (it builds the
    library on first use): 128 for the tensor-core kernel (its ROWS), the
    grid's choice (`_scalar_tile`) for the scalar one."""
    kernel = bwd_kernels_built(dtype, d)[0]
    _, tile_q = _entry("odh_flash_bwd_dq_tile_q")
    return kernel, tile_q(_DTYPE_CODES[dtype], d, b, sq, h)


def scalar_splits(dtype: torch.dtype, d: int, b: int, sq: int, sk: int, h: int, hk: int,
                  causal: bool) -> Tuple[int, int, int]:
    """(forward, dk/dv, dq) blocks per cluster that CUDA launches at this
    shape take, as the built libraries' C entries decide them (odh_flash::
    scalar_split): where a scalar kernel's grid of row tiles alone leaves
    SMs idle, 2 or 4 blocks (forward) or 2 (dk/dv, dq) split the key
    tiles or the q tiles of one row tile and merge through distributed
    shared memory; 1 otherwise and for the tensor-core kernels. For
    reporting on the card."""
    code = _DTYPE_CODES[dtype]
    _, fwd = _entry("odh_flash_fwd_key_split")
    _, dkv = _entry("odh_flash_bwd_dkv_q_split")
    _, dq = _entry("odh_flash_bwd_dq_k_split")
    return (fwd(code, d, b, sq, sk, h, int(causal)), dkv(code, d, b, sq, sk, h, hk),
            dq(code, d, b, sq, sk, h, int(causal)))


def _strides(t):
    """(batch, seq, head) element strides for a kernel: a dim of size 1
    takes the stride a contiguous tensor would have (a multiple of 16 bytes
    at every head dim), which no kernel uses but TMA checks all the same."""
    (b, s, h, d), strides = t.shape, t.stride()
    return _I64x3(*(st if n > 1 else c for st, n, c in zip(strides, (b, s, h), (s * h * d, h * d, d))))


def _cp_async_problem(t: torch.Tensor):
    """Why the scalar kernels' 4-byte cp.async copies cannot read `t` (b,
    s, heads, d) in place, or None when they can: the last dim contiguous,
    the base address and the batch, seq and head strides multiples of 4
    bytes (a dim of size 1 has no stride that matters). Only a bf16 view
    at an odd element offset or stride fails the second rule."""
    if t.stride(3) != 1:
        return f"last dim has stride {t.stride(3)}, not 1"
    if t.data_ptr() % 4:
        return f"base address {t.data_ptr():#x} is not 4-byte aligned"
    item = t.element_size()
    for dim, name in enumerate(("batch", "seq", "head")):
        if t.shape[dim] > 1 and (t.stride(dim) * item) % 4:
            return f"{name} stride of {t.stride(dim) * item} bytes is not a multiple of 4"
    return None


def _inner_contiguous(*ts):
    """The scalar kernels' inputs: read in place through their strides, a
    contiguous copy in a fresh (aligned) allocation only of a view
    `_cp_async_problem` names a problem with."""
    return [t if _cp_async_problem(t) is None else t.clone(memory_format=torch.contiguous_format)
            for t in ts]


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: " + lib.odh_cuda_error_string(err).decode())


def _launch(fn_name, kernel, q, k, v, dout, lse, delta, outs, causal: bool) -> None:
    """Launch one of the backward kernels on the current stream. The
    tensor-core kernels read q, k and v in place through TMA and raise
    ValueError on a view it cannot read, as the forward does (every view the
    forward took passes); dO is read in place where TMA can, else copied
    (`_tma_readable_dout`). The scalar kernels read any strides in place
    but copy what `_cp_async_problem` names (a last dim that is not
    contiguous, a base or stride not a multiple of 4 bytes)."""
    require_hopper(q.device)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel grid's {_MAX_GRID_Y}")
    if kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        for name, t in (("q", q), ("k", k), ("v", v)):
            problem = _tma_problem(t)
            if problem is not None:
                raise ValueError(f"{name} cannot be read by TMA: {problem}")
        dout = _tma_readable_dout(dout)
    else:
        q, k, v, dout = _inner_contiguous(q, k, v, dout)
    lse, delta = lse.contiguous(), delta.contiguous()
    lib, fn = _entry(fn_name)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            _DTYPE_CODES[q.dtype], b, sq, sk, h, hk, d,
            _strides(q), _strides(k), _strides(v), _strides(dout),
            int(causal), d**-0.5 * LOG2E, d**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(lib, err, kernel)


@torch.library.custom_op(
    "odh_kubeflow_tpu_torch::flash_fwd", mutates_args=(), device_types="cuda"
)
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel as a registered op. lse is an empty tensor when
    `with_lse` is false (the inference variant writes none).

    bf16 at d 64 and 128 runs the tensor-core kernel, which reads q, k and v
    in place through TMA: each must have its last dim contiguous, a 16-byte
    aligned base and batch, seq and head strides that are multiples of 16
    bytes, or this raises ValueError (no copy, no other kernel). Every view
    the port hands over meets that: the fused-qkv bf16 views have a seq
    stride of (h + 2*hk)*d*2 bytes and head offsets of h*d*2 and (h+hk)*d*2
    bytes, all multiples of 16 at d 64 and 128, and rotary's outputs are
    contiguous.

    The scalar kernel (f32, and bf16 at d 16 and 32) streams K/V tiles into
    shared memory with cp.async: 16-byte copies where the base addresses and
    the batch, seq and head strides of q, k and v are all multiples of 16
    bytes (every contiguous tensor and fused-qkv view of the port), else
    4-byte copies. It reads any such strides in place; the wrapper makes a
    contiguous copy only of a view whose last dim is not contiguous or whose
    base or strides are not multiples of 4 bytes (a bf16 view at an odd
    element offset; `_cp_async_problem`)."""
    require_hopper(q.device)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel grid's {_MAX_GRID_Y}")
    kernel = _fwd_kernel_for(q.dtype, d)
    if kernel == "flash_fwd":
        for name, t in (("q", q), ("k", k), ("v", v)):
            problem = _tma_problem(t)
            if problem is not None:
                raise ValueError(f"{name} cannot be read by TMA: {problem}")
    else:
        q, k, v = _inner_contiguous(q, k, v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    lib, fn = _entry("odh_flash_fwd")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            _DTYPE_CODES[q.dtype], b, sq, sk, h, hk, d,
            _strides(q), _strides(k), _strides(v),
            int(causal), d**-0.5 * LOG2E,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(lib, err, kernel)
    launch_counts[kernel] += 1
    return out, lse


@_flash_fwd_op.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, causal, with_lse):
    """CPU tensors take the plain version, through the same op, so the CPU
    tests exercise the op's autograd and checkpoint wiring."""
    if with_lse:
        return flash_attention_plain(q, k, v, causal=causal, with_lse=True)
    out = flash_attention_plain(q, k, v, causal=causal)
    return out, torch.empty((0,), dtype=torch.float32)


def _fwd_setup_context(ctx, inputs, output):
    q, k, v, causal, _ = inputs
    out, lse = output
    ctx.causal = causal
    ctx.save_for_backward(q, k, v, out, lse)


def _fwd_backward(ctx, g_out, g_lse):
    """The counterpart of `_flash_diff_bwd` with `_flash_backward(g_lse=)`:
    delta = rowsum(dO * out) in f32, less the lse cotangent, then the dq and
    dk/dv kernels."""
    q, k, v, out, lse = ctx.saved_tensors
    if lse.numel() == 0:
        raise RuntimeError("flash_fwd ran its no-lse variant; its backward needs lse")
    delta = (g_out.float() * out.float()).sum(-1).transpose(1, 2)  # (b, h, sq)
    if g_lse is not None:
        delta = delta - g_lse
    dq = flash_bwd_dq(q, k, v, g_out, lse, delta, ctx.causal)
    dk, dv = flash_bwd_dkv(q, k, v, g_out, lse, delta, ctx.causal)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup_context)
