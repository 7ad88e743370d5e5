"""Workload checkpoint/resume (counterpart of
odh_kubeflow_tpu/models/checkpoint.py, which is orbax-backed).

The train state (params, optimizer state; nested dicts of tensors) is
saved per step with `torch.save` and restored onto the devices of a
`like` tree, so a culled, restarted or repaired notebook resumes exactly.
The directory is laid out per step, as orbax lays it out: `<dir>/<step>/`
holds `state.pt`. A step is written into a temporary sibling directory
and moved into place with `os.replace`, so a reader never sees half a
step; `latest_step` counts only finished steps. Reads never create the
directory: a typo'd path must not pass for an empty checkpoint dir.

No mesh yet: the save per shard and the restore onto a mesh wait for the
port's multi-GPU layer (ROADMAP Queue 1 item 13); `mesh=` raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

STATE_FILE = "state.pt"


def _finished_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, STATE_FILE))
    )


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _detached(tree: Any, path: str = "") -> Any:
    """The tree with every leaf detached; a view is cloned, because
    torch.save writes a view's whole storage."""
    if isinstance(tree, dict):
        return {name: _detached(child, f"{path}/{name}") for name, child in tree.items()}
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {path or '/'} is a {type(tree).__name__}, not a tensor")
    t = tree.detach()
    if t.untyped_storage().nbytes() != t.nbytes or not t.is_contiguous():
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def save_train_state(directory: str, step: int, state: Any, max_to_keep: int = 3) -> None:
    """Save `state` (nested dicts of tensors, on any device) at `step`, then
    prune all but the newest `max_to_keep` finished steps. Saving a step
    that exists replaces it, so the files always hold the state whose
    checksum the last save acked."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(int(step)))
    tmp = os.path.join(directory, f".tmp-{int(step)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        path = os.path.join(tmp, STATE_FILE)
        torch.save(_detached(state), path)
        _fsync(path)
        if os.path.exists(final):
            old = f"{tmp}-replaced"
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        _fsync(directory)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for old_step in _finished_steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old_step)))


def latest_step(directory: str) -> Optional[int]:
    """The newest finished step under `directory`, or None (also for a
    path that does not exist, which is not created)."""
    steps = _finished_steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def _leaves_sorted(tree: Any) -> Iterator[torch.Tensor]:
    """Leaves in jax.tree_util's order: dict keys sorted."""
    if isinstance(tree, dict):
        for name in sorted(tree):
            yield from _leaves_sorted(tree[name])
    else:
        yield tree


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy array, dtype name as numpy/ml_dtypes spell it). bf16 has no
    numpy dtype here: its 2-byte payload goes through int16."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy(), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def state_checksum(state: Any) -> str:
    """Deterministic digest of a state tree: shape, dtype name and bytes of
    every leaf, in jax.tree_util's leaf order (dict keys sorted, whatever
    order the dict was built in). For the same params it equals the
    reference's `state_checksum` byte for byte, bf16 included ("bfloat16"
    and its 2-byte payload). The port's AdamW state is a dict {count, mu,
    nu} where optax's is a tuple of named tuples, so the digest of a whole
    train state is the port's own and is compared only within the port.
    The checkpoint hook acks this digest; the /tpu/restore probe's digest
    must match it."""
    h = hashlib.sha256()
    for leaf in _leaves_sorted(state):
        arr, dtype = _host_array(leaf)
        h.update(str(arr.shape).encode())
        h.update(dtype.encode())
        # the reference hashes np.ascontiguousarray(arr).tobytes(): the same
        # bytes, here read in place rather than copied
        h.update(np.ascontiguousarray(arr).data)
    return h.hexdigest()[:16]


def logit_fingerprint(params: Any, cfg: Any, prompt) -> str:
    """Digest of the prefill logits of a fixed prompt, taken as f32, run on
    the params' device. It sees only what the forward pass touches, but it
    verifies the model as served: a save/restore round trip leaves it
    unchanged. It is compared only within one package (across packages the
    logits are compared with a tolerance)."""
    from .decode import prefill

    device = params["embed"].device
    tokens = torch.as_tensor([list(prompt)], dtype=torch.long, device=device)
    with torch.inference_mode():
        logits, _ = prefill(params, tokens, cfg, tokens.shape[1])
    arr = np.ascontiguousarray(logits.float().cpu().numpy())
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def make_checkpoint_hook(directory: str, state_provider: Callable[[], Tuple[int, Any]],
                         max_to_keep: int = 3) -> Callable[[], dict]:
    """Checkpoint hook for the probe agent's /tpu/checkpoint: during a
    checkpoint-before-evict window the controller GETs it, and this saves
    the live train state. `state_provider` returns (step, state) of the
    current run. The ack carries the state checksum for the restore side."""

    def hook() -> dict:
        step, state = state_provider()
        save_train_state(directory, int(step), state, max_to_keep=max_to_keep)
        return {"step": int(step), "checksum": state_checksum(state)}

    return hook


def make_restore_hook(directory: str, like_provider: Callable[[], Any],
                      mesh=None) -> Callable[[], dict]:
    """Restore hook for the probe agent's /tpu/restore: the resumed notebook
    (or the promoted InferenceEndpoint in Loading) restores the latest
    checkpoint onto `like_provider()`'s devices and acks the restored
    state's checksum, so the controller can compare it with the save's.
    A restore that fails raises; the agent reports it in its ack."""

    def hook() -> dict:
        like = like_provider()
        step = latest_step(directory)
        if step is None:
            return {"restored": False, "reason": f"no checkpoint under {directory!r}"}
        state = restore_train_state(directory, like, step=step, mesh=mesh)
        return {"restored": True, "step": int(step), "checksum": state_checksum(state)}

    return hook


def _onto(loaded: Any, like: Any, path: str) -> Any:
    if isinstance(like, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(like):
            have = sorted(loaded) if isinstance(loaded, dict) else type(loaded).__name__
            raise ValueError(f"checkpoint tree at {path or '/'} holds {have}, want {sorted(like)}")
        return {name: _onto(loaded[name], child, f"{path}/{name}") for name, child in like.items()}
    if not isinstance(loaded, torch.Tensor) or not isinstance(like, torch.Tensor):
        raise TypeError(f"checkpoint leaf {path}: {type(loaded).__name__} onto {type(like).__name__}")
    if loaded.shape != like.shape or loaded.dtype != like.dtype:
        raise ValueError(
            f"checkpoint leaf {path} is {tuple(loaded.shape)} {loaded.dtype}, "
            f"want {tuple(like.shape)} {like.dtype}"
        )
    return loaded.to(like.device)


def restore_train_state(directory: str, like: Any, step: Optional[int] = None, mesh=None) -> Any:
    """Restore a step (the latest by default) onto `like`: each leaf lands
    on the device of the matching leaf of `like`. A missing step raises
    FileNotFoundError; a tree, shape or dtype that differs from `like`
    raises, naming the leaf's path; nothing is cast."""
    if mesh is not None:
        raise NotImplementedError("restoring onto a mesh is not ported yet: ROADMAP Queue 1 item 13.3 (restore onto a mesh)")
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory!r}")
    path = os.path.join(directory, str(int(step)), STATE_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint of step {step} under {directory!r}")
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    return _onto(loaded, like, "")
