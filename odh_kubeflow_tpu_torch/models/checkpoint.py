"""Workload checkpoint/resume (counterpart of
odh_kubeflow_tpu/models/checkpoint.py, which is orbax-backed).

The train state (params, optimizer state; nested dicts of tensors) is
saved per step and restored onto the devices of a `like` tree, or onto a
mesh, so a culled, restarted or repaired notebook resumes exactly. The
directory is laid out per step, as orbax lays it out: `<dir>/<step>/`.
`latest_step` counts only finished steps. Reads never create the
directory: a typo'd path must not pass for an empty checkpoint dir.

One process (no mesh, or a mesh of one rank) saves the whole state as
`<step>/state.pt` (`torch.save`) beside its `checksum`, written into a
temporary sibling directory and moved into place with `os.replace`, so a
reader never sees half a step.

Several ranks (a mesh; `placements` says how each leaf is cut, a leaf it
does not name is replicated) save per shard, as orbax does: each rank
writes the blocks it owns (a leaf replicated over some axes by the rank at
index 0 on them, orbax's replica-0 rule) into `shard-R-of-W-T.pt`, with
an index `shard-R-of-W-T.json` of each block's place in the global leaf
(the fused QKV projection's blocks in the reference's global layout).
`T` tells this save from an earlier one of the same step: it digests the
step, the tree, the mesh and every leaf replicated over the whole mesh
(the optimizer's count, the norms), which every rank holds with the same
bits. A step is finished when all W indexes of one save are on disk.

The probe agent calls a rank's hooks on its HTTP thread, while the
training loop may be inside a collective on the same process groups, so
saves coordinate through the filesystem alone, never a collective: each
file is moved into place with `os.replace` under a per-step lock file
(`.lock-<step>`, created exclusively), which also removes an earlier
save's files of the step; then the rank waits, bounded, for the other
ranks' indexes, and acks the `state_checksum` of the global state read
back from disk: every rank acks the same digest, the one a single process
holding the gathered state would. Several processes saving the same step
without a mesh (ranks that hold one replicated state) end in one step:
the first moves its directory into place, the others find a finished step
with their checksum and keep it. Pruning skips a step whose lock is held.

`restore_train_state` reads any finished step, whatever mesh saved it:
each leaf of `like` gets the parts of the global leaf its block covers.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import Placement
from .convert import placement_at

STATE_FILE = "state.pt"
CHECKSUM_FILE = "checksum"
# a rank's files of a sharded save: its blocks (.pt) and their index (.json)
SHARD = "shard-{rank:05d}-of-{world:05d}-{token}"
_SHARD_RE = re.compile(r"^shard-(\d{5})-of-(\d{5})-([0-9a-f]{16})\.json$")
# the bounded waits: for a step's lock, and for the other ranks' blocks
TIMEOUT_S = 300.0
POLL_S = 0.01


def _save_id(step: int) -> str:
    return f".tmp-{int(step)}-{os.getpid()}-{threading.get_ident()}"


def _shard_saves(step_dir: str) -> Dict[Tuple[int, str], set]:
    """(world, token) -> the ranks whose index of that save is on disk (none
    for a step directory another process pruned meanwhile)."""
    saves: Dict[Tuple[int, str], set] = {}
    try:
        names = os.listdir(step_dir)
    except FileNotFoundError:
        return saves
    for name in names:
        m = _SHARD_RE.match(name)
        if m:
            saves.setdefault((int(m.group(2)), m.group(3)), set()).add(int(m.group(1)))
    return saves


def _finished(step_dir: str) -> bool:
    if not os.path.isdir(step_dir):
        return False
    if os.path.isfile(os.path.join(step_dir, STATE_FILE)):
        return True
    return any(len(ranks) == world for (world, _), ranks in _shard_saves(step_dir).items())


def _finished_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and _finished(os.path.join(directory, name)))


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _lock_path(directory: str, step: int) -> str:
    return os.path.join(directory, f".lock-{int(step)}")


def _try_lock(directory: str, step: int) -> Optional[int]:
    try:
        return os.open(_lock_path(directory, step), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return None


def _unlock(directory: str, step: int, fd: int) -> None:
    os.close(fd)
    os.unlink(_lock_path(directory, step))


@contextlib.contextmanager
def _step_lock(directory: str, step: int):
    """Holds the step's lock file, waiting for it at most TIMEOUT_S."""
    deadline = time.monotonic() + TIMEOUT_S
    while (fd := _try_lock(directory, step)) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"step {step} of {directory!r} stayed locked ({_lock_path(directory, step)}) "
                               f"for {TIMEOUT_S} s")
        time.sleep(POLL_S)
    try:
        yield
    finally:
        _unlock(directory, step, fd)


def _prune(directory: str, max_to_keep: int) -> None:
    """Removes all but the newest max_to_keep finished steps, skipping a
    step whose lock another save holds."""
    for old in _finished_steps(directory)[:-max_to_keep]:
        fd = _try_lock(directory, old)
        if fd is None:
            continue
        try:
            shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
        finally:
            _unlock(directory, old, fd)


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


def _leaf_paths(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in jax.tree_util's order: dict keys sorted."""
    if isinstance(tree, dict):
        for name in sorted(tree):
            yield from _leaf_paths(tree[name], path + (name,))
    else:
        yield path, tree


def _shows(path: Tuple[str, ...]) -> str:
    return "/" + "/".join(path)


def _multi_rank(mesh) -> bool:
    return mesh is not None and mesh.world > 1


def save_train_state(directory: str, step: int, state: Any, max_to_keep: int = 3, mesh=None,
                     placements: Any = None) -> str:
    """Save `state` (nested dicts of tensors, on any device) at `step`, then
    prune all but the newest `max_to_keep` finished steps; returns the
    `state_checksum` of the saved (global) state. Saving a step that exists
    replaces it, so the files always hold the state whose checksum the last
    save acked. With a mesh of several ranks, `state` is this rank's blocks
    of the global state as `placements` cuts it (a tree of
    parallel.Placement; a leaf it does not name is replicated, e.g.
    models.train_state_placements), every rank of the mesh saves, and the
    call returns once every rank's blocks are on disk (TimeoutError after
    TIMEOUT_S)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    if _multi_rank(mesh):
        checksum = _save_shards(directory, int(step), state, mesh, placements)
    else:
        checksum = _save_whole(directory, int(step), state)
    _prune(directory, max_to_keep)
    return checksum


def _read_checksum(step_dir: str) -> Optional[str]:
    try:
        with open(os.path.join(step_dir, CHECKSUM_FILE)) as f:
            return f.read().strip()
    except FileNotFoundError:
        return None


def _save_whole(directory: str, step: int, state: Any) -> str:
    state = _detached(state)
    checksum = state_checksum(state)
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, _save_id(step))
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        path = os.path.join(tmp, STATE_FILE)
        torch.save(state, path)
        _fsync(path)
        with open(os.path.join(tmp, CHECKSUM_FILE), "w") as f:
            f.write(checksum)
        with _step_lock(directory, step):
            if _read_checksum(final) == checksum and _finished(final):
                pass  # another process saved this state at this step
            elif os.path.exists(final):
                old = f"{tmp}-replaced"
                os.replace(final, old)
                os.replace(tmp, final)
                shutil.rmtree(old)
            else:
                os.replace(tmp, final)
            _fsync(directory)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return checksum


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _token(step: int, leaves, mesh) -> str:
    """Tells this save's shard files from another save's of the same step:
    the step, the mesh, every leaf's path, global shape and dtype, and the
    bytes of every leaf replicated over the whole mesh (the same bits on
    every rank)."""
    h = hashlib.sha256(json.dumps([step, mesh.sizes]).encode())
    for path, t, pl, shape in leaves:
        h.update(json.dumps([path, shape, _dtype_name(t)]).encode())
        if not pl.axes():
            _digest(h, t)
    return h.hexdigest()[:16]


def _save_shards(directory: str, step: int, state: Any, mesh, placements: Any) -> str:
    leaves = []
    for path, t in _leaf_paths(state):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"checkpoint leaf {_shows(path)} is a {type(t).__name__}, not a tensor")
        pl = placement_at(placements, path)
        leaves.append((path, t, pl, list(pl.global_shape(t.shape, mesh.sizes))))
    world, token = mesh.world, _token(step, leaves, mesh)
    name = SHARD.format(rank=mesh.rank, world=world, token=token)
    blocks, index = {}, []
    for path, t, pl, shape in leaves:
        entry = {"path": list(path), "shape": shape, "dtype": _dtype_name(t), "blocks": []}
        if pl.writer(mesh.coords, mesh.sizes):
            for i, (local, glob, size) in enumerate(pl.pieces(shape, mesh.coords, mesh.sizes)):
                key = f"{'/'.join(path)}#{i}"
                blocks[key] = t.detach()[_box(local, size)]
                entry["blocks"].append({"key": key, "offset": list(glob), "shape": list(size)})
        index.append(entry)
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, _save_id(step))
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(_detached(blocks), os.path.join(tmp, name + ".pt"))
        with open(os.path.join(tmp, name + ".json"), "w") as f:
            json.dump({"rank": mesh.rank, "world": world, "token": token, "mesh": mesh.sizes,
                       "leaves": index}, f)
        for ext in (".pt", ".json"):
            _fsync(os.path.join(tmp, name + ext))
        with _step_lock(directory, step):
            os.makedirs(final, exist_ok=True)
            ours = f"-of-{world:05d}-{token}."
            for stale in os.listdir(final):  # an earlier save of this step
                if ours not in stale:
                    path = os.path.join(final, stale)
                    shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
            # the index last: a rank's blocks count once its index is there
            for ext in (".pt", ".json"):
                os.replace(os.path.join(tmp, name + ext), os.path.join(final, name + ext))
            _fsync(final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.monotonic() + TIMEOUT_S
    while len(_shard_saves(final).get((world, token), ())) < world:
        if time.monotonic() > deadline:
            have = sorted(_shard_saves(final).get((world, token), ()))
            raise TimeoutError(f"step {step} of {directory!r}: only ranks {have} of {world} had their "
                               f"blocks on disk after {TIMEOUT_S} s")
        time.sleep(POLL_S)
    return _saved_checksum(final)


def latest_step(directory: str) -> Optional[int]:
    """The newest finished step under `directory`, or None (also for a
    path that does not exist, which is not created)."""
    steps = _finished_steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy array, dtype name as numpy/ml_dtypes spell it). bf16 has no
    numpy dtype here: its 2-byte payload goes through int16."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy(), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _digest(h, leaf: torch.Tensor) -> None:
    arr, dtype = _host_array(leaf)
    h.update(str(arr.shape).encode())
    h.update(dtype.encode())
    # the reference hashes np.ascontiguousarray(arr).tobytes(): the same
    # bytes, here read in place rather than copied
    h.update(np.ascontiguousarray(arr).data)


def state_checksum(state: Any) -> str:
    """Deterministic digest of a state tree: shape, dtype name and bytes of
    every leaf, in jax.tree_util's leaf order (dict keys sorted, whatever
    order the dict was built in). For the same params it equals the
    reference's `state_checksum` byte for byte, bf16 included ("bfloat16"
    and its 2-byte payload). The port's AdamW state is a dict {count, mu,
    nu} where optax's is a tuple of named tuples, so the digest of a whole
    train state is the port's own and is compared only within the port.
    The checkpoint hook acks this digest (of the global state: a sharded
    save's is read back from disk); the /tpu/restore probe's digest must
    match it."""
    h = hashlib.sha256()
    for _, leaf in _leaf_paths(state):
        _digest(h, leaf)
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


def _box(offsets, shape) -> tuple:
    return tuple(slice(o, o + n) for o, n in zip(offsets, shape))


class _Saved:
    """A finished step on disk: each leaf's global shape, dtype and blocks
    (file, key, global offset, shape). The files are loaded memory-mapped
    once each, so a rank reads only the bytes its blocks need."""

    def __init__(self, step_dir: str):
        self.leaves: Dict[Tuple[str, ...], Tuple[tuple, torch.dtype, list]] = {}
        self._files: Dict[str, Any] = {}
        whole = os.path.join(step_dir, STATE_FILE)
        if os.path.isfile(whole):
            for path, t in _leaf_paths(self._load(whole)):
                shape = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
                self.leaves[path] = (shape, getattr(t, "dtype", None),
                                     [(whole, path, (0,) * len(shape), shape)])
            return
        (world, token), _ = next((k, r) for k, r in _shard_saves(step_dir).items() if len(r) == k[0])
        for rank in range(world):
            name = os.path.join(step_dir, SHARD.format(rank=rank, world=world, token=token))
            with open(name + ".json") as f:
                index = json.load(f)
            for leaf in index["leaves"]:
                path = tuple(leaf["path"])
                shape, dtype, blocks = self.leaves.setdefault(
                    path, (tuple(leaf["shape"]), getattr(torch, leaf["dtype"]), []))
                blocks.extend((name + ".pt", b["key"], tuple(b["offset"]), tuple(b["shape"]))
                              for b in leaf["blocks"])

    def _load(self, file: str):
        if file not in self._files:
            self._files[file] = torch.load(file, map_location="cpu", weights_only=True, mmap=True)
        return self._files[file]

    def _block(self, file: str, key) -> torch.Tensor:
        node = self._load(file)
        for k in (key if isinstance(key, tuple) else (key,)):
            node = node[k]
        return node

    def tree(self) -> Any:
        """The saved tree's structure: nested dicts with each leaf's path."""
        out: Dict[str, Any] = {}
        for path in self.leaves:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = path
        return out

    def read(self, path: Tuple[str, ...], offset, shape) -> Tuple[torch.Tensor, bool]:
        """The box (offset, shape) of a global leaf, and whether it is a
        new tensor (False: a memory-mapped block of the file)."""
        _, dtype, blocks = self.leaves[path]
        for file, key, off, size in blocks:
            if tuple(off) == tuple(offset) and tuple(size) == tuple(shape):
                return self._block(file, key), False
        out = torch.empty(shape, dtype=dtype)
        covered = 0
        for file, key, off, size in blocks:
            lo = [max(a, b) for a, b in zip(off, offset)]
            hi = [min(a + n, b + m) for a, n, b, m in zip(off, size, offset, shape)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            part = [h - l for l, h in zip(lo, hi)]
            out[_box([l - o for l, o in zip(lo, offset)], part)] = \
                self._block(file, key)[_box([l - o for l, o in zip(lo, off)], part)]
            covered += int(np.prod(part, dtype=np.int64))
        if covered != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"checkpoint leaf {_shows(path)}: the saved blocks hold {covered} of the "
                             f"{int(np.prod(shape, dtype=np.int64))} elements at {tuple(offset)} {tuple(shape)}")
        return out, True


def _saved_checksum(step_dir: str) -> str:
    """state_checksum of the global state a finished step holds, read from
    its files."""
    saved = _Saved(step_dir)
    h = hashlib.sha256()
    for path in sorted(saved.leaves):
        shape = saved.leaves[path][0]
        _digest(h, saved.read(path, (0,) * len(shape), shape)[0])
    return h.hexdigest()[:16]


def make_checkpoint_hook(directory: str, state_provider: Callable[[], Tuple[int, Any]],
                         max_to_keep: int = 3, mesh=None, placements: Any = None) -> Callable[[], dict]:
    """Checkpoint hook for the probe agent's /tpu/checkpoint: during a
    checkpoint-before-evict window the controller GETs it on every host,
    and this saves the live train state. `state_provider` returns (step,
    state) of the current run (with a mesh: this rank's blocks, cut as
    `placements` says). The ack carries the checksum of the global state
    for the restore side: every rank of one save acks the same one."""

    def hook() -> dict:
        step, state = state_provider()
        checksum = save_train_state(directory, int(step), state, max_to_keep=max_to_keep, mesh=mesh,
                                    placements=placements)
        return {"step": int(step), "checksum": checksum}

    return hook


def make_restore_hook(directory: str, like_provider: Callable[[], Any],
                      mesh=None, placements: Any = None) -> Callable[[], dict]:
    """Restore hook for the probe agent's /tpu/restore: the resumed notebook
    (or the promoted InferenceEndpoint in Loading) restores the latest
    checkpoint onto `like_provider()`'s devices (with a mesh: this rank's
    blocks, on mesh.device) and acks the restored state's checksum, so the
    controller can compare it with the save's; over several ranks, the
    checksum of the global state the step holds, read from its files. A
    restore that fails raises; the agent reports it in its ack."""

    def hook() -> dict:
        like = like_provider()
        step = latest_step(directory)
        if step is None:
            return {"restored": False, "reason": f"no checkpoint under {directory!r}"}
        state = restore_train_state(directory, like, step=step, mesh=mesh, placements=placements)
        if _multi_rank(mesh):
            checksum = _saved_checksum(os.path.join(os.path.abspath(directory), str(step)))
        else:
            checksum = state_checksum(state)
        return {"restored": True, "step": int(step), "checksum": checksum}

    return hook


def restore_train_state(directory: str, like: Any, step: Optional[int] = None, mesh=None,
                        placements: Any = None) -> Any:
    """Restore a step (the latest by default) onto `like`, whatever mesh or
    single process saved it. Without a mesh each leaf is the whole global
    leaf, on the device of the matching leaf of `like`. With a mesh each
    leaf is this rank's block as `placements` cuts it (a leaf it does not
    name, such as AdamW's count, is restored whole, replicated) on
    mesh.device. A missing step raises FileNotFoundError; a tree, shape or
    dtype that differs from `like` raises, naming the leaf's path; nothing
    is cast."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory!r}")
    step_dir = os.path.join(directory, str(int(step)))
    if not _finished(step_dir):
        raise FileNotFoundError(f"no checkpoint of step {step} under {directory!r}")
    saved = _Saved(step_dir)
    sizes = mesh.sizes if mesh is not None else None

    def leaf(path: Tuple[str, ...], like_leaf: torch.Tensor) -> torch.Tensor:
        shape, dtype, _ = saved.leaves[path]
        pl = placement_at(placements, path) if mesh is not None else Placement()
        local = pl.local_shape(shape, sizes) if mesh is not None else shape
        if tuple(local) != tuple(like_leaf.shape) or dtype != like_leaf.dtype:
            raise ValueError(f"checkpoint leaf {_shows(path)} is {tuple(local)} {dtype}, "
                             f"want {tuple(like_leaf.shape)} {like_leaf.dtype}")
        device = mesh.device if mesh is not None else like_leaf.device
        pieces = pl.pieces(shape, mesh.coords, sizes) if mesh is not None else [((0,) * len(shape),) * 2 + (shape,)]
        if len(pieces) == 1 and tuple(pieces[0][2]) == tuple(local):
            t, fresh = saved.read(path, pieces[0][1], local)
        else:
            t, fresh = torch.empty(local, dtype=dtype), True
            for loc, glob, size in pieces:
                t[_box(loc, size)] = saved.read(path, glob, size)[0]
        if not fresh and torch.device(device).type == "cpu":
            return t.clone()  # not the memory-mapped file's pages
        return t.to(device)

    return _onto(saved.tree(), like, (), leaf)


def _onto(saved: Any, like: Any, path: Tuple[str, ...], leaf) -> Any:
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            have = sorted(saved) if isinstance(saved, dict) else "a leaf"
            raise ValueError(f"checkpoint tree at {_shows(path)} holds {have}, want {sorted(like)}")
        return {name: _onto(saved[name], child, path + (name,), leaf) for name, child in like.items()}
    if isinstance(saved, dict) or not isinstance(like, torch.Tensor):
        have = "a subtree" if isinstance(saved, dict) else "a tensor"
        raise TypeError(f"checkpoint leaf {_shows(path)}: {have} onto {type(like).__name__}")
    return leaf(path, like)
