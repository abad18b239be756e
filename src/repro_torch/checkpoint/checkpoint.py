"""Atomic, async checkpoints with validated restore (port of
``repro.checkpoint.checkpoint``).

The on-disk layout is the reference's, byte for byte where it matters,
so each package reads the other's files:

    <dir>/step_000123/
        manifest.json          {step, leaves: [{shape, dtype}], meta?}
        shard_0.npz            leaf_0, leaf_1, ... by flat leaf index
    <dir>/LATEST               atomic pointer (text: "step_000123")

* A save writes into ``.tmp_step_*`` and renames it into place, then
  swaps ``LATEST`` through ``.LATEST.tmp``: a crashed save never
  publishes a partial step.
* ``async_=True`` writes on a thread; the leaves are snapshotted to
  host numpy first, synchronously (a tensor is copied off its device,
  or cloned on the CPU), so the caller may go on mutating its tensors.
* A restore validates the step (manifest, shard file, leaf shapes) and
  ``fallback=True`` walks back to the newest complete save when the
  newest is torn.

bf16 leaves are stored as the reference stores them: ``np.savez`` of a
numpy ``bfloat16`` array (what ``np.asarray`` of a JAX array gives)
writes its 16-bit words as a ``|V2`` array, and the manifest says
``"bfloat16"``. The port writes a bf16 tensor's words the same way
(numpy itself has no bfloat16, and the card's machine has no package
that adds one) and reads such a leaf back with
``view(torch.bfloat16)``, so a bf16 train state crosses between the
packages in both files' directions. (The reference's own
``restore_checkpoint`` refuses a ``|V2`` leaf: ROADMAP Queue 3.)

Leaves are flattened in ``jax.tree.flatten``'s order (:func:`tree_flatten`):
a dict by sorted key (an ``OrderedDict`` by insertion), lists and tuples
in order, a namedtuple by field, and ``None`` holds no leaf. A state
saved by either package therefore restores into the other's structure
leaf for leaf.

A sharded state (DTensor leaves, ``launch.sharding``) is saved whole:
every rank of the world calls :func:`save_checkpoint`, each leaf's
distinct shards are sent to rank 0 (``dtensor.gather_to_root``), rank
0 snapshots and writes, and every rank
waits at a barrier after the atomic publish (with ``async_=True``, in
the returned handle's ``join``). :func:`restore_checkpoint` with
``shardings=`` hands each rank DTensors over its own slices of the
stored leaves, on any mesh: the one that saved or another (an elastic
restart). The files are the same either way, so a sharded state
restores from a checkpoint of an unsharded one (either package's) and
the reverse.

Two access levels: :func:`save_checkpoint` / :func:`restore_checkpoint`
(a nested structure of tensors in, tensors on ``device`` out) and
:func:`load_checkpoint_arrays` (host numpy leaves plus the manifest, no
device placement: the stream state restores through it, so its float64
drift ledger never passes through a tensor).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..dtensor import gather_to_root, is_dtensor, shard_of


class CheckpointCorruptError(RuntimeError):
    """A step directory exists but cannot be restored (partial write,
    truncated shard, manifest/leaf mismatch)."""


# -- the pytree order ----------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten(tree):
    """``(leaves, treedef, paths)`` in ``jax.tree.flatten``'s leaf
    order. ``treedef`` rebuilds the structure (:func:`tree_unflatten`);
    ``paths`` names each leaf (``"['params']['w']"``) for errors."""
    leaves: list = []
    paths: list = []
    return leaves, _walk(tree, "", leaves, paths), paths


# The recursions are module functions, not closures: a nested function
# that calls itself holds its own cell, and that cycle would keep the
# leaves it closes over (a whole state's tensors) alive until the
# garbage collector runs.
def _walk(node, path, leaves, paths):
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = list(node) if isinstance(node, OrderedDict) else sorted(node)
        return ("dict", type(node), keys,
                [_walk(node[k], f"{path}[{k!r}]", leaves, paths)
                 for k in keys])
    if _is_namedtuple(node):
        return ("namedtuple", type(node), None,
                [_walk(v, f"{path}.{f}", leaves, paths)
                 for f, v in zip(type(node)._fields, node)])
    if isinstance(node, (list, tuple)):
        return ("seq", type(node), None,
                [_walk(v, f"{path}[{i}]", leaves, paths)
                 for i, v in enumerate(node)])
    leaves.append(node)
    paths.append(path or "<root>")
    return ("leaf",)


def tree_unflatten(treedef, leaves):
    """The structure of ``treedef`` with ``leaves`` in flat order."""
    return _build(treedef, iter(leaves))


def _build(td, it):
    kind = td[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    _, typ, keys, kids = td
    vals = [_build(k, it) for k in kids]
    if kind == "dict":
        out = typ()
        out.update(zip(keys, vals))
        return out
    if kind == "namedtuple":
        return typ(*vals)
    return typ(vals)


BF16_WORDS = np.dtype("V2")     # how npz holds a bfloat16 leaf


def _host_leaf(x, path: str, copy: bool = True):
    """``(array, dtype name)``: a host numpy snapshot of one leaf that
    later writes to ``x`` do not reach (tensors are copied, unless
    ``copy=False`` says a host tensor is the caller's own; numpy arrays
    are taken as they are, as the reference takes them), and the dtype
    the manifest gives it. A bf16 tensor becomes its 16-bit words
    (``|V2``) under the name ``"bfloat16"``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=copy)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(BF16_WORDS), "bfloat16"
        try:
            arr = x.numpy()
        except TypeError as e:
            raise TypeError(
                f"checkpoint leaf {path} has dtype {x.dtype}, which numpy "
                f"(and so the npz format) cannot hold") from e
        return arr, str(arr.dtype)
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _leaf_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor of a stored leaf: a ``"bfloat16"`` leaf's 16-bit
    words (``|V2``, or numpy's ``bfloat16`` where a package defines
    it) viewed as bf16, any other leaf as it is."""
    if dtype == "bfloat16":
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(arr)


# -- save ----------------------------------------------------------------------

class _Publish:
    """A sharded save in flight: ``join`` waits for rank 0's writer
    thread, then for every rank at a barrier."""

    def __init__(self, thread):
        self.thread = thread

    def join(self):
        import torch.distributed as dist
        if self.thread is not None:
            self.thread.join()
        dist.barrier()


def _host_leaves(flat, paths, sharded: bool):
    """The host snapshot of every leaf, or of a ``sharded`` state's
    leaves gathered whole: ``(host, writer)``, where only the writer
    (rank 0) holds a snapshot (``host`` is ``None`` elsewhere)."""
    if not sharded:
        return [_host_leaf(x, p) for x, p in zip(flat, paths)], True
    import torch.distributed as dist
    # refuse a dtype npz cannot hold on every rank, before a collective
    for x, p in zip(flat, paths):
        if isinstance(x, torch.Tensor):
            _host_leaf(torch.empty(0, dtype=x.dtype), p)
    writer = dist.get_rank() == 0
    host = []
    for x, p in zip(flat, paths):
        full = gather_to_root(x) if is_dtensor(x) else x
        if writer:      # a gathered leaf is a fresh host tensor
            host.append(_host_leaf(full, p, copy=not is_dtensor(x)))
        del full
    return (host if writer else None), writer


def save_checkpoint(ckpt_dir, step: int, state, *, async_: bool = False,
                    meta: dict | None = None):
    """Serialise ``state`` (a nested structure of tensors and arrays)
    for ``step``. ``meta`` is an optional JSON-serialisable blob stored
    in the manifest (:func:`load_checkpoint_arrays` hands it back). The
    host snapshot happens here, synchronously; with ``async_=True`` the
    write runs on a thread, which is returned for the caller to
    ``join``. Callers passing numpy arrays they mutate in place must
    copy them first.

    A state with DTensor leaves is a collective: every rank of the world
    calls it, rank 0 writes, and every rank returns after the publish
    (with ``async_=True`` every rank gets a handle whose ``join`` waits
    for it)."""
    ckpt_dir = Path(ckpt_dir)
    flat, _, paths = tree_flatten(state)
    sharded = any(is_dtensor(x) for x in flat)
    host, writer = _host_leaves(flat, paths, sharded)
    del flat

    def _write():
        host_leaves = [a for a, _ in host]
        step_dir = ckpt_dir / f"step_{step:06d}"
        tmp_dir = ckpt_dir / f".tmp_step_{step:06d}_{time.time_ns()}"
        tmp_dir.mkdir(parents=True, exist_ok=True)
        manifest = {
            "step": step,
            "leaves": [{"shape": list(a.shape), "dtype": dt}
                       for a, dt in host],
        }
        if meta is not None:
            manifest["meta"] = meta
        (tmp_dir / "manifest.json").write_text(json.dumps(manifest))
        np.savez(tmp_dir / "shard_0.npz",
                 **{f"leaf_{i}": x for i, x in enumerate(host_leaves)})
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp_dir.rename(step_dir)                     # atomic publish
        latest_tmp = ckpt_dir / ".LATEST.tmp"
        latest_tmp.write_text(step_dir.name)
        latest_tmp.rename(ckpt_dir / "LATEST")       # atomic pointer

    thread = None
    if writer:
        if async_:
            thread = threading.Thread(target=_write, daemon=True)
            thread.start()
        else:
            _write()
    if sharded:
        handle = _Publish(thread)
        if async_:
            return handle
        handle.join()
        return None
    return thread


# -- find and load -------------------------------------------------------------

def latest_step(ckpt_dir) -> int | None:
    ptr = Path(ckpt_dir) / "LATEST"
    if not ptr.exists():
        return None
    return int(ptr.read_text().strip().split("_")[-1])


def available_steps(ckpt_dir) -> list[int]:
    """All published step numbers under ``ckpt_dir``, ascending
    (``.tmp_*`` directories of crashed saves are not published; a
    published one may still be damaged, which loading detects)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    steps = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_"):
            try:
                steps.append(int(p.name.split("_")[-1]))
            except ValueError:
                continue
    return sorted(steps)


def _load_step(ckpt_dir: Path, step: int):
    """Read and validate one step; ``CheckpointCorruptError`` on any
    torn, partial or inconsistent state."""
    step_dir = ckpt_dir / f"step_{step:06d}"
    if not step_dir.is_dir():
        raise CheckpointCorruptError(f"{step_dir} does not exist")
    try:
        manifest = json.loads((step_dir / "manifest.json").read_text())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest in {step_dir}: {e}") from e
    try:
        data = np.load(step_dir / "shard_0.npz")
        leaves = [data[f"leaf_{i}"]
                  for i in range(len(manifest["leaves"]))]
    except (OSError, ValueError, KeyError) as e:
        raise CheckpointCorruptError(
            f"unreadable/partial shard in {step_dir}: {e}") from e
    for got, want in zip(leaves, manifest["leaves"]):
        if list(got.shape) != list(want["shape"]):
            raise CheckpointCorruptError(
                f"leaf shape {got.shape} != manifest {want['shape']} "
                f"in {step_dir}")
    return manifest, leaves


def load_checkpoint_arrays(ckpt_dir, *, step: int | None = None,
                           fallback: bool = False):
    """``(step, manifest, leaves)``: host numpy, no device placement.

    ``step=None`` starts from ``LATEST`` (or the newest published step
    when the pointer is missing or stale). ``fallback=True`` walks back
    through older complete saves when the requested or newest one is
    corrupt or partial. Raises ``FileNotFoundError`` when there is no
    checkpoint at all, :class:`CheckpointCorruptError` when the step is
    damaged and fallback is off (or every candidate is damaged)."""
    ckpt_dir = Path(ckpt_dir)
    if step is not None:
        candidates = [step]
        if fallback:
            candidates += [s for s in reversed(available_steps(ckpt_dir))
                           if s < step]
    else:
        steps = available_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        newest = latest_step(ckpt_dir)
        if newest is None or newest not in steps:
            newest = steps[-1]
        candidates = [newest] if not fallback else \
            [newest] + [s for s in reversed(steps) if s != newest]
    last_err: Exception | None = None
    for s in candidates:
        try:
            manifest, leaves = _load_step(ckpt_dir, s)
            return s, manifest, leaves
        except CheckpointCorruptError as e:
            last_err = e
            continue
    raise last_err if last_err is not None else \
        FileNotFoundError(f"no checkpoint under {ckpt_dir}")


def restore_checkpoint(ckpt_dir, like, *, step: int | None = None,
                       fallback: bool = False, device=None,
                       shardings=None):
    """Restore into the structure of ``like`` (tensors, arrays, or
    anything with a ``.shape``); returns ``(state, step)`` with every
    leaf a tensor on ``device`` (``None`` = ``cuda``) in its stored
    dtype (a ``"bfloat16"`` leaf as bf16). ``fallback=True`` drops back
    to the newest complete save when the newest is corrupt or partial.

    ``shardings``: a tree of ``launch.sharding.NamedSharding`` of
    ``like``'s structure; each leaf then comes back as a DTensor over
    this rank's slice of the stored leaf, on that sharding's mesh, which
    need not be the mesh that saved (an elastic restart). Every rank
    reads the files; no collective runs."""
    dev = resolve_device(device)
    step, manifest, leaves = load_checkpoint_arrays(ckpt_dir, step=step,
                                                    fallback=fallback)
    flat_like, treedef, _ = tree_flatten(like)
    if len(leaves) != len(flat_like):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, expected "
            f"{len(flat_like)}")
    for got, want in zip(leaves, flat_like):
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(
                f"checkpoint leaf shape {got.shape} != expected "
                f"{tuple(np.shape(want))}")
    dtypes = [m["dtype"] for m in manifest["leaves"]]
    tensors = (_leaf_tensor(x, dt) for x, dt in zip(leaves, dtypes))
    if shardings is None:
        return tree_unflatten(treedef, [t.to(dev) for t in tensors]), step
    shs = tree_flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"{len(shs)} shardings for {len(leaves)} "
                         f"checkpoint leaves")
    return tree_unflatten(treedef, [
        shard_of(t, sh.mesh, sh.placements, device=dev)
        for t, sh in zip(tensors, shs)]), step
