"""Fault-tolerant checkpointing on PyTorch: atomic, async.

Ported from ``repro.checkpoint.manager``, with the same on-disk layout (one
directory per step), so a directory written by either package loads in the
other:

    <root>/step_00000420.tmp/...    (written first)
    <root>/step_00000420/           (atomic rename on completion)
        manifest.json               {step, extra, leaves: [{path, file,
                                     dtype, shape}]}
        leaf_00000.npy ...          (one file per leaf, raw)

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars; a model's :class:`~repro_torch.models.base.ParamTree`
walks as the dict it was built from and an ``nn.ModuleList`` as a list.
Leaves are numbered and their paths spelled as JAX's
``tree_flatten_with_path`` does (dict keys sorted, ``['key']`` for a dict
entry, ``[i]`` for a sequence element, ``/`` between levels; ``None`` is an
empty subtree), so a ParamTree's block weight is
``['blocks']/[0]/['mix']/['wq']``.  bfloat16, which ``.npy`` cannot hold,
is stored as its uint16 bits under the dtype tag ``"bfloat16"`` and loads
back as a ``torch.bfloat16`` tensor.

Atomicity = write-to-tmp + rename; a crash mid-save leaves a ``.tmp`` dir
that is ignored and swept on construction and before every save.  Async
mode hands the host copies to a writer thread so the caller continues;
``wait()`` joins before the next save or exit.  ``restore_into`` writes a
checkpoint into a live tree's tensors in place, leaf by leaf, where
``restore`` returns new ones: a trainer that updates its state in place
keeps one copy of it on the card, and whoever holds its parameters sees the
restored values.  ``save`` and ``wait`` may be called from several
threads (the async delivery engine's flusher snapshots between rounds
while ``snapshot_now`` saves from a caller): a lock orders them, where the
reference's manager would join a writer another thread has not started
yet.  Restore onto other shardings (the reference's
``shardings=``) is not ported yet: it is ROADMAP item 9d, on the meshes of
:mod:`repro_torch.launch.mesh`.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from ..models.base import ParamTree

__all__ = ["CheckpointManager", "tree_leaves"]


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's flattening order with its path spelling."""
    if tree is None:
        return []
    if isinstance(tree, (dict, ParamTree)):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree.keys())]
    elif isinstance(tree, (list, tuple, nn.ModuleList)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, sub in items:
        out.extend(_flatten_with_paths(sub, prefix + (key,)))
    return out


def _unflatten(like: Any, leaves) -> Any:
    """Rebuild ``like``'s structure from ``leaves`` (an iterator, consumed in
    :func:`_flatten_with_paths`'s order)."""
    if like is None:
        return None
    if isinstance(like, (dict, ParamTree)):
        rebuilt = {k: _unflatten(like[k], leaves) for k in sorted(like.keys())}
        out = {k: rebuilt[k] for k in like.keys()}
        return ParamTree(out) if isinstance(like, ParamTree) else out
    if isinstance(like, nn.ModuleList):
        return nn.ModuleList(_unflatten(v, leaves) for v in like)
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the order a checkpoint numbers them."""
    return [leaf for _, leaf in _flatten_with_paths(tree)]


def _to_host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as the array to write and its manifest dtype tag."""
    if isinstance(leaf, torch.Tensor):
        # A copy: tensors are updated in place (an optimizer step) while
        # the async writer may still be reading.
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_disk(path: Path, dtype: str):
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


class CheckpointManager:
    def __init__(self, root: str | Path, keep: int = 3, async_save: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        # Orders save() and wait() across threads: held from joining the
        # previous writer to starting (or, sync, finishing) the next.
        self._lock = threading.Lock()
        self._gc_tmp()

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        # Tensors are fetched to the host synchronously; numpy leaves are
        # written as they are, as the reference writes its arrays.
        flat = _flatten_with_paths(tree)
        paths = [p for p, _ in flat]
        hosted = [_to_host(leaf) for _, leaf in flat]
        leaves = [a for a, _ in hosted]
        dtypes = [d for _, d in hosted]
        with self._lock:
            self._join()
            # Sweep stale .tmp dirs on every save, not only at construction:
            # a long-lived server that crashes mid-save (or has its writer
            # killed) otherwise accumulates them forever.  Safe here — the
            # join above finished any in-flight writer, so no live .tmp
            # exists.
            self._gc_tmp()
            if not self.async_save:
                self._write(step, paths, leaves, dtypes, extra or {})
                return
            # daemon=False explicitly: daemon-ness is inherited from the
            # *creating* thread, and the delivery engine's flusher is a
            # daemon — an inherited daemon writer would be killed mid-write
            # at interpreter exit, stranding a .tmp dir.
            self._thread = threading.Thread(
                target=self._write,
                args=(step, paths, leaves, dtypes, extra or {}),
                daemon=False,
            )
            self._thread.start()

    def _write(self, step: int, paths, leaves, dtypes, extra: dict) -> None:
        final = self.root / f"step_{step:08d}"
        tmp = self.root / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "extra": extra,
            "leaves": [
                {"path": p, "file": f"leaf_{i:05d}.npy",
                 "dtype": d, "shape": list(leaf.shape)}
                for i, (p, leaf, d) in enumerate(zip(paths, leaves, dtypes))
            ],
        }
        for i, leaf in enumerate(leaves):
            np.save(tmp / f"leaf_{i:05d}.npy", leaf)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._retain()

    def wait(self) -> None:
        with self._lock:
            self._join()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.root.glob("step_*")
            if not p.name.endswith(".tmp") and (p / "manifest.json").exists()
        )
        return steps[-1] if steps else None

    def load(self, step: int | None = None) -> tuple[dict[str, Any], dict]:
        """Structure-free restore: load a step's leaves keyed by their
        manifest path, plus the ``extra`` dict.  Unlike :meth:`restore` this
        needs no ``like`` tree — the delivery-engine snapshots carry their
        own structure in ``extra`` and store arrays under flat string keys.
        Leaves are numpy arrays, bfloat16 ones ``torch.bfloat16`` tensors.
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        arrays: dict[str, Any] = {}
        for e in manifest["leaves"]:
            p = e["path"]
            # a flat {name: array} dict flattens to path "['name']" — unwrap
            if p.startswith("['") and p.endswith("']"):
                p = p[2:-2]
            arrays[p] = _from_disk(d / e["file"], e["dtype"])
        return arrays, manifest["extra"]

    def restore(
        self, step: int, like: Any, shardings: Any | None = None
    ) -> tuple[Any, dict]:
        """Load ``step`` into the structure of ``like``.  A tensor leaf of
        ``like`` comes back as a tensor on its device, any other leaf as a
        numpy array (bfloat16 always as a tensor)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore onto shardings is not ported yet (ROADMAP item "
                "9d)"
            )
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = []
        for p, ref in _flatten_with_paths(like):
            e = by_path[p]
            arr = _from_disk(d / e["file"], e["dtype"])
            if list(arr.shape) != list(np.shape(ref)):
                raise ValueError(
                    f"checkpoint leaf {p} has shape {list(arr.shape)}, "
                    f"the tree to restore into {list(np.shape(ref))}"
                )
            if isinstance(ref, torch.Tensor):
                if isinstance(arr, np.ndarray):
                    arr = torch.from_numpy(arr)
                arr = arr.to(ref.device)
            out.append(arr)
        return _unflatten(like, iter(out)), manifest["extra"]

    @torch.no_grad()
    def restore_into(self, step: int, tree: Any) -> dict:
        """Write ``step`` into ``tree``'s own tensors, in place, one leaf at
        a time (disk -> host -> ``copy_`` into the leaf), and return the
        ``extra`` dict.  Every leaf of ``tree`` must be a tensor of the
        checkpoint leaf's shape and dtype; the tensors keep their storage
        (``data_ptr``), so the card never holds a second copy of the tree
        and every reference to a leaf sees the restored values."""
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {e["path"]: e for e in manifest["leaves"]}
        for p, leaf in _flatten_with_paths(tree):
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"leaf {p} is a {type(leaf).__name__}, not a "
                                f"tensor: it cannot be restored in place")
            e = by_path[p]
            arr = _from_disk(d / e["file"], e["dtype"])
            src = torch.from_numpy(arr) if isinstance(arr, np.ndarray) else arr
            if src.shape != leaf.shape or src.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint leaf {p} is {src.dtype} {list(src.shape)}, "
                    f"the tree's {leaf.dtype} {list(leaf.shape)}"
                )
            leaf.copy_(src)
        return manifest["extra"]

    # ------------------------------------------------------------ plumbing
    def _retain(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.root.glob("step_*")
            if not p.name.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    def _gc_tmp(self) -> None:
        for p in self.root.glob("step_*.tmp"):
            shutil.rmtree(p, ignore_errors=True)
