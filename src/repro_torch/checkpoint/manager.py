"""Fault-tolerant checkpointing: atomic, versioned, device-agnostic (the
counterpart of ``repro.checkpoint.manager``, on its on-disk layout).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json``, written into
``step_<n>.tmp`` and moved into place with ``os.replace`` (atomic on
POSIX): a process that dies mid-write leaves a ``.tmp`` directory, never
a half-valid checkpoint.  ``restore_latest`` walks the steps newest first
and skips unreadable ones (a corrupt tail).

A tree is a tensor, or a dict, list, tuple, NamedTuple or dataclass of
trees (``None`` holds nothing).  Its leaves are stored as host numpy
arrays under their path names (``['state'].W``); bf16 tensors are
widened to f32 and their dtype recorded.  A restore matches leaves BY
NAME into a template of the same structure and puts each on ``device``
(the template leaf's device when None) in the template leaf's dtype.

``save(..., blocking=False)`` writes on a background thread from a host
snapshot taken in the call; an error there is raised again from the next
:meth:`CheckpointManager.wait` or :meth:`CheckpointManager.save`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import warnings
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

logger = logging.getLogger(__name__)

# Manifest schema: 2 adds "schema_version" and restores leaves BY NAME,
# defaulting template leaves absent from the checkpoint (a state that grew
# a field since it was written).
SCHEMA_VERSION = 2


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """``[(path suffix, child)]`` of a container node; None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _map_leaves(tree, fn: Callable[[str, Any], Any], path: str = ""):
    """The tree with every leaf replaced by ``fn(name, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    new = [_map_leaves(v, fn, path + suffix) for suffix, v in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), new))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*new)
    if isinstance(tree, (list, tuple)):
        return type(tree)(new)
    return dataclasses.replace(
        tree, **{f.name: v for f, v in zip(dataclasses.fields(tree), new)}
    )


def _leaves_with_names(tree) -> Tuple[List[str], List[Any]]:
    names, leaves = [], []

    def take(name, leaf):
        names.append(name)
        leaves.append(leaf)
        return leaf

    _map_leaves(tree, take)
    return names, leaves


def _host(leaf):
    """``(numpy array, dtype name)`` of a leaf, bf16 widened to f32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class _HostLeaf:
    """A leaf's host copy and its dtype name, taken before an async write."""

    def __init__(self, leaf):
        self.array, self.dtype = _host(leaf)


def _snapshot(tree: Tree) -> Tree:
    """The tree with every leaf a host copy: safe to write while the
    caller's tensors change."""
    return _map_leaves(tree, lambda _, leaf: _HostLeaf(leaf))


def save_pytree(tree: Tree, directory: str, step: int, extra: Optional[dict] = None) -> str:
    """Atomically write one checkpoint; returns its final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    names, leaves = _leaves_with_names(tree)
    arrays, dtypes = {}, {}
    for i, leaf in enumerate(leaves):
        host = leaf if isinstance(leaf, _HostLeaf) else _HostLeaf(leaf)
        arr, dtype = host.array, host.dtype
        arrays[f"a{i}"] = arr
        dtypes[f"a{i}"] = dtype
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "names": names,
        "count": len(names),
        "dtypes": dtypes,
        "extra": extra or {},
        "schema_version": SCHEMA_VERSION,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def restore_pytree(template: Tree, path: str, device=None) -> Tree:
    """Restore into the structure of ``template``, every tensor leaf on
    ``device`` (the template leaf's device when None).

    Leaves are matched BY NAME.  A template leaf missing from the
    checkpoint keeps its template value, with a warning (a schema
    migration); a checkpoint leaf with no home in the template is a
    ``ValueError``: dropping saved state silently is never safe.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    names, _ = _leaves_with_names(template)
    saved_index = {name: i for i, name in enumerate(manifest["names"])}
    unknown = [n for n in manifest["names"] if n not in set(names)]
    if unknown:
        raise ValueError(
            "checkpoint/template structure mismatch: checkpoint leaves "
            f"{unknown[:5]} have no home in the template "
            f"({len(manifest['names'])} saved vs {len(names)} template leaves)"
        )
    missing = [n for n in names if n not in saved_index]
    if missing:
        warnings.warn(
            f"checkpoint at {path} (schema_version="
            f"{manifest.get('schema_version', 1)}) lacks "
            f"{len(missing)} template leaves {missing[:5]} — defaulting "
            "them from the template (schema migration)",
            stacklevel=2,
        )

    def restore(name, tmpl):
        if name not in saved_index:
            return tmpl
        arr = data[f"a{saved_index[name]}"]
        if isinstance(tmpl, torch.Tensor):
            return torch.as_tensor(arr).to(
                dtype=tmpl.dtype, device=tmpl.device if device is None else device
            )
        if isinstance(tmpl, np.ndarray):
            return arr.astype(tmpl.dtype)
        return torch.as_tensor(arr, device=device)

    return _map_leaves(template, restore)


class CheckpointManager:
    """Versioned checkpoints with retention, resume and async writes.

    * An exception inside a background ``save(..., blocking=False)`` does
      not vanish: it is raised again from the next :meth:`wait` or
      :meth:`save`, so a failed write never passes for a committed one.
    * :meth:`restore_latest` records every step it had to skip in
      :attr:`last_skipped` (``[(step, reason)]``, newest first; logged).
    * Retention is observable: the steps the last garbage collection
      deleted are in :attr:`last_deleted`, their running count in
      :attr:`deleted_total`.

    ``keep_last`` (or its older name ``keep``; ``keep_last`` wins) is how
    many committed steps survive a save; None keeps every step.
    """

    def __init__(self, directory: str, keep: Optional[int] = 3, *,
                 keep_last: Optional[int] = None):
        self.directory = directory
        self.keep = keep_last if keep_last is not None else keep
        if self.keep is not None and self.keep < 1:
            raise ValueError(
                f"keep_last must be >= 1 (or None for unbounded), got {self.keep}"
            )
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        self.last_skipped: list = []
        self.last_deleted: list = []
        self.deleted_total: int = 0

    # -- writing ----------------------------------------------------------
    def save(self, tree: Tree, step: int, *, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        tree = _snapshot(tree)  # host copies before the caller moves on

        def work():
            try:
                save_pytree(tree, self.directory, step, extra)
                self._gc()
            except BaseException as exc:  # raised by the next wait()/save()
                self._async_error = exc

        if blocking:
            self._raise_pending()
            save_pytree(tree, self.directory, step, extra)
            self._gc()
        else:
            self.wait()  # joins the previous write and raises its failure
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._async_error is not None:
            exc, self._async_error = self._async_error, None
            raise RuntimeError(
                "async checkpoint save failed (the checkpoint was NOT committed)"
            ) from exc

    # -- reading ----------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def restore_latest(self, template: Tree, device=None):
        """``(step, tree, extra)`` of the newest restorable checkpoint, or
        None; every step skipped on the way is in :attr:`last_skipped`."""
        self.wait()
        self.last_skipped = []
        for step in reversed(self.steps()):
            path = os.path.join(self.directory, f"step_{step:08d}")
            try:
                tree = restore_pytree(template, path, device)
                with open(os.path.join(path, "manifest.json")) as f:
                    extra = json.load(f).get("extra", {})
                return step, tree, extra
            except Exception as exc:  # corrupt or incomplete: try the one before
                reason = f"{type(exc).__name__}: {exc}"
                self.last_skipped.append((step, reason))
                logger.warning("skipping unreadable checkpoint step %d at %s (%s)",
                               step, path, reason)
        return None

    def _gc(self) -> None:
        if self.keep is None:
            return
        deleted = []
        for step in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{step:08d}"),
                          ignore_errors=True)
            deleted.append(step)
        if deleted:
            self.last_deleted = deleted
            self.deleted_total += len(deleted)
            logger.info("checkpoint GC at %s deleted %d step(s) %s (keep_last=%d)",
                        self.directory, len(deleted), deleted, self.keep)
