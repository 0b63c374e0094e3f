"""Atomic, resumable, *verifiable* checkpoints, in the reference's format 2.

Layout: <dir>/step_<N>/   manifest.json  (treedef, per-leaf shape/dtype/crc32,
                                          extras)
                          arr_<i>.npy    (one file per leaf)
        <dir>/step_<N>.tmp.*  while writing; os.replace makes publication
        atomic, so a crash mid-save never corrupts the latest checkpoint.
        Orphaned tmp dirs left by hard crashes are GC'd on init and after
        every save.

A checkpoint written by either package restores in the other: the leaves are
flattened in the reference's order (dict keys sorted, lists and tuples in
order), each saved as the same ``.npy`` bytes, and the manifest's
``"treedef"`` is the string JAX prints for the same tree (``PyTreeDef({'a':
*, 'b': [*, *], 'c': (*, *)})``), rendered here without JAX.

Hardening:

* the manifest records per-leaf CRC32 checksums plus shape/dtype, and
  ``restore`` re-verifies every leaf while loading — a truncated/bit-flipped
  ``arr_*.npy`` or a mangled manifest surfaces as a :class:`CheckpointError`
  naming the step and leaf instead of a silently wrong tree;
* ``restore(step=None)`` walks checkpoints newest-first and returns the
  newest *verifiable* one, so a corrupt latest checkpoint costs one
  retention slot, not the run;
* ``save(..., background=True)`` snapshots the tree to host memory on the
  caller's thread (a copy: the trainer writes its store in place at the next
  step), then writes + publishes on a single background writer thread — the
  training hot path only pays the device→host copy. Saves serialize (each
  waits for the previous one), and a background failure re-raises at the
  next ``save``/``wait``/``close``. Background and synchronous saves share
  one write path, so their bytes are identical.

Saves are whole-tree, as in the reference. Under distributed LMC every rank
holds row blocks of the stores (``repro_torch.dist``): :func:`unshard`
gathers them into the whole tree that rank 0 saves, and :func:`reshard`
gives each rank of any world size its blocks of a restored tree.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import zlib
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.collectives import all_gather_blocks
from repro_torch.dist.sharding import (GridAxes, dp_axis_size, dp_rank,
                                       take_block)
from repro_torch.optim.optimizers import tree_leaves, tree_map

MANIFEST_FORMAT = 2   # 1 = pre-checksum manifests (still restorable)


class CheckpointError(RuntimeError):
    """A checkpoint is missing, structurally wrong, or fails verification."""


def crc32_array(arr: np.ndarray) -> int:
    """crc32 of an array's contiguous bytes — the manifest integrity idiom.

    The serving store's per-row integrity ledger (serve/policy.py
    ``StoreIntegrity``) records and verifies rows with this, so "corrupt"
    means the same thing for a checkpoint leaf and a cached embedding row.
    """
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


_crc = crc32_array


# ------------------------------------------------------------ tree structure
def treedef_str(tree) -> str:
    """The string ``str(jax.tree.structure(tree))`` gives for a tree of
    dicts, lists, tuples and leaves (the reference's manifest ``treedef``)."""
    def render(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {render(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(render(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(render(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "None" if t is None else "*"
    return f"PyTreeDef({render(tree)})"


def tree_unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of
    ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)
    return build(like)


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf, never a view of memory the caller may write
    next (``Tensor.numpy()`` of a CPU tensor shares its storage)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    """One checkpoint directory: atomic saves (sync or on one writer
    thread), retention, and verified restores."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 fault_hook: Optional[Callable[[int, str], None]] = None):
        """Open (creating if needed) a checkpoint directory.

        Args:
            directory: checkpoint root; one ``step_<N>/`` dir per step.
            keep: retention — older steps beyond the newest ``keep`` are GC'd.
            fault_hook: test-only injection point, called as
                ``hook(step, phase)`` before each leaf write
                (``phase="leaf_<i>"``) and before manifest publication
                (``"manifest"``); raising aborts the save, cleans the tmp
                dir and leaves the previous checkpoint untouched
                (``train.health.FaultPlan.ckpt_hook`` plugs in here).
        """
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.fault_hook = fault_hook
        # per save, newest last: its step and seconds by part, "snapshot"
        # (the caller's thread), "crc32" and "np_save" (added by the write,
        # on whichever thread ran it, once it has published)
        self.times: deque = deque(maxlen=64)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        self._inflight_tmp: set = set()
        self._gc_orphans()   # tmp dirs left behind by a hard crash

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extras: Optional[dict] = None, *,
             background: bool = False) -> Path:
        """Write an atomic checkpoint; returns its (eventual) directory.

        ``background=True`` snapshots the leaves to host numpy here (a
        device→host copy) and hands the file writes + atomic publication to
        a single writer thread, keeping disk latency off the training hot
        path. Saves serialize: a new save (or ``wait``/``restore``) first
        joins the previous one and re-raises its failure, so errors are
        never silently dropped. Both paths produce byte-identical files.
        """
        self.wait()   # serialize saves; surface a prior background failure
        t0 = time.perf_counter()
        host = [_to_host(leaf) for leaf in tree_leaves(tree)]
        times = {"step": step, "snapshot": time.perf_counter() - t0}
        self.times.append(times)
        treedef = treedef_str(tree)
        if not background:
            return self._write(step, host, treedef, extras or {}, times)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="ckpt-writer")
        self._pending = self._pool.submit(self._write, step, host, treedef,
                                          extras or {}, times)
        return self.dir / f"step_{step:010d}"

    def wait(self) -> None:
        """Join the in-flight background save, re-raising its failure."""
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def close(self) -> None:
        """Join pending saves and stop the writer thread (idempotent)."""
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def _write(self, step: int, host_leaves: list, treedef: str,
               extras: dict, times: dict) -> Path:
        """Synchronous write path shared by sync and background saves."""
        final = self.dir / f"step_{step:010d}"
        tmp = Path(tempfile.mkdtemp(prefix=f"step_{step:010d}.tmp.",
                                    dir=self.dir))
        self._inflight_tmp.add(tmp.name)
        crc_s = save_s = 0.0
        try:
            leaf_meta = []
            for i, leaf in enumerate(host_leaves):
                if self.fault_hook is not None:
                    self.fault_hook(step, f"leaf_{i}")
                t0 = time.perf_counter()
                np.save(tmp / f"arr_{i}.npy", leaf)
                t1 = time.perf_counter()
                leaf_meta.append({"shape": list(leaf.shape),
                                  "dtype": str(leaf.dtype),
                                  "crc32": _crc(leaf)})
                crc_s += time.perf_counter() - t1
                save_s += t1 - t0
            manifest = {
                "format": MANIFEST_FORMAT,
                "step": step,
                "num_leaves": len(host_leaves),
                "treedef": treedef,
                "leaves": leaf_meta,
                "extras": extras,
            }
            if self.fault_hook is not None:
                self.fault_hook(step, "manifest")
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        finally:
            self._inflight_tmp.discard(tmp.name)
        times.update(crc32=crc_s, np_save=save_s)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
        self._gc_orphans()

    def _gc_orphans(self) -> None:
        """Remove ``step_*.tmp.*`` dirs not owned by an in-flight save."""
        for p in self.dir.iterdir():
            if (p.is_dir() and p.name.startswith("step_")
                    and ".tmp." in p.name
                    and p.name not in self._inflight_tmp):
                shutil.rmtree(p, ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        """Published steps (with a manifest), oldest first."""
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and \
                    ".tmp." not in p.name and \
                    (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest published step, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> bool:
        """True iff checkpoint ``step`` exists and all leaves pass
        manifest shape/dtype/crc32 verification."""
        self.wait()
        try:
            self._load_verified(step, None, None)
        except CheckpointError:
            return False
        return True

    def restore(self, target_tree: Any, step: Optional[int] = None
                ) -> tuple[Any, dict, int]:
        """Restore into the *structure* of target_tree (its leaves are only
        used for the treedef). Returns (tree of numpy arrays, extras, step).

        With ``step=None``, walks checkpoints newest-first and restores the
        newest one that passes verification — a corrupt/truncated latest
        checkpoint is skipped (with a notice on stdout), not fatal. With an
        explicit ``step``, verification failure raises
        :class:`CheckpointError` naming the step and the offending leaf.
        """
        self.wait()   # a pending background save must be visible (or fail)
        num_leaves = len(tree_leaves(target_tree))
        treedef = treedef_str(target_tree)
        if step is not None:
            leaves, manifest = self._load_verified(step, num_leaves, treedef)
            return (tree_unflatten(target_tree, leaves), manifest["extras"],
                    step)
        steps = self.all_steps()
        if not steps:
            raise CheckpointError(f"no checkpoints in {self.dir}")
        failures = []
        for s in reversed(steps):
            try:
                leaves, manifest = self._load_verified(s, num_leaves, treedef)
            except CheckpointError as e:
                failures.append(str(e))
                continue
            if failures:
                print(f"checkpoint: fell back to step {s} after skipping "
                      f"{len(failures)} unverifiable checkpoint(s): "
                      + " | ".join(failures), flush=True)
            return (tree_unflatten(target_tree, leaves), manifest["extras"],
                    s)
        raise CheckpointError(
            f"no verifiable checkpoint in {self.dir}: " + " | ".join(failures))

    def _load_verified(self, step: int, num_target_leaves: Optional[int],
                       target_treedef: Optional[str]) -> tuple[list, dict]:
        """Load + verify one checkpoint's leaves; CheckpointError on any
        missing/truncated/corrupt leaf or structural mismatch."""
        path = self.dir / f"step_{step:010d}"
        if not path.is_dir():
            raise CheckpointError(f"checkpoint step {step} not found "
                                  f"({path})")
        try:
            manifest = json.loads((path / "manifest.json").read_text())
        except FileNotFoundError:
            raise CheckpointError(
                f"checkpoint step {step}: manifest.json missing") from None
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointError(
                f"checkpoint step {step}: unreadable manifest.json "
                f"({e})") from None
        n = manifest.get("num_leaves")
        if not isinstance(n, int) or n < 0:
            raise CheckpointError(
                f"checkpoint step {step}: invalid num_leaves {n!r}")
        if num_target_leaves is not None and n != num_target_leaves:
            raise CheckpointError(
                f"checkpoint step {step} holds {n} leaves but the target "
                f"tree expects {num_target_leaves} — wrong tree structure?")
        if target_treedef is not None and \
                manifest.get("treedef") not in (None, target_treedef):
            raise CheckpointError(
                f"checkpoint step {step}: tree structure mismatch "
                f"(saved {manifest.get('treedef')!r}, "
                f"target {target_treedef!r})")
        leaf_meta = manifest.get("leaves")   # absent in format-1 manifests
        if leaf_meta is not None and len(leaf_meta) != n:
            raise CheckpointError(
                f"checkpoint step {step}: manifest lists {len(leaf_meta)} "
                f"leaf records for num_leaves={n}")
        leaves = []
        for i in range(n):
            f = path / f"arr_{i}.npy"
            if not f.exists():
                raise CheckpointError(
                    f"checkpoint step {step}: missing leaf file {f.name} "
                    f"(have {n} leaves in the manifest)")
            try:
                arr = np.load(f)
            except Exception as e:   # truncated/corrupt npy headers vary
                raise CheckpointError(
                    f"checkpoint step {step}: leaf {f.name} unreadable "
                    f"(truncated?): {e}") from None
            if leaf_meta is not None:
                m = leaf_meta[i]
                if list(arr.shape) != list(m["shape"]) or \
                        str(arr.dtype) != m["dtype"]:
                    raise CheckpointError(
                        f"checkpoint step {step}: leaf {f.name} is "
                        f"{arr.dtype}{list(arr.shape)}, manifest says "
                        f"{m['dtype']}{m['shape']}")
                if _crc(arr) != m["crc32"]:
                    raise CheckpointError(
                        f"checkpoint step {step}: leaf {f.name} checksum "
                        f"mismatch (corrupt data)")
            leaves.append(arr)
        return leaves, manifest


def reshard(tree: Any, placement: Any, *, group=None, model_group=None,
            device=None) -> Any:
    """This rank's share of a whole (restored) tree, on ``device`` (None:
    the card): its row block of every row-blocked leaf and the whole of
    every replicated one, each a fresh tensor.

    ``placement`` has the structure of ``tree`` with a leaf's node axis
    (``int``) where it is row-blocked and ``None`` where it is replicated
    (``repro_torch.dist.lmc_placement``). The blocks follow ``group``'s world
    size and this process's rank, whatever the world that saved the tree:
    the restore path after the device count changed. A
    :class:`~repro_torch.dist.sharding.GridAxes` leaf is also cut into the
    feature block of this rank in ``model_group`` (whole without one).
    Leaves may be numpy arrays (``CheckpointManager.restore``) or tensors.
    """
    dev = resolve_device(device)
    world, rank = dp_axis_size(group), dp_rank(group)
    m_world, m_rank = dp_axis_size(model_group), dp_rank(model_group)

    def one(leaf, axis):
        if leaf is None:
            return None
        t = leaf if isinstance(leaf, torch.Tensor) \
            else torch.from_numpy(np.asarray(leaf))
        return take_block(t, axis, world, rank, m_world,
                          m_rank).to(dev, copy=True)

    return tree_map(one, tree, placement)


def unshard(tree: Any, placement: Any, num_nodes: int, *,
            group=None, model_group=None,
            num_features: Optional[int] = None) -> Any:
    """The whole tree from every rank's share: each row-blocked leaf of
    ``num_nodes`` rows gathered from the ranks of ``group`` (every rank
    must call it and every rank gets the whole), replicated leaves as they
    are. A :class:`~repro_torch.dist.sharding.GridAxes` leaf first gathers
    its ``num_features`` features within ``model_group``, then its rows
    within ``group``. The inverse of :func:`reshard`; rank 0 then saves the
    result."""
    if model_group is not None and num_features is None:
        raise ValueError("unshard over a feature group needs num_features")

    def one(leaf, axis):
        if leaf is None or axis is None:
            return leaf
        if isinstance(axis, GridAxes):
            if model_group is not None:
                leaf = all_gather_blocks(leaf, num_features, model_group,
                                         axis.feature)
            axis = axis.row
        return all_gather_blocks(leaf, num_nodes, group, axis)

    return tree_map(one, tree, placement)
