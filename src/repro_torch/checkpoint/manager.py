"""Fault-tolerant checkpointing: atomic, async, verified (the port of
``repro.checkpoint.manager``).

Layout (one directory per step), byte for byte the reference's, so a
checkpoint written by either package restores in the other:

    <root>/step_000001230/
        tree.json            # leaf keys + per-leaf shape/dtype/CRC32
        leaf_00000.npy ...   # one file per leaf
        aux.json             # caller metadata
    <root>/LATEST            # manifest: step id, written last via atomic rename

A tree is nested dicts and lists whose leaves are torch tensors or numpy
arrays. Leaves are ordered and keyed as ``jax.tree_util.tree_flatten_with_path``
and ``keystr`` order and key them: dict keys sorted, lists in order, keys like
``['head']['counters']`` and ``['sealed'][0]['fills']`` (:func:`flatten`).
Each leaf is written in the dtype it has on the host; callers that must match
the reference's dtypes (``SegmentedStore.checkpoint_tree``) convert first.

Guarantees:
  * atomicity — the step directory is staged as ``.tmp-<step>`` and renamed
    only after every leaf and manifest is fsynced (files and directories); a
    crash mid-save leaves the previous LATEST untouched;
  * integrity — ``tree.json`` records a CRC32 per leaf of the bytes held at
    save time (never of a read-back, so a torn write cannot vouch for itself);
    ``restore`` verifies every leaf and, on corruption, walks back to the
    newest generation that verifies;
  * async — ``save(..., blocking=False)`` copies to host memory on the
    caller's thread and writes on a daemon thread; with a ``supervisor``
    (``engine.supervision.JobSupervisor``) the write gets retries, a
    watchdog and quarantine, and its failures land in ``health()``;
  * retention — the ``keep`` newest checkpoints stay; older ones are removed
    only after a successful save.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import faults

__all__ = ["BackgroundJob", "CheckpointCorruptError", "CheckpointManager", "flatten"]

log = logging.getLogger("repro_torch.checkpoint")

Tree = Any


class CheckpointCorruptError(RuntimeError):
    """A checkpoint generation failed verification (unreadable manifest,
    unreadable or truncated leaf, or a CRC mismatch). ``restore(step=None)``
    walks back one generation on it; an explicitly requested step raises it."""


class BackgroundJob:
    """One unit of work on a daemon thread — the async pattern shared by
    checkpoint writes and segment compaction.

      1. the caller snapshots what the job needs to host memory, on its own
         thread, before constructing the job;
      2. ``fn`` runs on a daemon thread and touches only that snapshot, never
         live state, so no locks are needed;
      3. the caller collects the result on its own thread (:meth:`result`,
         or :meth:`done` then :attr:`value`) and publishes it there.

    An exception raised by ``fn`` is stored and re-raised from :meth:`result`.
    Supervised callers read :attr:`error` / :attr:`value` after :meth:`done`
    and decide on their own thread whether to retry.
    """

    def __init__(self, fn: Callable[[], Any]):
        self._result: Any = None
        self._error: Optional[BaseException] = None

        def run():
            try:
                self._result = fn()
            except BaseException as e:  # re-raised on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def done(self) -> bool:
        """True once ``fn`` has finished (successfully or not)."""
        return not self._thread.is_alive()

    def join(self) -> None:
        """Block until ``fn`` has finished."""
        self._thread.join()

    @property
    def error(self) -> Optional[BaseException]:
        """The stored exception, if ``fn`` failed (valid once :meth:`done`)."""
        return self._error

    @property
    def value(self) -> Any:
        """``fn``'s return value (valid once :meth:`done` with no error)."""
        return self._result

    def result(self) -> Any:
        """Join the worker and return ``fn``'s result (or raise its error)."""
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._result


def flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in the order and with the key strings of
    ``jax.tree_util.tree_flatten_with_path`` + ``keystr``: dict keys sorted,
    list and tuple items in order; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, f"{prefix}[{i}]")
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _unflatten(tree: Tree, leaves: List[Any]) -> Tree:
    """``tree``'s structure with its leaves replaced, in :func:`flatten` order
    (``leaves`` is consumed from the front)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if tree is None:
        return None
    return leaves.pop(0)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 (which ``.npy`` lacks) as its
    uint16 bit pattern, as the reference stores it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    """fsync a directory so the rename or creation of its entries is durable.
    Some filesystems refuse fsync on a directory; that is logged and the
    save goes on, as mature checkpoint writers do."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError as e:
        log.debug("cannot open directory %s for fsync: %s", path, e)
        return
    try:
        os.fsync(fd)
    except OSError as e:
        log.debug("fsync of directory %s refused: %s", path, e)
    finally:
        os.close(fd)


def _as_target(arr: np.ndarray, tgt) -> Any:
    """A restored host array in the target leaf's dtype (and, for a tensor
    target, on its device). Integer dtypes of one width are reinterpreted bit
    for bit (the reference's uint32 words into the port's int32, its u16
    counters into int16); anything else converts by value."""
    if isinstance(tgt, torch.Tensor):
        if tgt.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(tgt.device)
        want = torch.empty((), dtype=tgt.dtype).numpy().dtype
        return torch.from_numpy(_cast(arr, want)).to(tgt.device)
    return _cast(arr, np.asarray(tgt).dtype)


def _cast(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    if (arr.dtype != dtype and arr.dtype.kind in "iu" and dtype.kind in "iu"
            and arr.dtype.itemsize == dtype.itemsize):
        return np.ascontiguousarray(arr).view(dtype).copy()
    return np.array(arr, dtype=dtype)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, supervisor: Any = None):
        self.root = root
        self.keep = keep
        #: optional engine.supervision.JobSupervisor (duck-typed: supervision
        #: imports BackgroundJob from here)
        self.supervisor = supervisor
        os.makedirs(root, exist_ok=True)
        self._pending: Optional[Any] = None  # BackgroundJob | SupervisedJob

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Tree, aux: Optional[Dict] = None, blocking: bool = True):
        """Copy to host memory now; write to disk now or on a worker thread."""
        flat = flatten(tree)
        host_leaves = [_to_host(v) for _, v in flat]
        meta = {
            "step": step,
            "keys": [k for k, _ in flat],
            "shapes": [list(x.shape) for x in host_leaves],
            "dtypes": [str(x.dtype) for x in host_leaves],
            # the CRC of the bytes held now, so restore can tell a faithful
            # file from a torn one however it got torn
            "leaf_crc": [_crc(x) for x in host_leaves],
        }
        # serialize aux on the caller's thread: a non-JSON aux fails here, not
        # at the next save()/wait() from inside the writer
        try:
            aux_json = json.dumps(aux or {})
        except TypeError as e:
            raise TypeError(f"checkpoint aux must be JSON-serializable: {e}") from e
        meta_json = json.dumps(meta)

        def write():
            faults.inject("checkpoint.write")
            tmp = os.path.join(self.root, f".tmp-{step:012d}")
            final = os.path.join(self.root, f"step_{step:012d}")
            if os.path.exists(tmp):  # a retry after a failed attempt: restage
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, arr in enumerate(host_leaves):
                path = os.path.join(tmp, f"leaf_{i:05d}.npy")
                with open(path, "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
                faults.torn_write("checkpoint.leaf", path)
            for name, payload in (("tree.json", meta_json), ("aux.json", aux_json)):
                with open(os.path.join(tmp, name), "w") as f:
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
            _fsync_dir(tmp)  # the files' directory entries, before the rename
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic on POSIX
            _fsync_dir(self.root)  # the rename itself
            latest_tmp = os.path.join(self.root, ".LATEST.tmp")
            with open(latest_tmp, "w") as f:
                f.write(str(step))
                f.flush()
                os.fsync(f.fileno())
            os.rename(latest_tmp, os.path.join(self.root, "LATEST"))
            _fsync_dir(self.root)
            self._gc()

        self.wait()  # one outstanding async save at a time
        if blocking:
            write()
        elif self.supervisor is not None:
            # None while ("checkpoint", ("save",)) is quarantined: the save
            # is skipped and the refusal counted in health()
            self._pending = self.supervisor.submit("checkpoint", ("save",), write)
        else:
            self._pending = BackgroundJob(write)

    def wait(self):
        job = self._pending
        if job is None:
            return
        try:
            if isinstance(job, BackgroundJob):
                job.result()  # unsupervised: re-raise on the caller's thread
            else:
                # supervised: retries happen inside; a terminal failure is
                # recorded in health(), never raised here
                self.supervisor.wait(job)
        finally:
            self._pending = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:012d}"), ignore_errors=True)

    # -- verification -----------------------------------------------------------
    def _read_verified(self, step: int) -> Tuple[Dict, Dict, List[np.ndarray]]:
        """Load and verify one generation: manifest, aux and every leaf, with
        CRC checks. Raises :class:`CheckpointCorruptError` on unreadable or
        mismatching content. Checkpoints without ``leaf_crc`` verify by
        loadability alone."""
        faults.inject("checkpoint.restore")
        src = os.path.join(self.root, f"step_{step:012d}")
        try:
            with open(os.path.join(src, "tree.json")) as f:
                meta = json.load(f)
            with open(os.path.join(src, "aux.json")) as f:
                aux = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(f"step {step}: unreadable manifest: {e}") from e
        crcs = meta.get("leaf_crc")
        arrays: List[np.ndarray] = []
        for i in range(len(meta["keys"])):
            path = os.path.join(src, f"leaf_{i:05d}.npy")
            try:
                arr = np.load(path)
            except Exception as e:  # a truncated or absent .npy raises variously
                raise CheckpointCorruptError(f"step {step}: leaf {i} unreadable: {e}") from e
            if crcs is not None and _crc(arr) != crcs[i]:
                raise CheckpointCorruptError(
                    f"step {step}: leaf {i} CRC mismatch (stored {crcs[i]}, got {_crc(arr)})")
            arrays.append(arr)
        return meta, aux, arrays

    def verify_step(self, step: int) -> bool:
        """Does ``step`` verify end to end?"""
        try:
            self._read_verified(step)
            return True
        except (CheckpointCorruptError, faults.FaultError):
            return False

    def newest_verifying_step(self) -> Optional[int]:
        """Newest retained generation that verifies, the LATEST-pointed one
        tried first; None if nothing verifies."""
        for s in self._candidate_steps():
            if self.verify_step(s):
                return s
        return None

    def resolve_step(self, step: Optional[int] = None) -> Optional[int]:
        """Pin the generation a multi-read restore uses: an explicit step
        passes through; None resolves to the newest verifying generation, so
        aux and arrays read apart land on the same sound checkpoint."""
        if step is not None:
            return step
        return self.newest_verifying_step()

    def _candidate_steps(self) -> List[int]:
        """Restore candidates, most preferred first: the LATEST-pointed step
        (if retained), then the rest newest first."""
        steps = sorted(self.all_steps(), reverse=True)
        path = os.path.join(self.root, "LATEST")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    pointed = int(f.read().strip())
            except (OSError, ValueError):
                pointed = None
            if pointed in steps:
                steps.remove(pointed)
                steps.insert(0, pointed)
        return steps

    # -- restore ----------------------------------------------------------------
    def all_steps(self):
        return sorted(int(name[5:]) for name in os.listdir(self.root)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.root, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            step = int(f.read().strip())
        if not os.path.isdir(os.path.join(self.root, f"step_{step:012d}")):
            # the manifest is ahead of a vanished directory: the newest
            # generation that verifies (the newest on disk may be the one
            # whose write died)
            return self.newest_verifying_step()
        return step

    def load_aux(self, step: Optional[int] = None) -> Dict:
        """A checkpoint's aux metadata, without reading its arrays (callers
        that keep a shape manifest in aux build their target tree from it).
        Pass a step from :meth:`resolve_step` so that aux and arrays come from
        the same verified generation."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        with open(os.path.join(self.root, f"step_{step:012d}", "aux.json")) as f:
            return json.load(f)

    def restore(self, step: Optional[int], target_tree: Tree) -> Tuple[Tree, Dict]:
        """Restore into the structure of ``target_tree``, verifying CRCs.

        ``step=None`` walks back: newest generation first, skipping any that
        fail verification. An explicit ``step`` raises
        :class:`CheckpointCorruptError` on corruption instead. Key or shape
        mismatches are caller bugs and raise ``ValueError``. Each leaf comes
        back as its target leaf is: a tensor of its dtype on its device, or a
        numpy array of its dtype."""
        if step is not None:
            meta, aux, arrays = self._read_verified(step)
            return self._materialize(meta, arrays, target_tree), aux
        candidates = self._candidate_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        last_err: Optional[BaseException] = None
        for s in candidates:
            try:
                meta, aux, arrays = self._read_verified(s)
            except (CheckpointCorruptError, faults.FaultError) as e:
                last_err = e
                continue
            return self._materialize(meta, arrays, target_tree), aux
        raise CheckpointCorruptError(
            f"no generation under {self.root} verifies ({len(candidates)} tried); "
            f"last error: {last_err}")

    def _materialize(self, meta: Dict, arrays: List[np.ndarray], target_tree: Tree) -> Tree:
        flat = flatten(target_tree)
        keys = [k for k, _ in flat]
        if keys != meta["keys"]:
            differ = set(meta["keys"]) ^ set(keys)
            raise ValueError(f"checkpoint/target tree mismatch; differing keys: "
                             f"{sorted(differ)[:8]}")
        leaves = []
        for (key, tgt), arr in zip(flat, arrays):
            if list(arr.shape) != list(tgt.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs target "
                                 f"{tuple(tgt.shape)}")
            leaves.append(_as_target(arr, tgt))
        return _unflatten(target_tree, leaves)
