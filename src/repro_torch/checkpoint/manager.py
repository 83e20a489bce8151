"""Fault-tolerant checkpointing: atomic, async (twin of
``repro.checkpoint.manager``).

Layout per step:  <dir>/step_<n>/arrays.npz + manifest.json, the
reference's.  Protocol: write to `step_<n>.tmp/`, fsync, atomic
`os.replace` to the final name; the oldest steps past `keep` are removed.
A crash mid-write leaves only a `.tmp` dir, which restore ignores: the
previous checkpoint stays valid.

Keys are the state's paths (`repro_torch.utils.tree.flatten_with_paths`).
`save` copies every tensor to the host before it queues the write
(``.cpu()`` waits for the card's stream), so a step that runs later
cannot race the writer thread; bfloat16 leaves are written as float32
(exact) and cast back on restore.  `restore(target=…)` puts each array
on its target leaf's device and dtype; without a target it returns the
arrays as a dict, which is also how a checkpoint of the reference is read
(`repro_torch.convert.train_state_from_reference`).

A sharded state (DTensor leaves, `repro_torch.distributed.sharding`) is
saved whole: every rank calls `save`, each leaf is gathered
(``full_tensor``), and rank 0 alone writes; a blocking save ends on a
barrier, so no rank reads the step before it is published.
`restore(..., shardings=...)` distributes each restored leaf of one or
more dims onto its sharding's mesh and placements, whatever mesh wrote
it (elastic resharding, `repro_torch.distributed.elastic.recover`).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import flatten_with_paths, map_with_paths

log = get_logger("repro.checkpoint")


def _to_host(t: Any) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.detach().full_tensor()
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._queue: "queue.Queue[Optional[Tuple[int, dict, dict]]]" = queue.Queue(2)
        self._async = async_save
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_save:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[Dict[str, Any]] = None,
             *, block: bool = False) -> None:
        if self._error:
            raise RuntimeError("async checkpoint worker failed") from self._error
        host = {k: _to_host(v) for k, v in flatten_with_paths(tree).items()}
        meta = dict(metadata or {})
        meta["step"] = step
        meta["time"] = time.time()
        ranks = dist.is_available() and dist.is_initialized()
        if not ranks or dist.get_rank() == 0:
            if self._async:
                self._queue.put((step, host, meta))
                if block:
                    self._queue.join()
            else:
                self._write(step, host, meta)
        if ranks and (block or not self._async):
            dist.barrier()

    def wait(self) -> None:
        if self._async:
            self._queue.join()
        if self._error:
            raise RuntimeError("async checkpoint worker failed") from self._error

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except BaseException as e:  # surfaced on next save()/wait()
                self._error = e
                log.error("checkpoint write failed: %s", e)
            finally:
                self._queue.task_done()

    def _write(self, step: int, host: Dict[str, np.ndarray],
               meta: Dict[str, Any]) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"keys": sorted(host.keys()), **meta}, f)
        # fsync the manifest so the rename publishes complete data.
        with open(os.path.join(tmp, "manifest.json")) as f:
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        log.info("checkpoint step %d written (%d arrays)", step, len(host))

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, target: Any = None,
                shardings: Optional[Dict[str, Any]] = None
                ) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``target`` (a tree of tensors or
        numpy arrays): each array onto its target leaf's device and dtype,
        in a new tree; with ``shardings`` ({path: NamedSharding}), each
        leaf of one or more dims a DTensor with its sharding's placements.
        Without a target, the arrays as a dict."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = dict(data)
        if target is None:
            return arrays, meta
        missing = set(flatten_with_paths(target)) - set(arrays)
        if missing:
            raise KeyError(f"checkpoint missing arrays: {sorted(missing)[:5]}...")

        def put(key: str, leaf: Any) -> Any:
            if isinstance(leaf, torch.Tensor):
                t = torch.from_numpy(arrays[key]).to(device=leaf.device,
                                                     dtype=leaf.dtype)
                sh = (shardings or {}).get(key)
                if sh is None or t.dim() == 0:
                    return t
                from torch.distributed.tensor import distribute_tensor
                return distribute_tensor(t, sh.mesh, sh.placements)
            return arrays[key].astype(np.asarray(leaf).dtype)

        return map_with_paths(put, target), meta

    def close(self) -> None:
        if self._async and self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=30)
