"""Checkpoint manager: atomic, keep-k, async, restart-safe (counterpart of
``repro.train.checkpoint``).

Layout: <dir>/step_<N>/arrays.npz + tree.json + DONE marker, the
reference's.
 * atomic: written to step_<N>.tmp and renamed; a crash mid-write never
   corrupts the latest checkpoint (restore trusts only DONE markers);
 * async: ``save`` copies the leaves to the host, and a background thread
   writes them, so the train loop waits for the copy alone;
 * keep-k: older complete checkpoints beyond ``keep`` are removed, never
   the newest complete one.
A tree is nested dicts, lists and tuples of tensors (``train.tree``);
bfloat16 leaves are stored as their 16 bits, with each leaf's dtype and
shape in tree.json.  ``restore`` puts each leaf on the device of the
target's leaf.  The port runs on one device, so nothing is resharded.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .tree import leaves, unflatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # -- public ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Copy ``tree``'s leaves to the host (a copy even of CPU leaves, which
        the train loop goes on updating in place) and write them, in the
        background unless ``blocking``."""
        if self._err is not None:
            raise RuntimeError("checkpoint writer died") from self._err
        host = [t.detach().to("cpu", copy=True) for t in leaves(tree)]
        if self._thread is None or blocking:
            self._write(step, host)
        else:
            self._q.put((step, host))

    def restore(self, target: Any, step: Optional[int] = None) -> Tuple[int, Any]:
        """Load ``step`` (default: the latest complete one) into a tree shaped
        as ``target``, each leaf on the device of ``target``'s leaf."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "tree.json")) as f:
            meta = json.load(f)
        like = leaves(target)
        if meta["n_leaves"] != len(like):
            raise ValueError(f"checkpoint {path} holds {meta['n_leaves']} leaves, the "
                             f"target {len(like)}")
        out: List[torch.Tensor] = []
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for i, (t, dtype, shape) in enumerate(zip(like, meta["dtypes"], meta["shapes"])):
                if tuple(shape) != tuple(t.shape) or dtype != str(t.dtype).replace("torch.", ""):
                    raise ValueError(f"checkpoint leaf {i} is {dtype} {shape}, the target's "
                                     f"{t.dtype} {tuple(t.shape)}")
                out.append(_from_numpy(z[f"a{i}"], dtype).to(t.device))
        return step, unflatten(target, out)

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "DONE")):
                    steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def wait(self) -> None:
        """Block until queued async writes are on disk."""
        if self._thread is not None:
            self._q.join()
        if self._err is not None:
            raise RuntimeError("checkpoint writer died") from self._err

    # -- internals -------------------------------------------------------------
    def _worker(self):
        while True:
            item = self._q.get()
            try:
                self._write(*item)
            except BaseException as e:       # surfaced on the next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host: List[torch.Tensor]):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": _to_numpy(t) for i, t in enumerate(host)})
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(host),
                       "dtypes": [str(t.dtype).replace("torch.", "") for t in host],
                       "shapes": [list(t.shape) for t in host]}, f)
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
        os.replace(tmp, final) if not os.path.exists(final) else shutil.rmtree(tmp)
        self._gc()

    def _gc(self):
        done = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.dir, n, "DONE")))
        for s in done[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)
