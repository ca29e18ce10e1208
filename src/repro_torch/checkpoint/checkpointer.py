"""Port of ``repro.checkpoint.checkpointer``: atomic, asynchronous
checkpoints of a tree of tensors, in upstream's layout.

  * atomic: written to ``step_N.tmp/``, then ``os.replace``'d into place,
    so a crash mid-save never corrupts the latest valid checkpoint;
  * async: :meth:`Checkpointer.save` copies every leaf to host memory
    before it returns (the training step then overwrites the tensors in
    place), and a background thread writes the copy; :meth:`wait` joins
    it, and the next save and every restore wait first;
  * bounded retention: the last ``keep`` checkpoints stay.

Layout: ``<dir>/step_<N>/manifest.json`` + ``arrays.npz``, each array
under its ``/``-joined tree path, bfloat16 stored as a uint16 view with
the true dtype in the manifest.  Dict keys, list indices and NamedTuple
field names make the path, so a train state ``{"params", "opt"}`` is
keyed ``params/<path>`` (upstream's keys, letter for letter), ``opt/step``,
``opt/mu/<path>`` and ``opt/nu/<path>``.  (Upstream's key builder gives a
NamedTuple's fields no name, so its ``mu`` and ``nu`` share keys and only
one of them survives ``np.savez``; its ``params/...`` keys read back from
a checkpoint written here.)
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key, leaf) pairs: dict keys sorted, NamedTuple fields and list items
    in order, as JAX walks a pytree."""
    sub = prefix + "/" if prefix else ""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{sub}{k}")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), f"{sub}{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{sub}{i}")]
    return [(prefix, tree)]


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A finished host copy of ``t`` (a copy even of a CPU tensor, which
    the next step may overwrite) and its dtype's name."""
    a = t.detach().to("cpu", copy=True)
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = a.numpy()
    return a, str(a.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        """Copy every leaf to host memory now; write it to disk on a thread
        (or here with ``blocking``)."""
        self.wait()
        flat = [(k,) + _to_host(v) for k, v in _flatten(tree)]

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **{k: a for k, a, _ in flat})
            manifest = {
                "step": step,
                "keys": [k for k, _, _ in flat],
                "shapes": {k: list(a.shape) for k, a, _ in flat},
                "dtypes": {k: dt for k, _, dt in flat},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if blocking:
            _write()
            return

        def _run():
            try:
                _write()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, tree, step: Optional[int] = None):
        """Write checkpoint ``step`` (default: the latest) into the leaves of
        ``tree`` in place, each keeping its device and dtype, and return
        ``tree``.  Every leaf must be in the checkpoint with its shape."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, leaf in _flatten(tree):
                arr = data[key]
                if manifest["dtypes"].get(key) == "bfloat16":
                    src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    src = torch.from_numpy(arr)
                if tuple(src.shape) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch for {key}: checkpoint {tuple(src.shape)} "
                                     f"vs model {tuple(leaf.shape)}")
                leaf.copy_(src)
        return tree
