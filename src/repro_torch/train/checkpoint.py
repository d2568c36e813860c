"""Checkpointing: atomic, resumable, async-capable tree snapshots.

Port of ``repro.train.checkpoint`` (``src/repro/train/checkpoint.py``),
with the same on-disk layout, so a checkpoint written by either package
restores in the other:

    <dir>/step_000123/
        manifest.json        # treedef, shapes, dtypes, user metadata
        arrays.npz           # flat leaves keyed by index
    <dir>/LATEST             # text file: last *committed* step

Write protocol: serialize to ``step_X.tmp``, then ``os.replace`` -- a
crashed writer never corrupts the committed checkpoint.  ``AsyncSaver``
copies tensors off the device on the caller thread and serializes on a
background thread.

**Leaf order.**  The reference flattens with ``jax.tree.flatten``:
dicts in sorted-key order (an ``OrderedDict`` in insertion order),
lists, tuples and named tuples in order, ``None`` is no leaf, anything
else (a tensor, an array, a scalar) is one leaf.  :func:`flatten` gives
the same order, and ``arrays.npz`` keys the leaves ``"0"``, ``"1"``, ...
in it.  The ``treedef`` string of the manifest is informational; no
``restore`` parses it.

**Device.**  :func:`restore` places every leaf whose template has a
dtype on ``device=`` as a torch tensor (default ``"cuda"``, which needs
a card); a template leaf without a dtype (a Python scalar) comes back
as the stored numpy array, as in the reference.

**bfloat16** leaves are written as the reference writes them: an npy
member whose header says ``'<V2'`` (two raw bytes an element, as numpy
describes ml_dtypes' bfloat16) over the value's bits, and
``"bfloat16"`` in the manifest's ``dtypes``.  :func:`restore` views
such a member's two-byte payload as bfloat16, bit for bit.  (The
reference's own ``restore`` cannot read these files: its
``astype(bfloat16)`` of a void array raises ``No cast function
available``.)

Cross-process contract (the fleet's ``DirTransport`` rides it):

* Readers racing :func:`gc_old` get a typed :class:`SnapshotGoneError`
  when a ``step_*`` dir vanishes between the ``LATEST`` read and the
  array read; the caller retries against the new ``LATEST``.
* :func:`gc_old` never deletes the step ``LATEST`` names.
* A torn or truncated payload raises :class:`CheckpointCorruptError`
  naming the step.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import threading
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import resolve_device

#: The npy header's dtype of a bfloat16 leaf, as numpy writes
#: ml_dtypes' bfloat16 (``dtype.str``); numpy reads it back as void.
_BF16_DESCR = "<V2"


class SnapshotGoneError(FileNotFoundError):
    """A committed ``step_*`` dir vanished under the reader (the
    gc race): retry against the new ``LATEST``."""

    def __init__(self, path: str, step: int, detail: str = "") -> None:
        self.path = path
        self.step = step
        super().__init__(
            f"checkpoint step {step} under {path} is gone "
            f"(garbage-collected between the pointer read and the "
            f"payload read?){': ' + detail if detail else ''}")


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint's payload is unreadable (truncated
    archive, missing leaves, unparseable manifest)."""

    def __init__(self, path: str, step: int, detail: str) -> None:
        self.path = path
        self.step = step
        super().__init__(
            f"checkpoint step {step} under {path} is corrupt: {detail}")


# -- trees --------------------------------------------------------------------
class TreeDef:
    """The structure :func:`flatten` strips off: ``kind`` is ``"leaf"``,
    ``"none"``, ``"dict"``, ``"odict"``, ``"list"``, ``"tuple"`` or
    ``"namedtuple"``; ``keys`` the dict keys in leaf order, ``ctor``
    the named tuple's class."""

    __slots__ = ("kind", "keys", "children", "ctor")

    def __init__(self, kind, keys=(), children=(), ctor=None) -> None:
        self.kind = kind
        self.keys = tuple(keys)
        self.children = tuple(children)
        self.ctor = ctor

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {b}" for k, b in
                                   zip(self.keys, inner)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(inner) + "]"
        if self.kind == "odict":
            return (f"CustomNode(OrderedDict[{self.keys!r}], ["
                    + ", ".join(inner) + "])")
        if self.kind == "namedtuple":
            return (f"CustomNode(namedtuple[{self.ctor.__name__}], ["
                    + ", ".join(inner) + "])")
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") \
            + ")"

    def __str__(self) -> str:
        return f"PyTreeDef({self._body()})"


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    """(leaves, treedef) in ``jax.tree.flatten``'s leaf order (see the
    module doc)."""
    leaves: List[Any] = []

    def walk(node) -> TreeDef:
        if node is None:
            return TreeDef("none")
        if isinstance(node, collections.OrderedDict):
            keys = list(node)
            return TreeDef("odict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, dict):
            keys = sorted(node)
            return TreeDef("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return TreeDef("namedtuple", (), [walk(x) for x in node],
                           type(node))
        if isinstance(node, (list, tuple)):
            return TreeDef("list" if isinstance(node, list) else "tuple",
                           (), [walk(x) for x in node])
        leaves.append(node)
        return TreeDef("leaf")

    treedef = walk(tree)
    return leaves, treedef


def unflatten(treedef: TreeDef, leaves) -> Any:
    """Rebuild the tree of ``treedef`` around ``leaves`` (in order)."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, kids))
        if td.kind == "odict":
            return collections.OrderedDict(zip(td.keys, kids))
        if td.kind == "list":
            return kids
        if td.kind == "namedtuple":
            return td.ctor(*kids)
        return tuple(kids)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree definition holds")
    return out


class _BF16Host:
    """A bfloat16 leaf on the host: its bits as uint16 ``bits``."""

    __slots__ = ("bits",)
    dtype = "bfloat16"

    def __init__(self, bits: np.ndarray) -> None:
        self.bits = bits

    @property
    def shape(self):
        return self.bits.shape


def _to_host(x, *, copy: bool = False):
    """One leaf as a host numpy array, or a :class:`_BF16Host` for a
    bfloat16 one (a tensor leaves its device here, on the calling
    thread)."""
    if isinstance(x, _BF16Host):
        return x
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return _BF16Host(x.detach().cpu().view(torch.int16).numpy()
                             .view(np.uint16).copy())
        on_host = x.device.type == "cpu"
        arr = x.detach().cpu().numpy()
        return arr.copy() if copy and on_host else arr
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16
        return _BF16Host(arr.view(np.uint16).copy())
    return arr


def _write_npz(path: str, host: list) -> None:
    """``np.savez(path, "0"=..., "1"=...)`` member for member (stored,
    zip64 forced), with each bfloat16 leaf written under the reference's
    ``'<V2'`` header."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, a in enumerate(host):
            with zf.open(f"{i}.npy", "w", force_zip64=True) as fid:
                if isinstance(a, _BF16Host):
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": a.bits.shape})
                    fid.write(np.ascontiguousarray(a.bits).tobytes())
                else:
                    np.lib.format.write_array(fid, np.asanyarray(a),
                                              allow_pickle=True)


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a template leaf's (torch or numpy) dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if np.dtype(dtype).name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _from_host(arr: np.ndarray, stored: str) -> torch.Tensor:
    """A stored leaf as a host tensor: a bfloat16 one (``stored`` is the
    manifest's dtype) from its two-byte payload, bit for bit."""
    if stored == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr)


# -- save ---------------------------------------------------------------------
def save(path: str, step: int, tree: Any, metadata: dict | None = None):
    """Blocking atomic save (``src/repro/train/checkpoint.py:76``)."""
    leaves, treedef = flatten(tree)
    host = [_to_host(x) for x in leaves]
    final = os.path.join(path, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    _write_npz(os.path.join(tmp, "arrays.npz"), host)
    manifest = {
        "step": step,
        "treedef": str(treedef),
        "shapes": [list(a.shape) for a in host],
        "dtypes": [str(a.dtype) for a in host],
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # commit pointer (atomic via rename)
    ptr_tmp = os.path.join(path, "LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
    os.replace(ptr_tmp, os.path.join(path, "LATEST"))


class AsyncSaver:
    """One in-flight async save; joins the previous one before starting
    (``src/repro/train/checkpoint.py:104``).

    Tensors are copied to the host on the caller thread (a tensor on
    the host is copied too, so the caller may write it afterwards);
    serialization runs in the background.  A background save that
    fails is re-raised by the next :meth:`save` / :meth:`wait` on the
    caller thread.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._failure: Optional[BaseException] = None

    def _run(self, path, step, tree, metadata):
        try:
            save(path, step, tree, metadata)
        except BaseException as e:
            # surfaced by the next save()/wait() on the caller thread
            self._failure = e

    def save(self, path: str, step: int, tree: Any,
             metadata: dict | None = None):
        self.wait()
        leaves, treedef = flatten(tree)
        host = [_to_host(x, copy=True) for x in leaves]
        host_tree = unflatten(treedef, host)
        self._thread = threading.Thread(
            target=self._run, args=(path, step, host_tree, metadata),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._failure is not None:
            failure, self._failure = self._failure, None
            raise RuntimeError(
                "background checkpoint save failed; the last announced "
                "step is NOT durable") from failure


# -- read ---------------------------------------------------------------------
def manifest(path: str, step: int | None = None) -> dict:
    """The committed manifest of ``step`` (default: latest): treedef
    string, per-leaf shapes/dtypes, user metadata.  Raises
    :class:`SnapshotGoneError` if the step dir vanished under a
    concurrent :func:`gc_old`, :class:`CheckpointCorruptError` on an
    unparseable manifest."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {path}")
    try:
        with open(os.path.join(path, f"step_{step:09d}",
                               "manifest.json")) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SnapshotGoneError(path, step, "manifest.json missing") from e
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            path, step, f"manifest.json does not parse ({e})") from e


def latest_step(path: str) -> int | None:
    ptr = os.path.join(path, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return int(f.read().strip())


def restore(path: str, tree_like: Any, step: int | None = None, *,
            device="cuda"):
    """Restore into the structure of ``tree_like`` (shapes must match;
    ``src/repro/train/checkpoint.py:182``).

    Returns (tree, step, metadata); a leaf whose template has a dtype
    comes back as a tensor of that dtype on ``device``.  Raises
    FileNotFoundError if the directory holds no committed checkpoint,
    :class:`SnapshotGoneError` if the requested step's dir vanished
    (the gc race), and :class:`CheckpointCorruptError` on a truncated
    or torn payload.
    """
    dev = resolve_device(device)
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {path}")
    d = os.path.join(path, f"step_{step:09d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
    except FileNotFoundError as e:
        raise SnapshotGoneError(path, step, "manifest.json missing") from e
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            path, step, f"manifest.json does not parse ({e})") from e
    try:
        with np.load(os.path.join(d, "arrays.npz")) as data:
            leaves = [data[str(i)] for i in range(len(data.files))]
    except FileNotFoundError as e:
        # manifest read fine but arrays vanished: gc won the race
        raise SnapshotGoneError(path, step, "arrays.npz missing") from e
    except (zipfile.BadZipFile, ValueError, KeyError, OSError, EOFError) as e:
        raise CheckpointCorruptError(
            path, step, f"arrays.npz unreadable ({type(e).__name__}: {e})"
        ) from e
    ref_leaves, treedef = flatten(tree_like)
    if len(ref_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, expected "
            f"{len(ref_leaves)}")
    stored = man.get("dtypes", [None] * len(leaves))
    out = []
    for ref, arr, kind in zip(ref_leaves, leaves, stored):
        if tuple(ref.shape) != tuple(arr.shape):
            raise ValueError(f"shape mismatch {ref.shape} vs {arr.shape}")
        if hasattr(ref, "dtype"):
            out.append(_from_host(arr, kind).to(
                dtype=_torch_dtype(ref.dtype)).to(dev))
        else:
            out.append(arr)
    return unflatten(treedef, out), step, man["metadata"]


def gc_old(path: str, keep: int = 3):
    """Delete all but the newest ``keep`` committed checkpoints, never
    the step ``LATEST`` names (``src/repro/train/checkpoint.py:228``)."""
    if not os.path.isdir(path):
        return
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith(".tmp"))
    pinned = latest_step(path)
    for s in steps[:-keep] if keep > 0 else steps:
        if s == pinned:
            continue
        shutil.rmtree(os.path.join(path, f"step_{s:09d}"), ignore_errors=True)
