"""Sharded checkpoints of SPMD state — counterpart of the SPMD half of
``mpi_tpu/checkpoint.py`` (``save_sharded`` :164, ``load_sharded`` :173).

The reference hands a pytree of sharded ``jax.Array``s to orbax, which
writes each shard from the device that owns it and restores it to the
same sharding.  Here a leaf is a tensor with a ``Layout`` over the ranks
(``Sharded(tensor, layout)``; a bare tensor is replicated on every rank):

* a world tensor ``[P, ...]`` as ``run_spmd`` returns it is
  ``Layout.world(P, ndim)``: rank r's shard is ``world[r:r + 1]``;
* a whole tensor laid out over a mesh of ranks is
  ``Layout({"dp": 2, "mp": 4}, (None, "mp"))``, the reference's
  ``NamedSharding(mesh, P(None, "mp"))``: dim 1 is split in 4 and each
  piece is replicated over ``dp``.

``save_sharded`` writes each distinct shard once, as its own file, from a
view of the tensor (a shard on the card is copied to the host alone):
nothing is gathered or concatenated.  The files of one save go into a
fresh ``gen{k}/`` directory, and a manifest of every tensor's shape, dtype,
layout and shard files is committed last by an atomic rename, as the
reference's process-backend ``save`` (:51) commits its generations: a save
torn before the rename leaves the previous checkpoint loadable, and the
orphaned directory is swept by the next save.  ``load_sharded`` restores
onto the template's device, dtype and layout, shard by shard, and raises
on any mismatch, naming the tensor.

The process backends' ``save`` / ``exists`` / ``load`` (:51, :133, :138)
keep the reference's layout: ``gen{k}/rank{r}/state.pkl``, a manifest
``{"nranks", "format": 2, "gen"}`` swung by an atomic ``os.replace`` once
every rank's state is on disk, the sweep of everything else, and
``agree=True`` deciding the commit by ULFM agreement.  ``state.pkl`` is a
plain pickle of the state pytree, as the reference's, in which each
tensor is a persistent reference carrying its dtype, shape and raw bytes
but no device (``_TensorPickler``); ``load`` rebuilds it on the loading
rank's device (``comm.device``: its card, or the CPU under ``--device
cpu``).  Not ``torch.save`` / ``torch.load``: their pickle records each
tensor's device (a rank would get its tensors back on the saver's card),
``torch.load`` refuses a pytree of arbitrary Python objects under its
default ``weights_only=True`` (torch >= 2.6), and a reference checkpoint,
a plain pickle with numpy leaves, would not load.  With this spelling
numpy arrays and Python objects round-trip as the reference's do, and a
directory the reference's ``save`` wrote loads with the same leaves.
"""

from __future__ import annotations

import itertools
import json
import os
import pickle
import re
import shutil
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

_MANIFEST = "manifest.json"
_FORMAT = 1
_GEN = re.compile(r"gen\d+")  # a generation's directory; nothing else is swept


@dataclass(frozen=True)
class Layout:
    """How a tensor lies over a mesh of ranks: ``mesh`` the (name, size) of
    each axis, world rank = row-major mesh position (the 2-D step's
    ``i_dp * mp + i_mp``); ``spec`` per tensor dim the axis that splits
    it, or None.  Axes no dim names hold replicas."""

    mesh: Tuple[Tuple[str, int], ...]
    spec: Tuple[Optional[str], ...]

    def __init__(self, mesh: Mapping[str, int] = None,
                 spec: Sequence[Optional[str]] = ()):
        mesh = tuple((str(k), int(v)) for k, v in dict(mesh or {}).items())
        spec = tuple(spec)
        names = [k for k, _ in mesh]
        for axis in spec:
            if axis is not None and axis not in names:
                raise ValueError(f"spec names axis {axis!r}, not in mesh {names}")
        used = [a for a in spec if a is not None]
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec} splits two dims over one axis")
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "spec", spec)

    @classmethod
    def world(cls, nranks: int, ndim: int) -> "Layout":
        """A rank-stacked ``[P, ...]`` world tensor of ``ndim`` dims."""
        return cls({"world": nranks}, ("world",) + (None,) * (ndim - 1))

    def to_json(self) -> dict:
        return {"mesh": [list(m) for m in self.mesh], "spec": list(self.spec)}

    @classmethod
    def from_json(cls, d: dict) -> "Layout":
        return cls(dict((k, v) for k, v in d["mesh"]), d["spec"])

    def shards(self, shape: Sequence[int]) -> List[Tuple[Tuple[Tuple[int, int], ...],
                                                         List[int]]]:
        """The distinct shards of a tensor of ``shape``: each as the
        (start, stop) of every dim and the world ranks holding it, in the
        order of the lowest rank."""
        if len(self.spec) not in (0, len(shape)):
            raise ValueError(f"layout spec {self.spec} does not fit shape "
                             f"{tuple(shape)}")
        sizes = dict(self.mesh)
        names = [k for k, _ in self.mesh]
        spec = self.spec or (None,) * len(shape)
        for dim, axis in enumerate(spec):
            if axis is not None and shape[dim] % sizes[axis]:
                raise ValueError(
                    f"dim {dim} of size {shape[dim]} does not split evenly over "
                    f"axis {axis!r} of size {sizes[axis]}")
        found: Dict[tuple, List[int]] = {}
        positions = itertools.product(*(range(n) for _, n in self.mesh))
        for rank, pos in enumerate(positions):
            at = dict(zip(names, pos))
            box = []
            for dim, axis in enumerate(spec):
                if axis is None:
                    box.append((0, int(shape[dim])))
                else:
                    step = shape[dim] // sizes[axis]
                    box.append((at[axis] * step, (at[axis] + 1) * step))
            found.setdefault(tuple(box), []).append(rank)
        return list(found.items())


REPLICATED = Layout()


@dataclass(frozen=True, eq=False)
class Sharded:
    """A checkpoint leaf: ``tensor`` laid out over the ranks by ``layout``."""

    tensor: torch.Tensor
    layout: Layout


def _is_leaf(x: Any) -> bool:
    return isinstance(x, Sharded)


def _leaves(state: Any) -> List[Tuple[str, torch.Tensor, Layout, bool]]:
    """(name, tensor, layout, whether it was a ``Sharded``) of every leaf,
    the name being its pytree key path."""
    flat, _ = pytree.tree_flatten_with_path(state, is_leaf=_is_leaf)
    out = []
    for path, leaf in flat:
        name = pytree.keystr(path) or "<root>"
        if isinstance(leaf, Sharded):
            out.append((name, leaf.tensor, leaf.layout, True))
        elif isinstance(leaf, torch.Tensor):
            out.append((name, leaf, REPLICATED, False))
        else:
            raise TypeError(f"checkpoint leaf {name} is a {type(leaf).__name__}, "
                            f"not a tensor or Sharded")
    return out


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name.replace("torch.", ""), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in the manifest")
    return dtype


def _view(tensor: torch.Tensor, box) -> torch.Tensor:
    return tensor[tuple(slice(a, b) for a, b in box)]


def _write(view: torch.Tensor, path: str) -> int:
    """The shard's bytes, from the view: a host view that is contiguous is
    written as it lies; any other is copied to one host tensor first."""
    host = view.detach().to("cpu").contiguous()
    data = host.reshape(-1).view(torch.uint8).numpy()
    with open(path, "wb") as f:
        f.write(memoryview(data))
        f.flush()
        os.fsync(f.fileno())
    return data.nbytes


def _read_manifest(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def save_sharded(path: str, state: Any) -> int:
    """Write a pytree of tensors (``Sharded`` leaves, or bare tensors
    replicated on every rank) under ``path``: each distinct shard once, as
    its own file, then the manifest by an atomic rename.  Returns the bytes
    of shard data written."""
    leaves = _leaves(state)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    old = _read_manifest(path)
    gen = 0 if old is None else int(old["gen"]) + 1
    for entry in os.listdir(path):  # generations no manifest commits
        if _GEN.fullmatch(entry) and entry != f"gen{gen - 1}":
            shutil.rmtree(os.path.join(path, entry), ignore_errors=True)
    gen_dir = os.path.join(path, f"gen{gen}")
    os.makedirs(gen_dir)
    tensors, total = [], 0
    for i, (name, tensor, layout, _) in enumerate(leaves):
        shards = []
        for j, (box, owners) in enumerate(layout.shards(tensor.shape)):
            fname = f"{i}.{j}.bin"
            total += _write(_view(tensor, box), os.path.join(gen_dir, fname))
            shards.append({"file": fname, "box": [list(b) for b in box],
                           "owners": owners})
        tensors.append({"name": name, "shape": list(tensor.shape),
                        "dtype": str(tensor.dtype).replace("torch.", ""),
                        "layout": layout.to_json(), "shards": shards})
    manifest = {"format": _FORMAT, "gen": gen, "tensors": tensors}
    tmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, _MANIFEST))  # the commit
    if old is not None:
        shutil.rmtree(os.path.join(path, f"gen{old['gen']}"), ignore_errors=True)
    return total


def load_sharded(path: str, template: Any) -> Any:
    """Restore a pytree saved by ``save_sharded`` onto ``template``'s
    structure: each leaf (a ``Sharded`` or a bare tensor) gives the
    device, dtype, shape and layout to restore to, and comes back as the
    same kind of leaf holding a new tensor.  Raises FileNotFoundError
    without a committed manifest, ValueError on any mismatch."""
    path = os.path.abspath(path)
    manifest = _read_manifest(path)
    if manifest is None:
        raise FileNotFoundError(
            f"no complete checkpoint at {path!r} (manifest missing: the save "
            f"was interrupted before its commit)")
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"checkpoint format {manifest.get('format')} is not {_FORMAT}")
    saved = {t["name"]: t for t in manifest["tensors"]}
    gen_dir = os.path.join(path, f"gen{manifest['gen']}")
    leaves = _leaves(template)
    missing = sorted(set(saved) - {leaf[0] for leaf in leaves})
    if missing:
        raise ValueError(f"the template has no leaf for saved tensors {missing}")
    restored = []
    for name, want, layout, sharded in leaves:
        entry = saved.get(name)
        if entry is None:
            raise ValueError(f"tensor {name} is not in the checkpoint")
        shape, dtype = tuple(entry["shape"]), _dtype(entry["dtype"])
        got_layout = Layout.from_json(entry["layout"])
        if shape != tuple(want.shape) or dtype != want.dtype or got_layout != layout:
            raise ValueError(
                f"tensor {name}: saved {shape} {dtype} {got_layout}, the template "
                f"wants {tuple(want.shape)} {want.dtype} {layout}")
        out = torch.empty(shape, dtype=dtype, device=want.device)
        for shard in entry["shards"]:
            box = tuple(tuple(b) for b in shard["box"])
            view = _view(out, box)
            raw = np.fromfile(os.path.join(gen_dir, shard["file"]), dtype=np.uint8)
            if raw.nbytes != view.numel() * view.element_size():
                raise ValueError(f"tensor {name}: shard {shard['file']} holds "
                                 f"{raw.nbytes} bytes, not {view.numel() * view.element_size()}")
            view.copy_(torch.from_numpy(raw).view(dtype).reshape(view.shape))
        restored.append(Sharded(out, layout) if sharded else out)
    _, spec = pytree.tree_flatten(template, is_leaf=_is_leaf)
    return pytree.tree_unflatten(restored, spec)


# ---- the process backends' collective checkpoint -------------------------

_STATE = "state.pkl"
_PROC_FORMAT = 2
_TENSOR = "mpi_tpu_torch.Tensor"  # the persistent-reference tag of a tensor


class _TensorPickler(pickle.Pickler):
    """Pickles a state pytree with each tensor as a persistent reference
    ``(tag, dtype, shape, raw bytes)``, written from one host copy of the
    tensor (a card tensor is copied to the host once)."""

    def persistent_id(self, obj: Any):
        if not isinstance(obj, torch.Tensor):
            return None
        host = obj.detach().to("cpu").contiguous()
        raw = host.reshape(-1).view(torch.uint8).numpy()
        return (_TENSOR, str(host.dtype).replace("torch.", ""),
                tuple(host.shape), raw)


class _TensorUnpickler(pickle.Unpickler):
    """Rebuilds each persistent tensor reference on ``device``."""

    def __init__(self, f, device: torch.device):
        super().__init__(f)
        self._device = device

    def persistent_load(self, pid: Any):
        tag, dtype, shape, raw = pid
        if tag != _TENSOR:
            raise pickle.UnpicklingError(f"unknown persistent id {tag!r}")
        host = torch.from_numpy(raw).view(_dtype(dtype)).reshape(shape)
        return host.to(self._device)


def save(path: str, state: Any, comm=None, agree: bool = False) -> None:
    """Collective checkpoint on a process-backend communicator
    (``mpi_tpu/checkpoint.py:51``).

    Every rank writes its state pytree into a FRESH ``gen{k}/rank{r}/``
    and only after all ranks have finished does rank 0 atomically swing
    the manifest to generation k, so ``path`` holds the previous complete
    checkpoint or the new one through every instant of the save.  A crash
    before the manifest swap leaves the old generation committed, a crash
    after it the new one (the orphaned directory is swept by the next
    save).

    ``agree=True`` (needs ULFM fault tolerance, ``ft.py``) replaces the
    pre-commit barrier with fault-tolerant agreement: if any rank died
    before its state reached disk, ``comm.agree`` raises ProcFailedError
    on every survivor and the manifest is NOT swung.  An exception from
    the post-commit agreement means the checkpoint IS committed
    (``exists(path)`` tells)."""
    from . import init

    comm = comm or init()

    def _sync(committed: bool):
        if not agree:
            comm.barrier()
            return
        # the agreed value is "no survivor knows of any dead member",
        # whatever failure_ack says: a full-world checkpoint with a
        # member's state missing must never commit (the sweep would
        # destroy the last good generation)
        if not comm.agree(not comm.get_failed()):
            from .errors import ProcFailedError

            raise ProcFailedError(
                "checkpoint IS committed, but a member died before "
                "every survivor returned from save (exists(path) "
                "confirms the new generation)" if committed else
                "checkpoint commit withheld: a member died before "
                "every rank's state reached disk",
                failed=tuple(comm.get_failed()), collective="agree")

    if comm.rank == 0:
        prev = _read_manifest(path)
        next_gen = (-1 if prev is None else int(prev.get("gen", -1))) + 1
    else:
        next_gen = None
    next_gen = comm.bcast(next_gen, root=0)
    rank_dir = os.path.join(path, f"gen{next_gen}", f"rank{comm.rank}")
    os.makedirs(rank_dir, exist_ok=True)
    with open(os.path.join(rank_dir, _STATE), "wb") as f:
        _TensorPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(state)
    _sync(committed=False)  # every rank's state on disk, or NO commit
    if comm.rank == 0:
        tmp = os.path.join(path, "." + _MANIFEST)
        with open(tmp, "w") as f:
            json.dump({"nranks": comm.size, "format": _PROC_FORMAT,
                       "gen": next_gen}, f)
        os.replace(tmp, os.path.join(path, _MANIFEST))  # the commit point
        # everything but the committed generation is unreferenced now:
        # older generations, orphans of saves that crashed after their
        # commit, and format-1 rank{r}/ directories
        keep = f"gen{next_gen}"
        for entry in os.listdir(path):
            if entry == keep or not (entry.startswith("gen")
                                     or entry.startswith("rank")):
                continue
            victim = os.path.join(path, entry)
            if os.path.isdir(victim):
                shutil.rmtree(victim, ignore_errors=True)
    _sync(committed=True)  # nobody returns before the commit is visible


def exists(path: str) -> bool:
    """True iff ``path`` holds a COMPLETE checkpoint (manifest present;
    ``mpi_tpu/checkpoint.py:133``)."""
    return os.path.exists(os.path.join(path, _MANIFEST))


def load(path: str, comm=None) -> Any:
    """Restore this rank's state from a complete checkpoint
    (``mpi_tpu/checkpoint.py:138``), its tensors on the rank's device;
    raises FileNotFoundError on a missing or partial one, ValueError on a
    world-size mismatch (a resumed job must match the checkpoint's
    geometry)."""
    from . import init

    comm = comm or init()
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(
            f"no complete checkpoint at {path!r} (manifest missing — the "
            f"save was interrupted before commit)")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest["nranks"] != comm.size:
        raise ValueError(
            f"checkpoint was taken with {manifest['nranks']} ranks; this "
            f"world has {comm.size}")
    gen = manifest.get("gen")  # format 1: rank dirs directly under path
    state_dir = path if gen is None else os.path.join(path, f"gen{gen}")
    with open(os.path.join(state_dir, f"rank{comm.rank}", _STATE), "rb") as f:
        return _TensorUnpickler(f, comm.device).load()
