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
on any mismatch, naming the tensor.  The process backends' ``save`` /
``load`` belong to the host layer, which is not ported yet.
"""

from __future__ import annotations

import itertools
import json
import os
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
