"""Carry a world's state across from numpy.

The collectives have no weights: their state is the per-rank inputs and
the split groups.  ``world_from_numpy`` stacks per-rank arrays into the ``[P, ...]``
tensor ``run_spmd`` takes (index it with ``comm.rank`` inside the
program, as the reference's programs index their replicated argument);
``TorchCommunicator.from_groups`` rebuilds a split communicator from its
group lists.  ``params_from_numpy`` carries a model's weights (the
long-context training block's) across as a state dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch


def world_from_numpy(per_rank_arrays: Union[np.ndarray, Sequence[np.ndarray]],
                     device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stack one array per rank (or take an already stacked ``[P, ...]``
    array) into a tensor on ``device``, cast to ``dtype`` when given (numpy
    has no bfloat16: pass float32 arrays and ``dtype=torch.bfloat16``)."""
    stacked = np.stack([np.asarray(a) for a in per_rank_arrays])
    t = torch.from_numpy(np.ascontiguousarray(stacked))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(params: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """A model's weights from numpy arrays (for instance the JAX example's
    parameters, ``np.asarray`` of each leaf) as the state dict of the
    port's module: same names, same layout, on ``device``."""
    return {name: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for name, a in params.items()}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bfloat16 widened to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
