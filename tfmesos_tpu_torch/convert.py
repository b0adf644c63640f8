"""Carry transformer weights across frameworks and processes.

``params_from_jax`` takes the JAX package's ``init_params`` tree after
``jax.tree_util.tree_map(np.asarray, ...)`` (this module imports no
JAX: the caller does the ``np.asarray``) and returns the same nested
dict of torch tensors; ``params_to_numpy`` is the way back (float32
master leaves stay float32, so updated weights can be handed to the JAX
package).  ``save_npz``/``load_npz`` store a params dict
as one ``.npz`` of ``/``-joined paths (``layers/wq``), so one set of
weights can be handed to several replicas.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

Params = Dict[str, Any]


def _leaf_to_torch(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    # A bf16 leaf arrives as an ml_dtypes bfloat16 array, which torch
    # cannot take: go through float32 and cast back.
    bf16 = arr.dtype.name == "bfloat16"
    if bf16:
        arr = arr.astype(np.float32)
    # np.array copies: a JAX array's numpy view is read-only, and
    # torch.from_numpy would warn on (and alias) it.
    t = torch.tensor(np.array(arr), device=device)
    return t.to(torch.bfloat16) if bf16 else t


def params_from_jax(tree: Mapping[str, Any],
                    device: Union[str, torch.device] = "cpu") -> Params:
    """Nested dict of numpy leaves -> the same dict of torch tensors on
    ``device``, dtypes kept (float32 masters stay float32)."""
    return {k: (params_from_jax(v, device) if isinstance(v, Mapping)
                else _leaf_to_torch(v, device)) for k, v in tree.items()}


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """Nested dict of torch tensors -> the same dict of numpy arrays on
    the host (a bf16 leaf comes back as float32, which holds its values
    exactly)."""
    return {k: (params_to_numpy(v) if isinstance(v, Mapping) else
                v.detach().cpu().float().numpy()
                if v.dtype == torch.bfloat16 else v.detach().cpu().numpy())
            for k, v in params.items()}


def flatten(params: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"layers/wq": tensor, ...}`` view of a nested params dict."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Params:
    out: Params = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def save_npz(params: Params, path: str) -> None:
    """Write ``params`` as float32 arrays keyed by path."""
    np.savez(path, **{k: v.detach().float().cpu().numpy()
                      for k, v in flatten(params).items()})


def load_npz(path: str, device: Union[str, torch.device] = "cpu"
             ) -> Params:
    """Read a :func:`save_npz` file back onto ``device``."""
    with np.load(path) as z:
        return unflatten({k: torch.tensor(z[k], device=device)
                          for k in z.files})
