"""Carry model weights across frameworks and processes.

``params_from_jax`` takes the JAX package's ``init_params`` tree (the
transformer's or the MNIST MLP's, ``models/mlp.py``) or a
``quantize_params`` tree after ``jax.tree_util.tree_map(np.asarray,
...)`` (this module imports no JAX: the caller does the ``np.asarray``)
and returns the same nested dict of torch tensors, an int8 ``(values,
scales)`` pair becoming the port's
:class:`~tfmesos_tpu_torch.ops.quant.QTensor`; ``params_to_numpy`` is
the way back (float32 master leaves stay float32 and int8 values int8,
so updated weights can be handed to the JAX package).
``save_npz``/``load_npz`` store a params dict as one ``.npz`` of
``/``-joined paths (``layers/wq``; a QTensor as ``layers/wq/values`` and
``layers/wq/scales``), so one set of weights can be handed to several
replicas.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from tfmesos_tpu_torch.ops.quant import QTensor

Params = Dict[str, Any]

_QT_FIELDS = ("values", "scales")


def _is_qtensor(x) -> bool:
    """An int8 (values, scales) pair: the port's QTensor, or any
    NamedTuple with exactly those fields (the JAX package's QTensor —
    recognized by its fields, never by importing its class)."""
    return isinstance(x, tuple) and getattr(x, "_fields", None) == _QT_FIELDS


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
    """Nested dict of numpy leaves (or (values, scales) pairs) -> the
    same dict of torch tensors (or QTensors) on ``device``, dtypes kept
    (float32 masters stay float32, int8 values int8)."""
    def conv(v):
        if isinstance(v, Mapping):
            return params_from_jax(v, device)
        if _is_qtensor(v):
            return QTensor(_leaf_to_torch(v[0], device),
                           _leaf_to_torch(v[1], device))
        return _leaf_to_torch(v, device)

    return {k: conv(v) for k, v in tree.items()}


def _leaf_to_numpy(v: torch.Tensor) -> np.ndarray:
    v = v.detach().cpu()
    return (v.float() if v.dtype == torch.bfloat16 else v).numpy()


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """Nested dict of torch tensors -> the same dict of numpy arrays on
    the host (a bf16 leaf comes back as float32, which holds its values
    exactly; a QTensor as a QTensor of numpy arrays, int8 kept)."""
    def conv(v):
        if isinstance(v, Mapping):
            return params_to_numpy(v)
        if isinstance(v, QTensor):
            return QTensor(*(_leaf_to_numpy(x) for x in v))
        return _leaf_to_numpy(v)

    return {k: conv(v) for k, v in params.items()}


def flatten(params: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"layers/wq": tensor, ...}`` view of a nested params dict; a
    QTensor leaf gives ``<path>/values`` and ``<path>/scales``."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "/"))
        elif isinstance(v, QTensor):
            out[f"{path}/values"], out[f"{path}/scales"] = v
        else:
            out[path] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Params:
    """The nested dict of a :func:`flatten` view (a node holding exactly
    ``values`` and ``scales`` becomes a QTensor again)."""
    out: Params = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def fold(node):
        if not isinstance(node, dict):
            return node
        if sorted(node) == sorted(_QT_FIELDS):
            return QTensor(node["values"], node["scales"])
        return {k: fold(v) for k, v in node.items()}

    return fold(out)


def save_npz(params: Params, path: str) -> None:
    """Write ``params`` keyed by path, each array at its own dtype (a
    bf16 leaf as float32, which numpy can hold; int8 stays int8)."""
    np.savez(path, **{k: _leaf_to_numpy(v)
                      for k, v in flatten(params).items()})


def load_npz(path: str, device: Union[str, torch.device] = "cpu"
             ) -> Params:
    """Read a :func:`save_npz` file back onto ``device``."""
    with np.load(path) as z:
        return unflatten({k: torch.tensor(z[k], device=device)
                          for k in z.files})
