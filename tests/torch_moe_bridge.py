"""The port's ``parallel.moe`` reference behind the JAX module's call
shape, for the JAX ``tests/test_moe.py`` cases run through
``torch_jax_cases.port_cases``: JAX (or numpy) arrays in, the port's
function on CPU tensors, JAX arrays out (the aux dict's values too)."""

import jax.numpy as jnp
import numpy as np
import torch

from tfmesos_tpu_torch.parallel import moe


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def switch_moe_reference(x, router_w, w_gate, w_up, w_down,
                         capacity_factor: float = 1.25, top_k: int = 1,
                         return_aux: bool = False):
    out = moe.switch_moe_reference(
        *(_t(a) for a in (x, router_w, w_gate, w_up, w_down)),
        capacity_factor=capacity_factor, top_k=top_k, return_aux=True)
    y, aux = jnp.asarray(out[0].numpy()), {
        k: jnp.asarray(v.numpy()) for k, v in out[1].items()}
    return (y, aux) if return_aux else y


def switch_moe(*args, **kwargs):
    raise NotImplementedError("the sharded cases run on gloo ranks "
                              "(tests/test_torch_moe.py)")
