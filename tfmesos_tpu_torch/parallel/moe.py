"""Expert parallelism: top-k MoE with capacity and a real all-to-all data
path (port of ``tfmesos_tpu/parallel/moe.py``: ``_routing`` ``:38``,
``_expert_ffn`` ``:81``, ``_capacity`` ``:89``, ``switch_moe_reference``
``:94``, ``switch_moe_local`` ``:113``, ``switch_moe_replicated_local``
``:156``, ``switch_moe`` ``:196``).

Semantics, the JAX package's: each token takes its top-k experts; an
assignment lands if it arrives within the expert's capacity, with slot
priority by choice rank then token order (every first choice beats any
second choice); a kept assignment is weighted by its router probability
(renormalized over the top-k when k > 1, raw when k == 1); a dropped one
contributes zero (the residual stream carries the token).  The router's
health comes back as aux: the load-balance loss E·Σ_e f_e·P_e (1.0 at
perfect balance), the z-loss mean(logsumexp²) and the overflow fraction.

The JAX routing builds ``combine`` [n, E, C] as a product over
[n, k, E, C], which eager PyTorch would materialize (n·k·E·C floats a
layer, and E·C grows with n).  :class:`Routing` keeps the kept
(token, expert, slot) triples instead — the same values, ``dense()``
scatters them into [n, E, C] — and the experts' inputs are GATHERED
from the tokens by slot and their outputs gathered back, never a dense
``"nec,nd->ecd"`` product.  The slot of an assignment is the count of
earlier assignments to its expert in choice-major order (an integer
cumsum, exactly the JAX float cumsum's values).

Over the ``ep`` axes (:func:`switch_moe_local`) expert blocks travel by
two all-to-all hops (``parallel.collectives.all_to_all``): to the
experts' owners and back.  Inside a pipeline stage the tokens are
replicated over ep instead (:func:`switch_moe_replicated_local`): each
rank computes the slots of its own experts and the partial outputs are
summed.  The expert FFNs are plain batched products,
as the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from tfmesos_tpu_torch.parallel import collectives

__all__ = ["Routing", "switch_moe_reference", "switch_moe_local",
           "switch_moe_replicated_local", "switch_moe"]


@dataclass
class Routing:
    """The kept assignments of one routing: for each (token, choice)
    ``expert`` and ``slot`` [n, k] (int64), ``keep`` [n, k] (bool) and
    ``gates`` [n, k] (float32, differentiable), over ``n_experts``
    experts of ``capacity`` slots."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor
    n_experts: int
    capacity: int

    @property
    def index(self) -> torch.Tensor:
        """[n, k] flat slot index ``expert * capacity + slot``."""
        return self.expert * self.capacity + self.slot

    def dense(self) -> torch.Tensor:
        """``combine`` [n, E, C]: the gate of each kept assignment at its
        (token, expert, slot), zero elsewhere (the JAX ``_routing``'s
        first result)."""
        n, k = self.expert.shape
        out = torch.zeros(n, self.n_experts * self.capacity,
                          dtype=torch.float32, device=self.gates.device)
        w = torch.where(self.keep, self.gates, torch.zeros_like(self.gates))
        out = out.scatter_add(1, torch.where(self.keep, self.index, 0), w)
        return out.reshape(n, self.n_experts, self.capacity)


def _capacity(n_tokens: int, n_experts: int, factor: float,
              top_k: int = 1) -> int:
    return max(1, math.ceil(n_tokens * top_k * factor / n_experts))


def _routing(x: torch.Tensor, router_w: torch.Tensor, n_experts: int,
             capacity: int, top_k: int = 1
             ) -> Tuple[Routing, Dict[str, torch.Tensor]]:
    """The routing math: the :class:`Routing` of ``x`` [n, d] over
    ``router_w`` [d, E] and the aux metrics (over the PRE-capacity
    assignment, as in JAX)."""
    logits = (x @ router_w).float()                          # [n, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)          # [n, k]
    gates = top_p if top_k == 1 else top_p / top_p.sum(-1, keepdim=True)
    n = x.shape[0]
    # Slots in choice-major order: every token's first choice outranks
    # any token's second choice.
    order = top_e.t().reshape(-1)                            # [k*n]
    onehot = torch.nn.functional.one_hot(order, n_experts)   # [k*n, E]
    pos = onehot.cumsum(0).gather(1, order[:, None])[:, 0] - 1
    pos = pos.reshape(top_k, n).t()                          # [n, k]
    keep = pos < capacity
    f = onehot.sum(0).float() / (n * top_k)                  # assignment frac
    aux = {
        "load_balance_loss": n_experts * torch.sum(f * probs.mean(0)),
        "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "overflow_frac": 1.0 - keep.sum().float() / (n * top_k),
    }
    route = Routing(top_e, pos.clamp(0, capacity - 1), keep, gates,
                    n_experts, capacity)
    return route, aux


def _dispatch(x: torch.Tensor, route: Routing) -> torch.Tensor:
    """The experts' inputs [E, C, d] in float32: each kept token placed
    at its (expert, slot), zeros in the empty slots (the JAX
    ``einsum("nec,nd->ecd", dispatch, x)``, by index)."""
    n, d = x.shape
    e, c = route.n_experts, route.capacity
    k = route.expert.shape[1]
    tok = torch.arange(n, device=x.device)[:, None].expand(n, k)
    keep = route.keep.reshape(-1)
    src = x.float()[tok.reshape(-1)[keep]]
    out = torch.zeros(e * c, d, dtype=torch.float32, device=x.device)
    out = out.index_add(0, route.index.reshape(-1)[keep], src)
    return out.reshape(e, c, d)


def _combine(expert_out: torch.Tensor, route: Routing) -> torch.Tensor:
    """[n, d] float32: each token's kept assignments' outputs weighted by
    their gates (the JAX ``einsum("nec,ecd->nd", combine, out)``, by
    index)."""
    e, c, d = expert_out.shape
    n, k = route.expert.shape
    rows = expert_out.float().reshape(e * c, d)[route.index.reshape(-1)]
    w = torch.where(route.keep, route.gates, torch.zeros_like(route.gates))
    return (rows.reshape(n, k, d) * w[..., None]).sum(1)


def _expert_ffn(tokens: torch.Tensor, w_gate, w_up, w_down,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """Per-expert SwiGLU over [E_loc, C', d] token blocks: batched
    products over the expert dim in the compute dtype."""
    t = tokens.to(compute_dtype)
    g = torch.nn.functional.silu(torch.bmm(t, w_gate.to(compute_dtype)))
    u = torch.bmm(t, w_up.to(compute_dtype))
    return torch.bmm(g * u, w_down.to(compute_dtype))


def switch_moe_reference(x, router_w, w_gate, w_up, w_down,
                         capacity_factor: float = 1.25, top_k: int = 1,
                         return_aux: bool = False):
    """Single-device top-k MoE (the ground truth of the sharded path).

    x: [n, d]; router_w: [d, E]; w_gate/w_up: [E, d, f]; w_down:
    [E, f, d].  The output is in x's dtype."""
    n = x.shape[0]
    e = router_w.shape[-1]
    capacity = _capacity(n, e, capacity_factor, top_k)
    route, aux = _routing(x, router_w, e, capacity, top_k)
    expert_out = _expert_ffn(_dispatch(x, route), w_gate, w_up, w_down,
                             x.dtype)
    out = _combine(expert_out, route).to(x.dtype)
    return (out, aux) if return_aux else out


class _ScaleGrad(torch.autograd.Function):
    """Identity forward, the gradient times ``s`` backward."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def switch_moe_local(x, router_w, w_gate, w_up, w_down, mesh,
                     axis="ep", capacity_factor: float = 1.25,
                     top_k: int = 1, tp_axis: Optional[str] = None):
    """One rank's body over the ``axis`` group: tokens local [n_loc, d],
    experts local [E/ep, d, f].  The experts' inputs [E, C, d] split on
    the expert dim into a block per owner; hop 1 brings each rank, from
    every peer, the blocks of ITS experts ([E/ep, ep·C, d], grouped by
    source rank), hop 2 sends each source its processed blocks back
    ([E, C, d] in global expert order).  Returns (out, aux), aux
    averaged over the group.

    ``tp_axis``: the experts' FFN widths are also cut over tp (e_gate
    and e_up on their output columns, e_down on its input rows); the
    tokens and the gates fan out through Megatron's *f* into the cut
    products and the combined output is all-reduced once (*g*).  The
    router sees the tokens before the fan: its logits are replicated
    compute."""
    ep = 1 if mesh is None else mesh.axis_size(axis)
    n_loc, d = x.shape
    e_loc = w_gate.shape[0]
    e = e_loc * ep
    capacity = _capacity(n_loc, e, capacity_factor, top_k)
    route, aux = _routing(x, router_w, e, capacity, top_k)
    xe = x
    if tp_axis is not None:
        xe = collectives.broadcast_replicated_grad(x, mesh, tp_axis)
        route.gates = collectives.broadcast_replicated_grad(
            route.gates, mesh, tp_axis)
    blocks = _dispatch(xe, route).reshape(ep, e_loc, capacity, d)
    received = collectives.all_to_all(blocks, mesh, axis, 0, 0)
    # received [ep(source), e_loc, C, d] -> [e_loc, ep * C, d]
    received = received.transpose(0, 1).reshape(e_loc, ep * capacity, d)
    out = _expert_ffn(received, w_gate, w_up, w_down, x.dtype)
    out = out.float().reshape(e_loc, ep, capacity, d).transpose(0, 1)
    returned = collectives.all_to_all(out.contiguous(), mesh, axis, 0, 0)
    combined = _combine(returned.reshape(e, capacity, d), route)
    if tp_axis is not None:
        combined = collectives.psum_replicated_grad(combined, mesh, tp_axis)
    aux = {k: collectives.mean_replicated_grad(v, mesh, axis)
           for k, v in aux.items()}
    return combined.to(x.dtype), aux


def switch_moe_replicated_local(x, router_w, w_gate, w_up, w_down, mesh,
                                ep_axis: Optional[str] = None,
                                capacity_factor: float = 1.25,
                                top_k: int = 1,
                                tp_axis: Optional[str] = None):
    """Capacity MoE for ep-REPLICATED tokens, the pipeline-stage layout
    (the JAX ``switch_moe_replicated_local``): every rank of ``ep_axis``
    holds every token of the microbatch and routes them all (the router
    whole), computes the capacity slots of its LOCAL experts only
    ([E/ep, d, f], cut over ``tp_axis`` too: e_gate / e_up on their
    output columns, e_down on its input rows), and the partial outputs
    are summed over both axes.  The tokens and gates fan out through
    Megatron's *f* over the axes and the sum is *g*, so every gradient
    is one process's.  Capacity is a competition over ``x``'s tokens.
    Without either axis, :func:`switch_moe_reference`.  Returns (out,
    aux), aux the same on every rank of the axes."""
    axes = tuple(a for a in (ep_axis, tp_axis) if a)
    if not axes:
        return switch_moe_reference(x, router_w, w_gate, w_up, w_down,
                                    capacity_factor, top_k=top_k,
                                    return_aux=True)
    n = x.shape[0]
    e_loc = w_gate.shape[0]
    ep = mesh.axis_size(ep_axis) if ep_axis else 1
    e = e_loc * ep
    capacity = _capacity(n, e, capacity_factor, top_k)
    route, aux = _routing(x, router_w, e, capacity, top_k)
    lo = mesh.coord(ep_axis) * e_loc if ep_axis else 0
    mine = (route.expert >= lo) & (route.expert < lo + e_loc)
    local = Routing((route.expert - lo).clamp(0, e_loc - 1), route.slot,
                    route.keep & mine,
                    collectives.broadcast_replicated_grad(route.gates, mesh,
                                                          axes),
                    e_loc, capacity)
    xe = collectives.broadcast_replicated_grad(x, mesh, axes)
    out = _expert_ffn(_dispatch(xe, local), w_gate, w_up, w_down, x.dtype)
    out = collectives.psum_replicated_grad(_combine(out, local), mesh, axes)
    return out.to(x.dtype), aux


def switch_moe(x, router_w, w_gate, w_up, w_down, mesh=None,
               axis: str = "ep", capacity_factor: float = 1.25,
               top_k: int = 1, return_aux: bool = False,
               tp_axis: Optional[str] = None):
    """The mesh entry point: ``x`` [n, d] this rank's tokens (its data
    shard's, the same on every rank of ``axis``: ep is not a data axis),
    experts this rank's block over ``axis``.  Without a (non-trivial)
    ``axis`` the JAX entry point runs the reference over the GLOBAL
    batch, so here the tokens are gathered over the data axes first and
    this rank's block cut from the output: capacity, drops and the aux
    metrics are over every token, as in JAX (on one rank it is just
    :func:`switch_moe_reference` — the JAX semantics, not a device
    fallback).  Over ``axis`` routing and capacity are per data shard
    and the aux metrics come back averaged over the group and the data
    axes (as the JAX body pmeans them).

    Every ep rank dispatches the same tokens, so each expert computes ep
    copies of its tokens: its weights' gradient is scaled by 1/ep,
    which keeps it to one copy's, the gradient a single process takes.
    """
    from tfmesos_tpu_torch.parallel.sharding import data_axes

    ep = 1 if mesh is None else mesh.axis_size(axis)
    tp = 1 if mesh is None or tp_axis is None else mesh.axis_size(tp_axis)
    data = data_axes(mesh)
    n_loc = x.shape[0]
    if ep == 1 and data:
        x = collectives.gather_shards(x.contiguous(), mesh, data, 0)
    if ep == 1 and tp == 1:
        out, aux = switch_moe_reference(x, router_w, w_gate, w_up, w_down,
                                        capacity_factor, top_k=top_k,
                                        return_aux=True)
    else:
        if ep > 1 and torch.is_grad_enabled():
            w_gate, w_up, w_down = (_ScaleGrad.apply(w, 1.0 / ep)
                                    for w in (w_gate, w_up, w_down))
        out, aux = switch_moe_local(x, router_w, w_gate, w_up, w_down, mesh,
                                    axis=axis,
                                    capacity_factor=capacity_factor,
                                    top_k=top_k,
                                    tp_axis=tp_axis if tp > 1 else None)
    if ep == 1 and data:
        me = mesh.coord(data)
        out = out[me * n_loc:(me + 1) * n_loc]
    elif data:
        aux = {k: collectives.mean_replicated_grad(v, mesh, data)
               for k, v in aux.items()}
    return (out, aux) if return_aux else out
