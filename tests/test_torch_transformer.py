"""The port's transformer against the JAX package on the CPU (float32):
weights from the JAX ``init_params`` carried across by
``convert.params_from_jax``, the same tokens through both.

Tolerances: logits atol 1e-4 (two float32 layers of matmuls summed in
different orders by XLA and PyTorch), pool contents atol 1e-5 (the
committed K/V are one projection plus rope away from the embeddings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch.models import presets
from tfmesos_tpu_torch.models import transformer as tt

LOGITS_ATOL = 1e-4
POOL_ATOL = 1e-5

# The CI model of fleet/replica.tiny_model, and its GQA variant.
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}


def _pair(kind):
    base = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                max_seq_len=128, **VARIANTS[kind])
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **base)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(3))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("kind", sorted(VARIANTS))
def test_forward_logits_match_jax(kind):
    jcfg, jp, tcfg, tp = _pair(kind)
    tokens = np.random.RandomState(0).randint(0, 97, (2, 24)).astype(
        np.int32)
    want = np.asarray(jt.forward(jcfg, jp, jnp.asarray(tokens)))
    got = tt.forward(tcfg, tp, _t(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("kind", sorted(VARIANTS))
def test_paged_decode_matches_jax(kind):
    """Prefill two rows from empty, then 4 ragged single-token steps over
    the paged pool: per-step logits and the final pool contents."""
    jcfg, jp, tcfg, tp = _pair(kind)
    rng = np.random.RandomState(1)
    ps, width = 16, 16
    alloc, talloc = jt.PageAllocator(12, ps), tt.PageAllocator(12, ps)
    for r in range(2):
        alloc.ensure(r, width + 8)
        talloc.ensure(r, width + 8)
    table = np.asarray(alloc.table([0, 1], width=3))
    assert np.array_equal(talloc.table([0, 1], width=3).numpy(), table)
    jcache = dict(jt.init_paged_cache(jcfg, 12, ps), pages=jnp.asarray(table))
    tcache = dict(tt.init_paged_cache(tcfg, 12, ps), pages=_t(table))

    prompt = rng.randint(0, 97, (2, width)).astype(np.int32)
    jl, jcache = jt.decode_step(jcfg, jp, jcache, jnp.asarray(prompt), 0)
    tl, tcache = tt.decode_step(tcfg, tp, tcache, _t(prompt).long(), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=LOGITS_ATOL, rtol=0)

    pos = np.array([10, 16], np.int32)      # ragged: row 0 is shorter
    for _ in range(4):
        tok = rng.randint(0, 97, (2, 1)).astype(np.int32)
        jl, jcache = jt.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = tt.decode_step(tcfg, tp, tcache, _t(tok).long(),
                                    _t(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, rtol=0)
        pos = pos + 1
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tcache[leaf].numpy(),
                                   np.asarray(jcache[leaf]),
                                   atol=POOL_ATOL, rtol=0)


def test_init_params_layout_matches_jax():
    """Same tree, shapes and dtypes as the JAX init; same scales (a
    weight's std tracks the JAX init's within sampling error)."""
    jcfg, jp, tcfg, _ = _pair("gqa")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0))
    jflat = convert.flatten(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    tflat = convert.flatten(tp)
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        assert tflat[k].shape == jflat[k].shape, k
        assert tflat[k].dtype == jflat[k].dtype == torch.float32, k
        js, ts = float(jflat[k].std()), float(tflat[k].std())
        assert abs(js - ts) <= 0.2 * js + 1e-6, (k, js, ts)


def test_npz_round_trip(tmp_path):
    cfg, params = presets.tiny_model(seed=4)
    path = str(tmp_path / "w.npz")
    convert.save_npz(params, path)
    back = convert.load_npz(path)
    a, b = convert.flatten(params), convert.flatten(back)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_bf16_leaves_convert_through_float32():
    """An ml_dtypes bfloat16 leaf (what np.asarray gives for a bf16 JAX
    array) arrives as a torch bfloat16 tensor with the same values."""
    x = np.asarray(jnp.asarray([[1.5, -2.25], [3.0, 0.125]], jnp.bfloat16))
    got = convert.params_from_jax({"w": x})["w"]
    assert got.dtype == torch.bfloat16
    assert got.float().tolist() == [[1.5, -2.25], [3.0, 0.125]]


def test_moe_configs_are_refused():
    """MoE configs are ported: the config builds with the JAX fields and
    its params carry the expert leaves instead of the MLP's; only an
    unknown ``moe_impl`` is refused."""
    cfg = tt.TransformerConfig(vocab_size=64, d_model=16, n_layers=1,
                               n_heads=2, d_ff=32, n_experts=4, top_k=2)
    layers = tt.init_params(cfg, torch.Generator().manual_seed(0))["layers"]
    assert layers["e_gate"].shape == (1, 4, 16, 32)
    assert "w_gate" not in layers and layers["router"].shape == (1, 16, 4)
    with pytest.raises(ValueError, match="moe_impl"):
        tt.TransformerConfig(n_experts=4, moe_impl="sparse")


def test_entry_runs_the_flagship_forward_shape_on_cpu():
    """entry() hands back the flagship forward at [4, 1024]; here only
    its contract is checked (one layer of the real shapes would take
    the CPU tens of seconds)."""
    fn, (params, tokens) = tt.entry(device="cpu")
    assert tokens.shape == (4, 1024)
    assert params["embed"].shape == (8192, 512)
    assert params["layers"]["wq"].shape == (8, 512, 512)
    assert callable(fn)
