"""``ContinuousBatcher(mesh=)`` over dp2 x tp2 on a gloo group of 4 CPU
ranks (``tests/torch_mesh_worker.py``, started once for the file)
against the JAX package's single-device batcher, over the feature
matrix of the JAX ``test_mesh_batcher_token_identical``: base,
speculative decoding with chunked prefill and a static prefix, sampled
streams, and an int8 pool; then the per-shard invariants (every data
shard's sub-pool recycled to its sink and its static-prefix pages, each
rank's streams equal to rank 0's) and the graphs bypass a gloo mesh
names.  Streams are held to JAX's token for token, but where the tp
partial sums land on a float tie: at a first difference the two tokens'
JAX logits must lie within 1e-4 (the JAX test's own rule).  The config
is the JAX test's: vocab, heads and d_ff divisible by tp.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_mesh_worker import run_cases
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu_torch import convert

WORLD = 4
AXES = {"dp": 2, "tp": 2}
CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
           max_seq_len=128)
DCFG = dict(vocab_size=128, d_model=16, n_layers=1, n_heads=2, d_ff=32,
            max_seq_len=128)
VARIANTS = ("base", "spec_chunk_prefix", "sampled", "int8")


@functools.lru_cache(maxsize=None)
def mesh_setup():
    cfg = jt.TransformerConfig(dtype=jnp.float32, **CFG)
    dcfg = jt.TransformerConfig(dtype=jnp.float32, **DCFG)
    params = jax.tree_util.tree_map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(0)))
    dparams = jax.tree_util.tree_map(
        np.asarray, jt.init_params(dcfg, jax.random.PRNGKey(5)))
    return cfg, params, dcfg, dparams


def variant_kw(variant):
    """(the batcher's kwargs, the requests): the JAX test's."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 128, size=n).astype(np.int32)
               for n in (3, 8, 13, 19, 16, 5)]
    reqs = [(p.tolist(), 2 + (i % 4)) for i, p in enumerate(prompts)]
    kw = dict(rows=4, max_len=96, page_size=16, prefill_bucket=16)
    if variant == "spec_chunk_prefix":
        kw.update(prefix=rng.randint(0, 128, size=13).tolist(),
                  prefill_chunk=8, n_draft=3, draft="draft")
    elif variant == "sampled":
        kw.update(temperature=0.8, top_k=20, rng=3)
    elif variant == "int8":
        kw.update(quantized_cache=True)
    elif variant == "fused":
        kw.update(prefill_chunk=8, fused_prefill=True)
    elif variant == "overlap":
        kw.update(overlap=True, multi_step=2)
    return kw, reqs


@functools.lru_cache(maxsize=None)
def jax_streams(variant):
    cfg, params, dcfg, dparams = mesh_setup()
    kw, reqs = variant_kw(variant)
    kw = dict(kw)
    if kw.pop("draft", None):
        kw.update(draft_cfg=dcfg, draft_params=dparams)
    if "prefix" in kw:
        kw["prefix"] = np.asarray(kw["prefix"], np.int32)
    if "rng" in kw:
        kw["rng"] = jax.random.PRNGKey(kw["rng"])
    b = js.ContinuousBatcher(cfg, params, **kw)
    return {c.rid: c.tokens for c in b.run(
        [js.Request(prompt=np.asarray(p, np.int32), max_new_tokens=n)
         for p, n in reqs])}


def mesh_cases(d, axes, variants, world_tag):
    """Write the inputs and one ``batcher`` case a variant."""
    cfg, params, dcfg, dparams = mesh_setup()
    convert.save_npz(convert.params_from_jax(params), d / "params.npz")
    convert.save_npz(convert.params_from_jax(dparams), d / "dparams.npz")
    cases = []
    for v in variants:
        kw, reqs = variant_kw(v)
        if kw.pop("draft", None):
            kw.update(draft_cfg=DCFG, draft_params="dparams.npz")
        cases.append(dict(name=f"{world_tag}_{v}", kind="batcher", axes=axes,
                          cfg=CFG, params="params.npz", kw=kw,
                          requests=reqs))
    return cases


def assert_streams_match(variant, got, want):
    """Token for token, or a float tie at the first difference (the
    JAX test's ``_assert_tokens_match_modulo_ties`` at 1e-4)."""
    cfg, params, _, _ = mesh_setup()
    kw, reqs = variant_kw(variant)
    for rid, w in want.items():
        g = got[str(rid)]
        if g == w:
            continue
        div = next(i for i in range(min(len(g), len(w))) if g[i] != w[i])
        ctx = np.concatenate([np.asarray(kw.get("prefix", []), np.int32),
                              np.asarray(reqs[rid][0], np.int32),
                              np.asarray(w[:div], np.int32)])
        logits = np.asarray(jt.forward(cfg, jax.tree_util.tree_map(
            jnp.asarray, params), jnp.asarray(ctx[None]))[0, -1])
        gap = abs(float(logits[g[div]]) - float(logits[w[div]]))
        assert gap < 1e-4, (variant, rid, div, gap, g, w)


def assert_per_shard(out, kw):
    """Every sub-pool recycled: a shard keeps only its sink and static
    prefix pages; no row holds pages."""
    n_res = 1 + (-(-len(kw["prefix"]) // kw["page_size"])
                 if "prefix" in kw else 0)
    assert out["rows_left"] == [0] * len(out["free"])
    for free, per in zip(out["free"], out["per_shard"]):
        assert free == [per - n_res] * out["n_shards"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_batcher")
    run_cases(mesh_cases(d, AXES, VARIANTS, "dp2tp2"), WORLD, d)
    return d


@pytest.mark.parametrize("variant", VARIANTS)
def test_dp2_tp2_batcher_streams_match_jax(ranks, variant):
    """dp2 x tp2: each data shard's 2 rows and sub-pool, each tp rank
    its heads; streams against the JAX single-device batcher."""
    out = json.loads((ranks / f"dp2tp2_{variant}.json").read_text())
    assert_streams_match(variant, out["streams"], jax_streams(variant))


@pytest.mark.parametrize("variant", VARIANTS)
def test_dp2_tp2_batcher_recycles_every_shard(ranks, variant):
    """Each data shard's sub-pool back to its reservations, every rank's
    streams equal to rank 0's (a digest all-gathered over the mesh),
    the graphs bypass named, and the surfaces data shards do not have
    refused by name (KV export, as the reference refuses it on data
    shards) or bypassed (the KV tier, as the reference's); weight swaps
    run on any mesh (each rank copies its tp block)."""
    out = json.loads((ranks / f"dp2tp2_{variant}.json").read_text())
    assert out["n_shards"] == 2 and out["ranks_differ"] == []
    assert out["graphs_bypass_reason"] == "gloo collectives"
    assert_per_shard(out, variant_kw(variant)[0])
    assert out["refused"] == {
        "export_kv": "ValueError: export_kv requires a single-shard pool "
                     "(mesh data shards pin pages locally)",
        "set_weights": None,
        "kv_tier": "mesh data sharding"}
