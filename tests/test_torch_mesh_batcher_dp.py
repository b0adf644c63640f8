"""``ContinuousBatcher(mesh=)`` on a gloo group of 2 CPU ranks
(``tests/torch_mesh_worker.py``, started once for the file): over
``{"dp": 2}`` (each rank its data shard's 2 rows and sub-pool, whole
params) and ``{"tp": 2}`` (one data shard, heads and vocab cut), the
same feature matrix, the same JAX single-device streams and the same
per-shard invariants as ``test_torch_mesh_batcher.py``, and two
schedule modes (overlap over dp2, the fused tick over tp2); then the
constructor's validation, as the JAX batcher's (``serving.py``
``:1439-1458``): a mesh axis it does not shard over, rows that do not
divide over the data axes, a tp that does not divide a model's heads.

The KV surface over tp2 (one data shard, as the reference's bypass
table allows it): an export gathered over the tp group imports into a
one-process port batcher and into the JAX batcher; a one-process port
export and a JAX export import into the mesh; ``preempt_all`` carries
artifacts (a mid-stream one imports into both one-process batchers); a
session parks and resumes from the KV tier; an adapter fold and
``set_weights`` copy each rank's tp block.  Streams are held to the
JAX single-device batcher's by the JAX mesh tests' 1e-4 tie rule.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mesh_batcher import (CFG, VARIANTS, assert_per_shard,
                                     assert_streams_match, jax_streams,
                                     mesh_cases, mesh_setup, variant_kw)
from torch_mesh_worker import run_cases
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.parallel import mesh as tmesh

WORLD = 2


def _kv_inputs(d):
    """The tp2 KV case's inputs: a one-process port export of request 2
    and a JAX export of request 3 (packed), a seeded 0.5-sigma delta on
    the embedding, and a second seed's params."""
    cfg, params, _, _ = mesh_setup()
    kw, reqs = variant_kw("base")
    tcfg = tt.TransformerConfig(dtype=torch.float32, **CFG)
    port = ts.ContinuousBatcher(tcfg, convert.params_from_jax(params),
                                device="cpu", **kw)
    p, n = reqs[2]
    meta, body = ts.pack_prefilled(port.export_kv(ts.Request(
        np.asarray(p, np.int32), n)))
    (d / "port_art.json").write_text(json.dumps(
        {"meta": meta, "body": bytes(body).hex()}))
    p, n = reqs[3]
    meta, body = js.pack_prefilled(js.ContinuousBatcher(
        cfg, params, **kw).export_kv(js.Request(
            prompt=np.asarray(p, np.int32), max_new_tokens=n)))
    (d / "jax_art.json").write_text(json.dumps(
        {"meta": meta, "body": bytes(body).hex()}))
    embed = params["embed"]
    rng = np.random.default_rng(19)
    np.savez(d / "delta.npz", embed=(rng.standard_normal(embed.shape)
                                     * 0.5 * embed.std()).astype(np.float32))
    params2 = jax.tree_util.tree_map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(2)))
    convert.save_npz(convert.params_from_jax(params2), d / "params2.npz")
    return dict(name="tp2_kv", kind="batcher_kv", axes={"tp": 2}, cfg=CFG,
                params="params.npz", kw=kw, requests=reqs,
                imports={"port_art": 2, "jax_art": 3}, delta="delta.npz",
                params2="params2.npz")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_batcher_dp")
    cases = (mesh_cases(d, {"dp": 2}, VARIANTS + ("overlap",), "dp2")
             + mesh_cases(d, {"tp": 2}, ("base", "int8", "fused"), "tp2"))
    run_cases(cases + [_kv_inputs(d)], WORLD, d)
    return d


@pytest.mark.parametrize("variant", VARIANTS)
def test_dp2_batcher_streams_match_jax_and_recycle(ranks, variant):
    out = json.loads((ranks / f"dp2_{variant}.json").read_text())
    assert_streams_match(variant, out["streams"], jax_streams(variant))
    assert out["n_shards"] == 2 and out["ranks_differ"] == []
    assert_per_shard(out, variant_kw(variant)[0])


@pytest.mark.parametrize("tag,variant", [("dp2", "overlap"),
                                         ("tp2", "fused")])
def test_mesh_batcher_schedule_modes_match_jax(ranks, tag, variant):
    """A schedule mode on a mesh: overlap with 2-step blocks over dp2
    (each shard's device carry its row block's), the fused prefill tick
    over tp2 (a data shard of one; the tick bypasses data shards, as in
    the reference), against the JAX batcher in the same mode."""
    out = json.loads((ranks / f"{tag}_{variant}.json").read_text())
    assert_streams_match(variant, out["streams"], jax_streams(variant))
    assert out["ranks_differ"] == []
    assert_per_shard(out, variant_kw(variant)[0])


@pytest.mark.parametrize("variant", ("base", "int8"))
def test_tp2_batcher_streams_match_jax(ranks, variant):
    out = json.loads((ranks / f"tp2_{variant}.json").read_text())
    assert_streams_match(variant, out["streams"], jax_streams(variant))
    assert out["n_shards"] == 1 and out["ranks_differ"] == []
    assert out["graphs_bypass_reason"] == "gloo collectives"
    assert_per_shard(out, variant_kw(variant)[0])
    # A tp-only mesh exports, takes a KV tier (an int8 pool bypasses it,
    # as on one process) and swaps weights, as the reference does.
    assert out["refused"] == {
        "export_kv": "dict", "set_weights": None,
        "kv_tier": "quantized kv cache" if variant == "int8" else None}


# -- the KV surface over tp2 --------------------------------------------------


def _kv(ranks):
    out = json.loads((ranks / "tp2_kv.json").read_text())
    assert out["n_shards"] == 1 and out["ranks_differ"] == []
    return out


def _tie_match(params, prompt, got, want, what):
    """Token for token, or a float tie at the first difference: the two
    tokens' JAX logits (``params``, float32) within 1e-4."""
    if got == want:
        return
    cfg = mesh_setup()[0]
    div = next(i for i in range(min(len(got), len(want)))
               if got[i] != want[i])
    ctx = np.concatenate([np.asarray(prompt, np.int32),
                          np.asarray(want[:div], np.int32)])
    logits = np.asarray(jt.forward(cfg, jax.tree_util.tree_map(
        jnp.asarray, params), jnp.asarray(ctx[None]))[0, -1])
    gap = abs(float(logits[got[div]]) - float(logits[want[div]]))
    assert gap < 1e-4, (what, div, gap, got, want)


def _one_process_imports(packed, index):
    """A packed mesh artifact imported into a one-process port batcher
    and into the JAX batcher: their streams."""
    cfg, params, _, _ = mesh_setup()
    kw, reqs = variant_kw("base")
    p, n = reqs[index]
    body = bytes.fromhex(packed["body"])
    tb = ts.ContinuousBatcher(tt.TransformerConfig(dtype=torch.float32,
                                                   **CFG),
                              convert.params_from_jax(params), device="cpu",
                              **kw)
    (tc,) = tb.run([ts.Prefilled(ts.Request(np.asarray(p, np.int32), n),
                                 ts.unpack_prefilled(packed["meta"], body))])
    jb = js.ContinuousBatcher(cfg, params, **kw)
    (jc,) = jb.run([js.Prefilled(
        js.Request(prompt=np.asarray(p, np.int32), max_new_tokens=n),
        js.unpack_prefilled(dict(packed["meta"]), body))])
    return tc.tokens, jc.tokens


def test_tp2_export_has_the_one_process_layout(ranks):
    """The export gathered over tp carries every kv head: it imports
    into a one-process port batcher and into the JAX batcher, and both
    decode the JAX single-device stream."""
    out = _kv(ranks)
    params = mesh_setup()[1]
    p = variant_kw("base")[1][0][0]
    arrays = {a["name"]: a["shape"] for a in out["export"]["meta"]["arrays"]}
    assert arrays["k"][2] == CFG["n_heads"] == arrays["v"][2]
    want = jax_streams("base")[0]
    for got in _one_process_imports(out["export"], 0):
        _tie_match(params, p, got, want, "export")


def test_tp2_imports_port_and_jax_artifacts(ranks):
    """A one-process port export and a JAX export, each cut to every
    rank's kv heads on import, decode the JAX single-device stream."""
    out = _kv(ranks)
    params = mesh_setup()[1]
    reqs = variant_kw("base")[1]
    for name, i in (("port_art", 2), ("jax_art", 3)):
        _tie_match(params, reqs[i][0], out["imports"][name],
                   jax_streams("base")[i], name)


def test_tp2_preempt_all_carries_artifacts(ranks):
    """``preempt_all`` on a tp mesh suspends decoding rows WITH their
    artifacts (no bare requeue), every request re-imports to the JAX
    stream, and a mid-stream artifact resumes in a one-process port
    batcher and in the JAX batcher alike."""
    out = _kv(ranks)
    params = mesh_setup()[1]
    reqs = variant_kw("base")[1]
    assert out["suspended"] >= out["carried"] >= 1
    assert "mid_stream" in out
    want = jax_streams("base")
    assert sorted(out["preempt"]) == [str(i) for i in range(len(reqs))]
    for i, got in out["preempt"].items():
        _tie_match(params, reqs[int(i)][0], got, want[int(i)],
                   f"preempt {i}")
    i = out["mid_stream"]["index"]
    for got in _one_process_imports(out["mid_stream"], i):
        _tie_match(params, reqs[i][0], got, want[i], "mid-stream")


def test_tp2_session_parks_and_resumes(ranks):
    """A session parked on the tp mesh (the export gathered over tp)
    resumes its next turn from the tier: the resumed stream is the cold
    full-history prefill's and the JAX batcher's."""
    out = _kv(ranks)["session"]
    cfg, params, _, _ = mesh_setup()
    kw, reqs = variant_kw("base")
    assert out["resume"] == 1
    assert out["history"][:len(reqs[1][0])] == reqs[1][0]
    (jc,) = js.ContinuousBatcher(cfg, params, **kw).run([js.Request(
        prompt=np.asarray(out["history"], np.int32),
        max_new_tokens=reqs[1][1])])
    for got in (out["resumed"], out["cold"]):
        _tie_match(params, out["history"], got, jc.tokens, "session")


def test_tp2_weight_swaps_match_jax(ranks):
    """An adapter fold (the delta whole, each rank adding its block) and
    ``set_weights`` (a whole tree, each rank keeping its block) decode
    the JAX batcher's streams on the same weights."""
    out = _kv(ranks)["swaps"]
    cfg, params, _, _ = mesh_setup()
    kw, reqs = variant_kw("base")
    p, n = reqs[0]
    assert out["weight_swaps"] == 2 and out["adapter_version"] == ""
    delta = np.load(ranks / "delta.npz")["embed"]
    folded = dict(params, embed=params["embed"] + delta)
    params2 = jax.tree_util.tree_map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(2)))
    for got, ps, what in ((out["folded"], folded, "fold"),
                          (out["set"], params2, "set")):
        (jc,) = js.ContinuousBatcher(cfg, ps, **kw).run([js.Request(
            prompt=np.asarray(p, np.int32), max_new_tokens=n)])
        _tie_match(ps, p, got, jc.tokens, what)


def _view(axes, rank=0):
    n = int(np.prod(list(axes.values())))
    return tmesh.RankMesh(tmesh.resolve_axes(axes, n), rank, "cpu",
                          make_groups=False)


@pytest.mark.parametrize("axes,kw,match", [
    ({"dp": 2, "tp": 2}, dict(rows=3), r"rows \(3\) must divide over the "
                                       r"mesh data axes \(2\)"),
    ({"fsdp": 4}, dict(rows=6), r"rows \(6\) must divide over the mesh "
                                r"data axes \(4\)"),
    ({"tp": 4}, dict(rows=4), r"tp \(4\) must divide kv_heads \(2\) and "
                              r"n_heads \(4\)"),
    ({"tp": 2}, dict(rows=2, draft=3), r"tp \(2\) must divide kv_heads "
                                       r"\(3\) and n_heads \(3\)"),
])
def test_mesh_batcher_validation_errors(axes, kw, match):
    cfg = tt.TransformerConfig(dtype=torch.float32,
                               **dict(CFG, n_kv_heads=2))
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    kw = dict(kw, max_len=32, page_size=8, prefill_bucket=8, device="cpu")
    if "draft" in kw:
        h = kw.pop("draft")
        dcfg = tt.TransformerConfig(vocab_size=128, d_model=12, n_heads=h,
                                    n_layers=1, d_ff=16, max_seq_len=64,
                                    dtype=torch.float32)
        kw.update(draft_cfg=dcfg, draft_params=tt.init_params(
            dcfg, torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match=match):
        ts.ContinuousBatcher(cfg, params, mesh=_view(axes), **kw)
