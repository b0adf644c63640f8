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
"""

import json

import numpy as np
import pytest
import torch
from test_torch_mesh_batcher import (CFG, VARIANTS, assert_per_shard,
                                     assert_streams_match, jax_streams,
                                     mesh_cases, variant_kw)
from torch_mesh_worker import run_cases
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.parallel import mesh as tmesh

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_batcher_dp")
    cases = (mesh_cases(d, {"dp": 2}, VARIANTS + ("overlap",), "dp2")
             + mesh_cases(d, {"tp": 2}, ("base", "int8", "fused"), "tp2"))
    run_cases(cases, WORLD, d)
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
    assert out["refused"]["export_kv"] == (
        "NotImplementedError: not ported yet: export_kv on a tp mesh")
    assert out["refused"]["kv_tier"] == (
        "quantized kv cache" if variant == "int8" else
        "NotImplementedError: not ported yet: the KV tier on a tp mesh")


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
