"""The port's mesh, sharding and partition specs against the JAX
package's on a virtual 8-device mesh (one process, no process group):
the axes a mesh resolves to and its rank layout, every rank's block of
every parameter leaf against the device shard JAX's ``NamedSharding``
gives it (``partition_specs`` over dp/fsdp x tp with a GQA kv width),
a vocab tp does not divide, the data/fsdp/batch rules, the validation
errors, and the
multi-rank dry run (four gloo ranks against one process's step).
Exact: blocks are slices, compared bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.parallel import sharding as jsh
from tfmesos_tpu.parallel.mesh import build_mesh as j_build_mesh
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.ops.quant import QTensor
from tfmesos_tpu_torch.parallel import mesh as tmesh
from tfmesos_tpu_torch.parallel import sharding as tsh

MESHES = [{"tp": 2}, {"fsdp": 2}, {"dp": 2, "tp": 2}, {"fsdp": 2, "tp": 2},
          {"dp": 2, "fsdp": 2}, {"dp": 2, "fsdp": 2, "tp": 2}, {"tp": 4},
          {"fsdp": 4}]


def _n(axes):
    return int(np.prod(list(axes.values())))


def _views(axes):
    """The port's mesh as each of its ranks sees it (no groups)."""
    spec = tmesh.resolve_axes(axes, _n(axes))
    return [tmesh.RankMesh(spec, r, "cpu", make_groups=False)
            for r in range(_n(axes))]


def _spec_p(spec):
    return P(*spec)


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_partition_specs_are_the_jax_specs(axes):
    """The spec tree equals the JAX ``partition_specs`` entry for entry
    (dense config, axes of size 1 dropped)."""
    kw = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
              max_seq_len=64, n_kv_heads=4 if axes.get("tp") == 4 else 2)
    jcfg = jt.TransformerConfig(**kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    jmesh = j_build_mesh(axes, devices=jax.devices()[:_n(axes)])
    want = jt.partition_specs(jcfg, jmesh)
    got = tt.partition_specs(tcfg, _views(axes)[0])
    assert sorted(got) == sorted(want)
    for k in ("embed", "norm_f", "head"):
        assert _spec_p(got[k]) == want[k], k
    for k, s in got["layers"].items():
        assert _spec_p(s) == want["layers"][k], k


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_every_rank_cuts_the_block_jax_places_on_its_device(axes):
    """Each rank's ``place_tree`` block of each leaf is the slice JAX's
    ``NamedSharding`` puts on the device of the same index; over a
    ``quantize_params`` tree each rank's int8 block dequantizes to the
    block of the dequantized leaf (its scales whole on their size-1
    dim)."""
    kw = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
              max_seq_len=64, n_kv_heads=4 if axes.get("tp") == 4 else 2)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    full = tt.init_params(tcfg, torch.Generator().manual_seed(0))
    views = _views(axes)
    jmesh = j_build_mesh(axes, devices=jax.devices()[:_n(axes)])
    devices = list(jmesh.devices.flat)
    specs = tt.partition_specs(tcfg, views[0])
    qfull = tt.quantize_params(tcfg, full)
    blocks = [tsh.place_tree(v, full, specs) for v in views]
    qblocks = [tsh.place_tree(v, qfull, specs) for v in views]

    def leaves(tree):
        return [(k, tree[k]) for k in ("embed", "norm_f", "head")] + [
            (f"layers/{k}", v) for k, v in tree["layers"].items()]

    for name, leaf in leaves(full):
        parts = name.split("/")
        spec = specs[parts[0]] if len(parts) == 1 else \
            specs["layers"][parts[1]]
        index = NamedSharding(jmesh, _spec_p(spec)).devices_indices_map(
            tuple(leaf.shape))
        for r, dev in enumerate(devices):
            got = dict(leaves(blocks[r]))[name]
            np.testing.assert_array_equal(got.numpy(),
                                          leaf.numpy()[index[dev]],
                                          err_msg=f"{name} rank {r}")
            q = dict(leaves(qblocks[r]))[name]
            if isinstance(q, QTensor):
                qw = dict(leaves(qfull))[name].dequantize()
                np.testing.assert_array_equal(q.dequantize().numpy(),
                                              qw.numpy()[index[dev]],
                                              err_msg=f"int8 {name} {r}")


@pytest.mark.parametrize("tp", [2, 4])
def test_an_uneven_vocab_cuts_into_ceil_blocks(tp):
    """A vocab tp does not divide (the tiny preset's 97): rank i holds
    rows [i * ceil(97 / tp), ...), the last block shorter, as GSPMD pads
    the last shard; the blocks tile the table."""
    table = torch.arange(97 * 3, dtype=torch.float32).reshape(97, 3)
    views = _views({"tp": tp})
    parts = [tsh.cut(table, ("tp", None), v) for v in views]
    b = -(-97 // tp)
    assert [p.shape[0] for p in parts] == [b] * (tp - 1) + [97 - b * (tp - 1)]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), table.numpy())


def test_mesh_layout_groups_and_local_mesh():
    """Ranks are row-major over dp, fsdp, tp (tp innermost, as JAX lays
    devices out); ``only`` keeps an axis and its coordinates; a size-1
    mesh is a ``LocalMesh`` without groups."""
    views = _views({"dp": 2, "fsdp": 2, "tp": 2})
    jmesh = j_build_mesh({"dp": 2, "fsdp": 2, "tp": 2},
                         devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    base = int(ids.min())
    for v in views:
        c = (v.coord("dp"), v.coord("fsdp"), v.coord("tp"))
        assert int(ids[c]) - base == v.rank
        assert v.coord(("dp", "fsdp")) == 2 * c[0] + c[1]
        tp_only = v.only("tp")
        assert tp_only.axes == {"tp": 2} and tp_only.coord("tp") == c[2]
        assert tp_only.axis_size(("dp", "fsdp")) == 1
    assert views[0].mesh_dim_names == ("dp", "fsdp", "tp")
    assert views[0].data_axes == ("dp", "fsdp") and views[0].tp == 2
    assert views[3].size() == 8 and views[3].size("tp") == 2
    assert views[3].shape == (2, 2, 2)
    local = tmesh.build_mesh({"tp": 1, "fsdp": 1}, world_size=1)
    assert isinstance(local, tmesh.LocalMesh)
    assert local.mesh_dim_names == ("fsdp",) and local.size() == 1
    assert local.group("tp") is None
    with pytest.raises(RuntimeError, match="no process group"):
        local.get_group()


DCN_MESHES = [{"dcn.dp": 2, "dp": 2, "tp": 2}, {"dcn.dp": 2, "tp": 4},
              {"dcn.tp": 2, "dp": 2, "tp": 2},
              {"dcn.dp": 2, "dcn.fsdp": 2, "tp": 2},
              {"dcn.fsdp": 2, "fsdp": -1, "tp": 2}]


@pytest.mark.parametrize("axes", DCN_MESHES, ids=str)
def test_dcn_rank_grid_is_the_jax_hybrid_device_grid(axes):
    """``dcn.`` axes: every rank's coordinates put it where JAX's
    ``build_hybrid_mesh`` puts the device of the same index on 8 virtual
    CPU devices (slices are contiguous blocks, each axis's dcn index
    its outer factor), and the mesh's axis sizes are JAX's."""
    jmesh = j_build_mesh(axes, devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    ids = ids - int(ids.min())
    spec = tmesh.resolve_axes(axes, 8)
    assert spec == dict(jmesh.shape)
    names = tuple(jmesh.axis_names)
    dcn = tmesh.resolve_dcn(axes)
    seen = set()
    for r in range(8):
        v = tmesh.RankMesh(spec, r, "cpu", make_groups=False, dcn=dcn)
        c = tuple(v.coord(a) for a in names)
        assert int(ids[c]) == r, (r, c)
        seen.add(c)
    assert len(seen) == 8


def test_dcn_axes_refusals_are_the_jax_ones():
    """-1 is refused on a dcn axis, the slice count must divide the
    ranks and the ici axes must fill one slice; pp, sp and ep pass under
    the prefix as they do without (``dcn.pp=2,dp=2`` resolves to JAX's
    hybrid mesh shape), and an unknown axis is refused under it too."""
    with pytest.raises(ValueError, match="dcn axes need explicit sizes"):
        tmesh.check_axes({"dcn.dp": -1, "tp": 2})
    with pytest.raises(ValueError, match="dcn axes need explicit sizes"):
        j_build_mesh({"dcn.dp": -1, "tp": 2}, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="not divisible into 3 slices"):
        tmesh.resolve_axes({"dcn.dp": 3, "tp": 2}, 8)
    with pytest.raises(ValueError, match="ranks per slice"):
        tmesh.resolve_axes({"dcn.dp": 2, "tp": 2}, 8)
    assert tmesh.check_axes({"dcn.pp": 2, "dp": 2}) == {"dcn.pp": 2,
                                                         "dp": 2}
    jshape = dict(j_build_mesh({"dcn.pp": 2, "dp": 2},
                               devices=jax.devices()[:4]).shape)
    assert tmesh.resolve_axes({"dcn.pp": 2, "dp": 2}, 4) == {
        a: s for a, s in jshape.items() if s > 1}
    with pytest.raises(ValueError, match="unknown mesh axis xx"):
        tmesh.check_axes({"dcn.xx": 2, "dp": 2})
    assert tmesh.resolve_axes({"dcn.sp": 2, "ep": 2}, 4) == {"ep": 2,
                                                             "sp": 2}
    assert tmesh.resolve_axes({"dcn.dp": 2, "dp": -1}, 8) == {"dp": 8}
    assert repr(tmesh.RankMesh({"dp": 4, "tp": 2}, 0, "cpu",
                               make_groups=False, dcn={"dp": 2})) == \
        "RankMesh((dcn.dp=2, dp=4, tp=2), 'cpu')"


@pytest.mark.parametrize("axes", [{"dp": 2}, {"dp": 2, "fsdp": 2},
                                  {"dp": 2, "tp": 2}, {"tp": 2}], ids=str)
def test_data_fsdp_and_batch_rules_are_the_jax_rules(axes):
    view = _views(axes)[0]
    jmesh = j_build_mesh(axes, devices=jax.devices()[:_n(axes)])
    assert tsh.data_axes(view) == jsh.data_axes(jmesh)
    assert _spec_p(tsh.batch_spec(view, extra_dims=1)) == \
        jsh.batch_spec(jmesh, extra_dims=1)
    for shape in [(64, 32), (3, 5), (48, 64, 96), (2, 1024), (7, 300)]:
        want = tuple(jsh.fsdp_spec(shape, jmesh))   # P() = all whole
        assert tsh.fsdp_spec(shape, view) == \
            want + (None,) * (len(shape) - len(want))
    data = next((a for a in ("fsdp", "dp") if a in axes), None)
    rules = {"wq": P(None, data, "tp" if "tp" in axes else None),
             "norm": P(None)}
    tree = {"layers": {"wq": np.zeros((2, 4, 8), np.float32),
                       "attn_norm": np.zeros((2, 4), np.float32)},
            "embed": np.zeros((8, 4), np.float32)}
    got = tsh.apply_rules({k: tuple(v) for k, v in rules.items()},
                          convert.params_from_jax(tree), view)
    want = jsh.apply_rules(rules, tree, jmesh)
    assert _spec_p(got["layers"]["wq"]) == \
        jt._filter_spec(want["layers"]["wq"].spec, jmesh)
    assert got["embed"] == (None, None)


def test_make_global_batch_gives_each_data_shard_its_rows():
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3)}
    for axes in ({"dp": 2, "tp": 2}, {"fsdp": 4}, {"tp": 2}):
        for v in _views(axes):
            got = tsh.make_global_batch(v, batch)["tokens"].numpy()
            nd = v.axis_size(("dp", "fsdp"))
            i = v.coord(("dp", "fsdp"))
            np.testing.assert_array_equal(
                got, batch["tokens"][i * 8 // nd:(i + 1) * 8 // nd])


def test_validation_errors_name_the_rule():
    """The JAX package's checks: tp must divide the kv projection width
    and both head counts; cut dims over a mesh that does not cover
    them."""
    cfg = tt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_kv_heads=1, n_layers=1, d_ff=64,
                               dtype=torch.float32)
    view = _views({"tp": 2})[0]
    with pytest.raises(ValueError, match="must divide the GQA kv "
                                         "projection width"):
        tt.partition_specs(dataclass_replace(cfg, d_model=18, n_heads=3,
                                             n_kv_heads=1),
                           _views({"tp": 4})[0])
    with pytest.raises(ValueError, match=r"tp \(2\) must divide kv_heads"):
        tt.init_paged_cache(cfg, 8, 8, mesh=view)
    with pytest.raises(ValueError, match=r"must divide over the mesh data"):
        tt.init_cache(dataclass_replace(cfg, n_kv_heads=2), 3, 16,
                      mesh=_views({"dp": 2})[0])
    with pytest.raises(ValueError, match="at most one axis may be -1"):
        tmesh.resolve_axes({"dp": -1, "tp": -1}, 4)


def dataclass_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def test_dryrun_multichip_holds_four_ranks_to_one_process():
    """``dryrun_multichip(4)``: dp=2 x tp=2 gloo ranks on the CPU, one
    sharded step of the tiny transformer within 1e-5 of one process."""
    from tfmesos_tpu_torch.dryrun import TOL, dryrun_multichip

    out = dryrun_multichip(4, timeout=200.0)
    assert out["mesh"] == {"dp": 2, "tp": 2}
    assert abs(out["loss"] - out["ref_loss"]) <= TOL
    assert max(out["grad_err"], out["param_err"], out["norm_err"]) <= TOL


@pytest.mark.parametrize("axis", ["sp", "ep"])
def test_dryrun_multichip_sp_and_ep_factorizations(axis):
    """The dry run's other factorizations over 4 gloo ranks: dp=2 x sp=2
    (the ring) and dp=2 x ep=2 (a dense-MoE tiny model), one sharded
    step within 1e-5 of one process."""
    from tfmesos_tpu_torch.dryrun import (TOL, dryrun_multichip,
                                          factorizations)

    axes = {"dp": 2, axis: 2}
    assert axes in factorizations(4)
    out = dryrun_multichip(4, timeout=200.0, axes=axes)
    assert out["mesh"] == axes
    assert abs(out["loss"] - out["ref_loss"]) <= TOL
    assert max(out["grad_err"], out["param_err"], out["norm_err"]) <= TOL
