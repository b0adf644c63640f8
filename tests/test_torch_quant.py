"""The port's int8 quantization against the JAX package on the CPU.

Round-to-nearest must be BIT-exact: the same int8 values and the same
float32 scales as the JAX ground truth (``quantize_int8_reference``),
for float32 and bf16 input, zero rows, ties (half to even) and the ±127
clip; the JAX Pallas kernel run in interpret mode is held as
tests/test_quant.py holds it (see ``_assert_near_interpreted_kernel``).
Stochastic
rounding draws from Philox here and from the TPU's PRNG or threefry in
JAX, so it is held to JAX statistically, as tests/test_quant.py holds
the JAX paths.  ``quantize_params`` must give every leaf bit-equal to
the JAX ``quantize_params``, and ``convert`` must carry QTensors across
(int8 kept).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.ops import quant as jq
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.ops import quant as tq

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _assert_bit_equal(got, want):
    tv, ts = got
    jv, js = (np.asarray(a) for a in want)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tv.numpy(), jv)
    assert np.array_equal(ts.numpy(), js)


def _assert_near_interpreted_kernel(got, want):
    """Against the JAX kernel in interpret mode: XLA's interpreted kernel
    computes some rows' absmax / 127 one ulp off the reference (which
    the port matches bit for bit), so its scales are held at rtol 1e-6,
    as tests/test_quant.py holds them, and a value that sits on a .5
    boundary may round one level apart."""
    tv, ts = got
    jv, js = (np.asarray(a) for a in want)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=0)
    diff = np.abs(tv.numpy().astype(np.int32) - jv.astype(np.int32))
    assert diff.max() <= 1 and diff.sum() <= max(1, diff.size // 1000)


@pytest.mark.parametrize("shape", [(64, 256), (33, 100), (8, 512)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_round_to_nearest_bit_equal_to_jax(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x = (np.random.RandomState(sum(shape)).randn(*shape) * 3).astype(
        np.float32)
    xj, xt = jnp.asarray(x).astype(jdt), _t(x).to(tdt)
    got = tq.quantize_int8(xt)
    _assert_bit_equal(got, jq.quantize_int8_reference(xj))
    _assert_near_interpreted_kernel(got, jq.quantize_int8(
        xj, use_pallas=True, interpret=True))
    _assert_bit_equal(tq.quantize_int8_reference(xt),
                      jq.quantize_int8_reference(xj))


def test_zero_rows_ties_and_clip():
    x = np.zeros((4, 16), np.float32)
    # Row 1: scale 1 (absmax 127), so the scaled values ARE these — the
    # .5 ties round half to even.
    x[1, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    # Row 2: the extremes land exactly on ±127 — never -128.
    x[2, :3] = [-3.0, 3.0, 1.0]
    x[3] = np.linspace(-5, 5, 16)
    got = tq.quantize_int8(_t(x))
    _assert_bit_equal(got, jq.quantize_int8_reference(jnp.asarray(x)))
    _assert_near_interpreted_kernel(got, jq.quantize_int8(
        jnp.asarray(x), use_pallas=True, interpret=True))
    v, s = got
    assert v[0].abs().max() == 0 and float(s[0, 0]) == 1.0   # zero row
    assert v[1, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert v[2, :2].tolist() == [-127, 127]
    assert int(v.min()) >= -127


def test_stochastic_rounding_unbiased():
    """The statistics of tests/test_quant.py: a value exactly between
    two levels rounds both ways, averaging to the true value, and seeds
    differ; the dither never pushes past ±127."""
    x = torch.full((8, 128), 0.5)
    x[:, 0] = 127.0                        # pins every row's scale to 1
    totals = []
    for seed in range(8):
        v, s = tq.quantize_int8(x, stochastic=True, seed=seed)
        assert torch.equal(s, torch.ones(8, 1))
        totals.append(tq.dequantize_int8(v, s)[:, 1:].numpy())
    mean = np.mean(totals)
    assert 0.3 < mean < 0.7        # deterministic rounding gives 0 or 1
    assert np.std([np.mean(t) for t in totals]) > 0          # seeds differ
    v, _ = tq.quantize_int8(torch.tensor([[127.0, -127.0, 126.9, -126.9]]),
                            stochastic=True, seed=3)
    assert v[0, :2].tolist() == [127, -127]
    # JAX's stochastic path has the same statistics on the same input.
    jtot = [np.asarray(jq.dequantize_int8(*jq.quantize_int8(
        jnp.asarray(x.numpy()), stochastic=True, seed=seed,
        interpret=True)))[:, 1:] for seed in range(8)]
    assert abs(np.mean(jtot) - mean) < 0.1


def test_philox_matches_the_published_vector():
    """Philox4x32-10 at counter 0, key 0 (Random123's known-answer
    vector): the first word is 0x6627e8d5 — the generator the kernel
    and the plain version share is the standard one."""
    assert int(tq._philox_bits(0, 1, 1, "cpu")[0, 0]) == 0x6627E8D5
    bits = tq._philox_bits(5, 3, 4, "cpu")
    assert bits.shape == (3, 4) and len(set(bits.flatten().tolist())) == 12
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32


def test_quantize_tensor_shapes_and_dequantize():
    w = torch.randn(2, 5, 12, generator=torch.Generator().manual_seed(0))
    qt = tq.quantize_tensor(w)
    assert qt.values.shape == (2, 5, 12) and qt.scales.shape == (2, 5, 1)
    err = (qt.dequantize() - w).abs().max()
    assert err <= qt.scales.max() / 2 + 1e-6    # half a step per row
    with pytest.raises(ValueError):
        tq.quantize_int8(torch.zeros(2, 3, 4))


def _tiny_pair():
    base = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=64, max_seq_len=128)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **base)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, jp, tcfg, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))


def test_quantize_params_bit_equal_to_jax():
    jcfg, jp, tcfg, tp = _tiny_pair()
    want = convert.flatten(convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jt.quantize_params(jcfg, jp))))
    got = convert.flatten(tt.quantize_params(tcfg, tp))
    assert sorted(got) == sorted(want)
    assert "layers/wq/values" in got and "norm_f" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    n_int8 = sum(v.dtype == torch.int8 for v in got.values())
    assert n_int8 == 9           # embed, head and 7 projection leaves


def test_qtensor_round_trip_through_convert(tmp_path):
    """A JAX quantize_params tree arrives as port QTensors (detected by
    their fields), survives save_npz/load_npz with int8 values kept, and
    goes back to numpy keeping int8."""
    jcfg, jp, _, _ = _tiny_pair()
    jq_tree = jax.tree_util.tree_map(np.asarray,
                                     jt.quantize_params(jcfg, jp))
    tp = convert.params_from_jax(jq_tree)
    assert isinstance(tp["head"], tq.QTensor)
    assert tp["head"].values.dtype == torch.int8
    assert isinstance(tp["norm_f"], torch.Tensor)
    path = str(tmp_path / "q.npz")
    convert.save_npz(tp, path)
    with np.load(path) as z:
        assert z["layers/wq/values"].dtype == np.int8
        assert z["layers/wq/scales"].dtype == np.float32
    back = convert.load_npz(path)
    assert isinstance(back["layers"]["wq"], tq.QTensor)
    a, b = convert.flatten(tp), convert.flatten(back)
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in a)
    host = convert.params_to_numpy(back)
    assert host["embed"].values.dtype == np.int8
    np.testing.assert_array_equal(host["embed"].values,
                                  np.asarray(jq_tree["embed"].values))
