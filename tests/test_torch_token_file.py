"""The port's TokenFileDataset against the JAX package's on the CPU (the
cases of tests/test_data.py): the same file gives the same batches as
the JAX numpy path, and the port's native gather (its own copy of
tokenloader.cpp, built with g++ at first use) is bit-identical to
numpy.  The JAX native cases skip here: the JAX library is not built."""

import numpy as np
import pytest

from tfmesos_tpu.train.data import TokenFileDataset as JaxDataset
from tfmesos_tpu_torch.train import data as tdata
from tfmesos_tpu_torch.train.data import TokenFileDataset, _NativeTokenGather


def _write(tmp_path, n=4096, vocab=1000, dtype="uint16", name="tokens.bin"):
    path = str(tmp_path / name)
    tokens = np.random.RandomState(0).randint(0, vocab, size=n)
    TokenFileDataset.write(path, tokens, dtype=dtype)
    return path, tokens


def _same(port, jax_, n=3):
    for _ in range(n):
        a, b = next(port)["tokens"], next(jax_)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [False, True])
def test_roundtrip_and_window_contents(tmp_path, native):
    path, tokens = _write(tmp_path)
    ds = TokenFileDataset(path)
    batch = next(ds.batches(4, 16, seed=7, native=native))
    assert batch["tokens"].shape == (4, 17)
    flat = tokens.astype(np.int32)
    for row in batch["tokens"]:
        starts = np.flatnonzero(flat[:-16] == row[0])
        assert any(np.array_equal(flat[s:s + 17], row) for s in starts)
    _same(ds.batches(4, 16, seed=7, native=native),
          JaxDataset(path).batches(4, 16, seed=7, native=False))


@pytest.mark.parametrize("native", [False, True])
def test_determinism_and_dtype_uint32(tmp_path, native):
    path = str(tmp_path / "big.bin")
    TokenFileDataset.write(path, np.arange(66000, 67000), dtype="uint32")
    ds = TokenFileDataset(path, dtype="uint32")
    a = next(ds.batches(2, 8, seed=3, native=native))["tokens"]
    b = next(ds.batches(2, 8, seed=3, native=native))["tokens"]
    np.testing.assert_array_equal(a, b)
    assert a.max() >= 65536 and np.all(np.diff(a, axis=1) == 1)
    _same(ds.batches(2, 8, seed=3, native=native),
          JaxDataset(path, dtype="uint32").batches(2, 8, seed=3,
                                                   native=False))


def test_rank_stripes_are_disjoint(tmp_path):
    path, tokens = _write(tmp_path, n=1000)
    ds, jds = TokenFileDataset(path), JaxDataset(path)
    flat = tokens.astype(np.int32)
    seen = []
    for rank in range(4):
        batch = next(ds.batches(8, 16, rank=rank, world_size=4, seed=rank))
        lo, hi = 1000 * rank // 4, 1000 * (rank + 1) // 4
        for row in batch["tokens"]:
            assert any(np.array_equal(flat[s:s + 17], row)
                       for s in range(lo, hi - 16)), rank
        seen.append((lo, hi))
        _same(ds.batches(8, 16, rank=rank, world_size=4, seed=rank),
              jds.batches(8, 16, rank=rank, world_size=4, seed=rank,
                          native=False), n=2)
    assert all(a[1] <= b[0] for a, b in zip(seen, seen[1:]))


def test_errors_match_jax(tmp_path):
    path, _ = _write(tmp_path, n=64)
    cases = [dict(batch_size=1, seq_len=63, rank=0, world_size=4),
             dict(batch_size=1, seq_len=4, rank=4, world_size=4)]
    for kw, match in zip(cases, ("stripe", "rank")):
        with pytest.raises(ValueError, match=match) as got:
            next(TokenFileDataset(path).batches(**kw))
        with pytest.raises(ValueError) as want:
            next(JaxDataset(path).batches(**kw))
        assert str(got.value) == str(want.value)
    empty = str(tmp_path / "empty.bin")
    TokenFileDataset.write(empty, np.array([1]))
    with pytest.raises(ValueError, match="too few") as got:
        TokenFileDataset(empty)
    with pytest.raises(ValueError) as want:
        JaxDataset(empty)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("native", [False, True])
def test_start_step_fast_forward_matches_full_stream(tmp_path, native):
    path = str(tmp_path / "toks.bin")
    TokenFileDataset.write(path, np.arange(5000) % 251)
    tfd = TokenFileDataset(path)
    fresh = [next(g) for g in [tfd.batches(2, 8, seed=11, native=native)]
             for _ in range(6)][4:]
    resumed = tfd.batches(2, 8, seed=11, start_step=4, native=native)
    for a in fresh:
        np.testing.assert_array_equal(a["tokens"], next(resumed)["tokens"])
    _same(tfd.batches(2, 8, seed=11, start_step=4, native=native),
          JaxDataset(path).batches(2, 8, seed=11, start_step=4,
                                   native=False), n=2)


def test_native_gather_matches_numpy(tmp_path):
    """The port's native gather is bit-identical to numpy (and to the
    JAX numpy path) across dtypes, stripes and resume offsets."""
    assert _NativeTokenGather.load() is not None
    for dtype in ("uint16", "uint32"):
        path = str(tmp_path / f"toks_{dtype}.bin")
        toks = np.random.RandomState(3).randint(0, 60000, size=20000)
        TokenFileDataset.write(path, toks, dtype=dtype)
        ds = TokenFileDataset(path, dtype=dtype)
        jds = JaxDataset(path, dtype=dtype)
        for rank, ws, ss in [(0, 1, 0), (1, 2, 5)]:
            kw = dict(rank=rank, world_size=ws, start_step=ss)
            g_np = ds.batches(4, 33, native=False, **kw)
            g_cc = ds.batches(4, 33, native=True, **kw)
            g_jx = jds.batches(4, 33, native=False, **kw)
            for _ in range(4):
                a, b = next(g_np)["tokens"], next(g_cc)["tokens"]
                assert b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(b, next(g_jx)["tokens"])
            g_cc.close()


def test_native_gather_rejects_bad_windows(tmp_path):
    path = str(tmp_path / "toks.bin")
    TokenFileDataset.write(path, np.arange(100))
    loader = _NativeTokenGather(path, np.dtype("uint16"))
    assert loader.n_tokens == 100
    with pytest.raises(ValueError):
        loader.gather(np.array([95]), 17)  # runs past the end
    with pytest.raises(ValueError):
        loader.gather(np.array([-1]), 4)
    out = loader.gather(np.array([0, 83]), 17)
    np.testing.assert_array_equal(out[0], np.arange(17))
    np.testing.assert_array_equal(out[1], np.arange(83, 100))
    loader.close()


def test_native_contract_when_the_library_is_missing(tmp_path, monkeypatch):
    """``native=True`` raises when the gather cannot load, ``None`` falls
    back to numpy with the same batches, ``False`` never tries."""
    path, _ = _write(tmp_path)
    monkeypatch.setattr(_NativeTokenGather, "_tried", True)
    monkeypatch.setattr(_NativeTokenGather, "_lib", None)
    ds = TokenFileDataset(path)
    with pytest.raises(RuntimeError, match="did not build"):
        next(ds.batches(2, 8, native=True))
    _same(ds.batches(2, 8, native=None), ds.batches(2, 8, native=False))
    assert tdata._NativeTokenGather.load() is None
