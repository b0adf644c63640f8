"""The port's ``KVTierStore`` (``tfmesos_tpu_torch/fleet/kvtier.py``)
against the reference's, with no model: every store case of
``tests/test_kvtier.py`` runs on both stores, each under the reference's
own assertions, and the two must return the same values, count the same
stats and leave the same files; the disk entries the two write are
byte-identical, and each store reads the other's directory."""

import os
import threading

import pytest

from tfmesos_tpu.fleet import kvtier as jkv
from tfmesos_tpu_torch.fleet import kvtier as tkv

STORES = {"jax": jkv, "port": tkv}


def _files(path):
    """{name: bytes} of a directory's tier entries."""
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())
            if p.name.endswith(".kvt")}


# -- the cases: each takes the store module, a directory and monkeypatch,
# asserts the reference's claims and returns what it observed ------------


def spill_promote_round_trip(kv, tmp_path, mp):
    """RAM pressure demotes the LRU entries to HMAC-framed files; a later
    get finds each, verified, promoted back and byte-identical."""
    store = kv.KVTierStore(ram_bytes=3000, disk_dir=str(tmp_path),
                           disk_bytes=1 << 20, token="tok")
    bodies = {f"d{i}": bytes([i]) * 1000 for i in range(5)}
    for key, body in bodies.items():
        store.put("prefix", key, {"i": key}, body)
    st = store.stats()
    assert st["ram_bytes_used"] <= 3000
    assert st["demotions"] >= 2 and st["evictions"] == 0
    files = _files(tmp_path)
    for key, body in bodies.items():
        meta, out = store.get("prefix", key)
        assert out == body and meta["i"] == key
    st2 = store.stats()
    assert st2["hits"] == 5 and st2["corrupt"] == 0
    return st, st2, files


def draft_artifact_round_trip(kv, tmp_path, mp):
    """Twin-page blobs and a paired session artifact ride the store
    opaque: demoted, read back byte-identical, metas intact."""
    store = kv.KVTierStore(ram_bytes=4000, disk_dir=str(tmp_path),
                           disk_bytes=1 << 20, token="tok")
    out = []
    for i in range(4):
        tk, dk = bytes([i]) * 600, bytes([0x80 + i]) * 200
        meta = {"k_bytes": len(tk), "dk_bytes": len(dk),
                "draft": {"n_layers": 1, "kv_heads": 2, "head_dim": 8,
                          "dtype": "float32"}}
        store.put_prefix(f"d{i}", meta, tk + tk + dk + dk)
    st = store.stats()
    assert st["spills"] == 4 and st["demotions"] >= 1
    for i in range(4):
        got = store.get_prefix(f"d{i}")
        assert got is not None and got[0]["dk_bytes"] == 200
        out.append(got)
    sess_meta = {"version": 1, "step": 3, "tokens": [7, 8, 9],
                 "arrays": [{"name": n, "dtype": "float32",
                             "shape": [1, 2, 2, 4, 8]}
                            for n in ("k", "v", "dk", "dv")]}
    sess_body = b"".join(bytes([i]) * 256 for i in range(4))
    store.park("conv", sess_meta, sess_body)
    got = store.resume("conv")
    assert got is not None and got[1] == sess_body
    return st, out, got, store.stats()


def ram_lru_without_disk(kv, tmp_path, mp):
    store = kv.KVTierStore(ram_bytes=2500, token="t")
    for i in range(3):
        store.put("prefix", f"k{i}", {}, bytes([i]) * 1000)
    store.get("prefix", "k1")               # k1 is now the MRU
    store.put("prefix", "k3", {}, b"x" * 1000)
    got = [store.get("prefix", f"k{i}") is not None for i in range(4)]
    assert got == [False, True, False, True]
    assert store.stats()["evictions"] >= 1
    return got, store.stats()


def park_rejection_is_explicit(kv, tmp_path, mp):
    store = kv.KVTierStore(ram_bytes=1000, token="t")
    with pytest.raises(kv.KVTierFull):
        store.park("s1", {}, b"y" * 5000)
    st = store.stats()
    assert st["park_rejected"] == 1 and st["park"] == 0
    store.park("s1", {}, b"y" * 500)
    assert store.stats()["park"] == 1 and store.resume("s1") is not None
    return st, store.stats()


def _flip_a_byte(tmp_path):
    (path,) = [p for p in tmp_path.iterdir() if p.name.endswith(".kvt")]
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x40
    path.write_bytes(bytes(blob))
    return path


def disk_corruption_reads_as_miss(kv, tmp_path, mp):
    store = kv.KVTierStore(ram_bytes=0, disk_dir=str(tmp_path),
                           disk_bytes=1 << 20, token="tok")
    store.park("conv", {"n": 1}, b"payload" * 100)
    path = _flip_a_byte(tmp_path)
    assert store.resume("conv") is None
    st = store.stats()
    assert st["corrupt"] == 1 and st["misses"] == 1
    assert not path.exists(), "poisoned entry must be removed"
    return st


def truncated_entry_reads_as_miss(kv, tmp_path, mp):
    store = kv.KVTierStore(ram_bytes=0, disk_dir=str(tmp_path),
                           disk_bytes=1 << 20, token="tok")
    store.park("conv", {"n": 1}, b"payload" * 100)
    (path,) = list(tmp_path.iterdir())
    path.write_bytes(path.read_bytes()[:200])
    assert store.resume("conv") is None
    assert store.stats()["corrupt"] == 1
    return store.stats()


def weights_version_fence(kv, tmp_path, mp):
    v1 = kv.KVTierStore(ram_bytes=0, disk_dir=str(tmp_path),
                        disk_bytes=1 << 20, token="tok",
                        stamp={"weights_version": "v1"})
    v1.park("conv", {"n": 1}, b"old-weights-kv")
    v2 = kv.KVTierStore(ram_bytes=10000, disk_dir=str(tmp_path),
                        token="tok", stamp={"weights_version": "v2"})
    assert v2.resume("conv") is None
    assert v2.stats()["version_miss"] == 1
    v1b = kv.KVTierStore(ram_bytes=10000, disk_dir=str(tmp_path),
                         token="tok", stamp={"weights_version": "v1"})
    got = v1b.resume("conv")
    assert got is not None and got[1] == b"old-weights-kv"
    return v2.stats(), got, _files(tmp_path)


def restamp_fences_old_entries(kv, tmp_path, mp):
    """restamp: a new base version, then an adapter composed on it; the
    entries of each earlier stamp read as version misses."""
    store = kv.KVTierStore(ram_bytes=1 << 16, token="t",
                           stamp={"weights_version": "v1", "gen": 0})
    store.park("a", {}, b"a")
    store.restamp(adapter="lora7")
    assert store.stamp["weights_version"] == "v1+lora7"
    assert store.resume("a") is None
    store.park("b", {}, b"b")
    store.restamp(weights_version="v2")
    assert store.stamp == {"weights_version": "v2", "gen": 0}
    assert store.resume("b") is None
    store.park("c", {}, b"c")
    return store.resume("c"), store.stats()


def cross_process_share_via_disk(kv, tmp_path, mp):
    a = kv.KVTierStore(ram_bytes=64, disk_dir=str(tmp_path), token="tok",
                       disk_bytes=1 << 20)
    a.park("conv", {"covered": 7}, b"kv-bytes" * 50)
    b = kv.KVTierStore(ram_bytes=10000, disk_dir=str(tmp_path),
                       token="tok")
    got = b.resume("conv")
    assert got is not None
    assert got[0]["covered"] == 7 and got[1] == b"kv-bytes" * 50
    evil = kv.KVTierStore(ram_bytes=10000, disk_dir=str(tmp_path),
                          token="other")
    assert evil.resume("conv") is None
    return got, a.stats(), evil.stats()


def fault_mid_spill(kv, tmp_path, mp):
    """os.replace raising mid-spill: the entry drops as a counted
    eviction, nothing hangs, and the store spills again once healed."""
    store = kv.KVTierStore(ram_bytes=1500, disk_dir=str(tmp_path),
                           disk_bytes=1 << 20, token="tok")
    real = os.replace

    def boom(src, dst):
        raise OSError("disk on fire")

    mp.setattr(os, "replace", boom)
    store.put("prefix", "a", {}, b"a" * 1000)
    store.put("prefix", "b", {}, b"b" * 1000)
    st = store.stats()
    assert st["evictions"] >= 1 and st["demotions"] == 0
    assert store.get("prefix", "b") is not None
    mp.setattr(os, "replace", real)
    store.put("prefix", "c", {}, b"c" * 1000)
    assert store.stats()["demotions"] >= 1
    return st, store.stats()


def disk_write_failure_on_park_is_loud(kv, tmp_path, mp):
    store = kv.KVTierStore(ram_bytes=0, disk_dir=str(tmp_path),
                           disk_bytes=1 << 20, token="t")

    def boom(src, dst):
        raise OSError("no space left on device")

    mp.setattr(os, "replace", boom)
    with pytest.raises(kv.KVTierFull):
        store.park("conv", {}, b"x" * 100)
    st = store.stats()
    assert st["park_rejected"] == 1 and st["park"] == 0
    assert store.resume("conv") is None
    return st


def history_counts_against_the_budget(kv, tmp_path, mp):
    store = kv.KVTierStore(ram_bytes=2000, token="t")
    with pytest.raises(kv.KVTierFull):
        store.park("conv", {"history": list(range(4000))}, b"x" * 100)
    assert store.stats()["park_rejected"] == 1
    return store.stats()


def store_validation(kv, tmp_path, mp):
    for bad in (dict(ram_bytes=-1), dict(ram_bytes=0),
                dict(ram_bytes=0, disk_dir=str(tmp_path), disk_bytes=0)):
        with pytest.raises(ValueError):
            kv.KVTierStore(**bad)
    store = kv.KVTierStore(ram_bytes=100)
    with pytest.raises(ValueError):
        store.put("weights", "k", {}, b"x")
    assert kv.KINDS == ("prefix", "session")
    return (store.would_accept(100), store.would_accept(101),
            kv.KVTierStore(ram_bytes=10, disk_dir=str(tmp_path),
                           disk_bytes=1000).would_accept(744))


def summary_lists_sessions_and_prefixes(kv, tmp_path, mp):
    store = kv.KVTierStore(ram_bytes=1 << 20, disk_dir=str(tmp_path),
                           token="tok")
    store.prefix_geometry = {"page": 16, "first": 16, "seed": ""}
    store.park("conv-1", {}, b"kv" * 10)
    store.put_prefix("ab" * 16, {}, b"pg" * 10)
    summ = store.summary()
    assert summ["sessions"] == ["conv-1"]
    assert summ["prefix"]["hashes"] == ["ab" * 16]
    assert summ["counters"]["park"] == 1 and summ["counters"]["spills"] == 1
    return summ


def summary_caps_and_orders(kv, tmp_path, mp):
    """The newest entries first, RAM then this process's disk entries,
    each list capped at ``max_entries``."""
    store = kv.KVTierStore(ram_bytes=600, disk_dir=str(tmp_path),
                           disk_bytes=1 << 20, token="tok")
    for i in range(6):
        store.park(f"s{i}", {}, bytes([i]) * 100)
        store.put_prefix(f"{i:02x}" * 4, {}, bytes([i]) * 100)
    return store.summary(max_entries=4), store.stats()


def delete_both_tiers(kv, tmp_path, mp):
    store = kv.KVTierStore(ram_bytes=300, disk_dir=str(tmp_path),
                           disk_bytes=1 << 20, token="tok")
    for i in range(4):
        store.park(f"s{i}", {}, bytes([i]) * 100)
    for i in range(4):
        store.delete("session", f"s{i}")
    assert _files(tmp_path) == {}
    return store.stats()


def disk_budget_evicts_oldest(kv, tmp_path, mp):
    store = kv.KVTierStore(ram_bytes=0, disk_dir=str(tmp_path),
                           disk_bytes=2000, token="tok")
    for i in range(5):
        store.park(f"s{i}", {}, bytes([i]) * 500)
        os.utime(store._path("session", f"s{i}"), (i, i))
    st = store.stats()
    assert st["evictions"] >= 2 and st["disk_bytes_used"] <= 2000
    return st


def concurrent_put_and_get(kv, tmp_path, mp):
    """Racing writers and readers of one key never tear an entry: every
    hit is one writer's complete (meta, body)."""
    store = kv.KVTierStore(ram_bytes=1 << 20, token="t")
    bodies = {i: bytes([i]) * 512 for i in range(8)}
    seen, errors = [], []

    def writer(i):
        try:
            for _ in range(50):
                store.put("prefix", "digest", {"writer": i}, bodies[i])
        except Exception as e:      # pragma: no cover - the assertion
            errors.append(e)

    def reader():
        try:
            for _ in range(200):
                got = store.get("prefix", "digest")
                if got is not None:
                    seen.append(got)
        except Exception as e:      # pragma: no cover - the assertion
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    threads += [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and seen
    assert all(body == bodies[meta["writer"]] for meta, body in seen)
    return store.stats()["ram_bytes_used"], store.stats()["ram_entries"]


CASES = [spill_promote_round_trip, draft_artifact_round_trip,
         ram_lru_without_disk, park_rejection_is_explicit,
         disk_corruption_reads_as_miss, truncated_entry_reads_as_miss,
         weights_version_fence, restamp_fences_old_entries,
         cross_process_share_via_disk, fault_mid_spill,
         disk_write_failure_on_park_is_loud,
         history_counts_against_the_budget, store_validation,
         summary_lists_sessions_and_prefixes, summary_caps_and_orders,
         delete_both_tiers, disk_budget_evicts_oldest,
         concurrent_put_and_get]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_store_case_matches_jax(case, tmp_path, monkeypatch):
    """One case of the reference's store tests on each store: both pass
    the reference's assertions and observe the same."""
    got = {}
    for name, kv in STORES.items():
        d = tmp_path / name
        d.mkdir()
        with monkeypatch.context() as mp:
            got[name] = case(kv, d, mp)
    assert got["port"] == got["jax"]


# -- the disk format ---------------------------------------------------------


def _write_all(kv, d, stamp):
    """A prefix page, a session artifact with a history, an entry
    demoted from RAM and one replaced in place, through one store."""
    store = kv.KVTierStore(ram_bytes=3000, disk_dir=str(d),
                           disk_bytes=1 << 20, token="cluster-token",
                           stamp=stamp)
    store.put_prefix("9f" * 32, {"page_size": 16, "n_layers": 2,
                                 "kv_heads": 4, "head_dim": 8,
                                 "dtype": "bfloat16", "draft": None,
                                 "k_bytes": 1024}, bytes(range(256)) * 8)
    store.park("conv-α", {"version": 1, "history": [1, 2, 3],
                          "arrays": [{"name": "k", "dtype": "float32",
                                      "shape": [2, 1, 4, 16, 8]}]},
               b"\x00\x01" * 700)
    store.put("session", "big", {"n": 2}, b"z" * 2900)
    store.put("session", "big", {"n": 3}, b"y" * 2950)
    store.put("prefix", "filler", {}, b"f" * 2900)     # demotes "big"
    return store


@pytest.mark.parametrize("stamp", [{}, {"weights_version": "v7", "gen": 2}],
                         ids=["unstamped", "stamped"])
def test_disk_entries_byte_identical(stamp, tmp_path):
    """The same writes through each store leave the same files: names,
    tags, meta JSON and bodies byte for byte."""
    for name, kv in STORES.items():
        (tmp_path / name).mkdir()
        _write_all(kv, tmp_path / name, stamp)
    jax_files, port_files = (_files(tmp_path / n) for n in STORES)
    assert jax_files and port_files == jax_files


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_store_reads_the_others_directory(writer, reader, tmp_path):
    """A store reads every entry the other framework's store wrote to a
    shared directory, stamps and metas intact; a wrong token reads only
    corruption-shaped misses."""
    _write_all(STORES[writer], tmp_path, {"weights_version": "v1"})
    mine = _write_all(STORES[writer], tmp_path / "ref",
                      {"weights_version": "v1"})
    other = STORES[reader].KVTierStore(ram_bytes=1 << 20,
                                       disk_dir=str(tmp_path),
                                       token="cluster-token",
                                       stamp={"weights_version": "v1"})
    for kind, key in (("prefix", "9f" * 32), ("session", "conv-α"),
                      ("session", "big")):
        assert other.get(kind, key) == mine.get(kind, key)
    assert other.stats()["hits"] == 3
    wrong = STORES[reader].KVTierStore(ram_bytes=1 << 20,
                                       disk_dir=str(tmp_path),
                                       token="wrong")
    assert wrong.get("session", "conv-α") is None
    assert wrong.stats()["corrupt"] == 1
