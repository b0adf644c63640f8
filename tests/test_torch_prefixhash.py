"""The port's copy of ``prefixhash`` against the JAX package's module:
the chain digests, chunk digests and match depths must be equal bit for
bit (the fleet router matches a replica's heartbeat hashes against the
digests it computes itself), over hypothesis-drawn prompts and
geometries."""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from tfmesos_tpu import prefixhash as jph
from tfmesos_tpu_torch import prefixhash as tph

prompts = st.lists(st.integers(0, 2 ** 31 - 1), min_size=0, max_size=200)


@settings(max_examples=60, deadline=None)
@given(prompt=prompts, page=st.integers(1, 64), first=st.integers(0, 64),
       seed=st.binary(max_size=16))
def test_prompt_digests_equal(prompt, page, first, seed):
    got = tph.prompt_digests(prompt, page, first, seed)
    assert got == jph.prompt_digests(prompt, page, first, seed)
    assert len(got) == (0 if len(prompt) < (first or page)
                        else 1 + (len(prompt) - (first or page)) // page)


@settings(max_examples=40, deadline=None)
@given(prompt=prompts, parent=st.binary(max_size=16),
       cut=st.integers(0, 8))
def test_chunk_digest_token_bytes_and_match_depth(prompt, parent, cut):
    assert tph.token_bytes(prompt) == jph.token_bytes(prompt)
    assert tph.chunk_digest(parent, prompt) == \
        jph.chunk_digest(parent, prompt)
    digs = tph.prompt_digests(prompt, 8)
    adv = [d.hex() for d in digs[:cut]] + [b"\x00" * 16]
    assert tph.match_depth(digs, adv) == jph.match_depth(digs, adv) == \
        min(cut, len(digs))


def test_geometry_is_checked_alike():
    for mod in (tph, jph):
        try:
            mod.prompt_digests(np.arange(4), 0)
        except ValueError:
            continue
        raise AssertionError(f"{mod.__name__} accepted page 0")
