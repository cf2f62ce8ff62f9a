"""The traffic generators: the same seed gives the same stream, every seed
the same sizes, and each mix keeps its parameters."""

import json

import pytest
from conftest import BENCH

from pb import harness

MIXES = {p.stem: json.loads(p.read_text()) for p in (BENCH / "traffic").glob("*.json")}
PROMPTS = [k for k, v in MIXES.items() if v["generator"] == "prompts"]
prompts = harness._load_file(BENCH / "traffic" / "prompts.py", "pb_traffic_prompts")


@pytest.mark.parametrize("mix", PROMPTS)
def test_prompts_are_deterministic_and_every_seed_serves_the_same_lengths(mix):
    m = MIXES[mix]

    def stream(seed):
        s = prompts.stream(m, 151936, seed)
        return s, [s.request(i) for i in range(32)]

    s1, a = stream(2**31 + 5)
    _s, b = stream(2**31 + 5)
    s3, c = stream(2**31 + 6)
    assert all(x.equal(y) for x, y in zip(a, b))
    assert not all(x.equal(y) for x, y in zip(a, c) if x.shape == y.shape)
    every = m["one_off_every"]
    new_a = sorted(x.shape[1] for i, x in enumerate(a) if i % every == every - 1)
    new_c = sorted(x.shape[1] for i, x in enumerate(c) if i % every == every - 1)
    assert new_a == new_c
    assert sorted(s1.pool_lengths.tolist()) == sorted(s3.pool_lengths.tolist())
    lo, hi = m["length_range"]
    assert all(lo <= x.shape[1] <= hi and x.shape[0] == m["batch"] for x in a)
    assert all(int(x.max()) < 151936 for x in a)


def test_the_reuse_mix_hits_three_requests_in_four():
    """Of each 4 requests, 3 are pool documents (hits once the pool is
    served) and the 4th a document never seen before."""
    m = MIXES["chat-reuse"]
    s = prompts.stream(m, 1000, 17)
    pool = {id(d) for d in s.pool}
    kept = []
    for i in range(400):
        p = s.request(i)
        if i % 4 == 3:
            assert id(p) not in pool and all(p is not q for q in kept)
        else:
            assert id(p) in pool
        kept.append(p)


@pytest.mark.parametrize("mix", PROMPTS)
def test_setup_serves_the_pool_or_one_document_of_the_longest_length(mix):
    """A shared tier's set-up serves the pool; a fresh tier's one document
    as long as the longest the window sends, which warms every shape."""
    m = MIXES[mix]
    s = prompts.stream(m, 1000, 2**31 + 3)
    setup = s.setup_prompts()
    if m["pool_docs"]:
        assert setup is s.pool and len(setup) == m["pool_docs"]
    else:
        longest = max(s.request(i).shape[1] for i in range(16))
        assert [p.shape for p in setup] == [(m["batch"], longest)]
