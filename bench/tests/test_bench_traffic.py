"""The one traffic generator: a seed gives the same requests every time,
and every seed the same sizes, in the same work order."""
import numpy as np

from bench.harness import common
import pytest

from bench.harness.traffic import Stream, quantile, served_shares, size_set


def _mix(name):
    return common.part("traffic", name)


def _closed(mix, seed, rounds):
    st = Stream(mix, seed, 50000)
    return st, [st.next(k) for _ in range(rounds) for k in st.first]


def test_same_seed_same_requests():
    a = _closed(_mix("chat"), 2 ** 31 + 5, 3)[1]
    b = _closed(_mix("chat"), 2 ** 31 + 5, 3)[1]
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))
    c = Stream(_mix("docs"), 7, 50000).take(40)
    d = Stream(_mix("docs"), 7, 50000).take(40)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(c, d))


def test_tokens_follow_the_seed_not_the_asking_order():
    mix = _mix("chat")
    st = Stream(mix, 11, 50000)
    fwd = {k: st.next(k)[0] for k in range(mix["sessions"])}
    st2 = Stream(mix, 11, 50000)
    rev = {k: st2.next(k)[0] for k in reversed(range(mix["sessions"]))}
    assert all(np.array_equal(fwd[k], rev[k]) for k in fwd)
    other = Stream(mix, 12, 50000).next(0)[0]
    assert fwd[0].size == other.size and not np.array_equal(fwd[0], other)


def test_every_seed_the_same_work():
    mix = _mix("chat")
    works = []
    for seed in (1, 2, 3):
        st = Stream(mix, seed, 1000)
        per_session = {k: [(lambda r: (r[0].size, r[1]))(st.next(k))
                           for _ in range(5)] for k in range(mix["sessions"])}
        works.append((per_session, st.first))
    assert works[0][0] == works[1][0] == works[2][0]
    assert works[0][1] != works[1][1]             # another first order
    assert sorted(works[0][1]) == list(range(mix["sessions"]))
    # each session runs through the whole set in turn, from the middle of
    # its first request: part of its output served, as part of its prompt
    n = mix["set_size"]
    s0 = [p for p in works[0][0][0]]
    assert s0[1:min(5, n)] == [tuple(x) for x in size_set(mix)[1:min(5, n)]]
    p0, o0 = size_set(mix)[0]
    done = int(served_shares(mix["sessions"])[0] * o0)
    assert s0[0] == (p0 + done, o0 - done) and o0 - done >= 1


def test_closed_sessions_start_at_spread_shares():
    mix = _mix("chat")
    shares = served_shares(mix["sessions"])
    n = mix["sessions"]
    assert sorted(shares) == [(i + 0.5) / n for i in range(n)]
    st = Stream(mix, 4, 1000)
    for k in range(n):
        p, o = size_set(mix)[k % mix["set_size"]]
        prompt, rest = st.next(k)
        assert prompt.size + rest == p + o and 1 <= rest <= o


@pytest.mark.parametrize("extra", [{"think_s": 0.5}, {"pair_seed": 3},
                                   {"batch": 4}, {"kind": "bursty"}])
def test_a_key_the_kind_does_not_read_is_refused(extra):
    with pytest.raises(ValueError):
        Stream(dict(_mix("chat"), **extra), 1, 1000)


def test_batches_repeat_the_set():
    mix = _mix("docs")
    reqs = Stream(mix, 3, 1000).take(2 * mix["batch"])
    sizes = [(r[0].size, r[1]) for r in reqs]
    assert sizes[:mix["batch"]] == sizes[mix["batch"]:] == size_set(mix)


def test_quantiles_and_clipping():
    ln = {"dist": "lognormal", "median": 1024, "sigma": 0.8, "min": 64,
          "max": 3584}
    assert quantile(ln, 0.5) == 1024
    assert quantile(ln, 1e-9) == 64 and quantile(ln, 1 - 1e-9) == 3584
    un = {"dist": "uniform", "min": 4, "max": 16}
    assert [quantile(un, (i + 0.5) / 13) for i in range(13)] == \
        list(range(4, 17))
    s = size_set(_mix("docs"))
    assert len(s) == 32 and all(1024 <= p <= 8192 and 4 <= o <= 16
                                for p, o in s)


def test_poisson_gaps_and_vocab():
    mix = dict(_mix("chat"), kind="poisson", rate_per_s=2.0)
    del mix["sessions"]
    st = Stream(mix, 9, 300)
    reqs = [st.next() for _ in range(64)]
    assert all(r[0].max() < 300 and r[0].min() >= 0 for r in reqs)
    assert abs(np.mean([r[2] for r in reqs]) - 0.5) < 0.05   # 1 / rate
