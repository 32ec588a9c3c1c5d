"""The port's fault plan against the JAX package's.

``repro_torch.core.faults`` is a copy of ``repro.core.faults``: the same
blake2b hash of ``seed|channel|key|n`` decides every event, so on the same
key sequences the two plans must fire exactly the same faults — the same
``events()``, ``event_counts()``, ``describe()`` and member deaths.
"""

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro_torch.core import faults as tfaults

CHANNELS = ("download", "slow_download", "dispatch", "resident_loss",
            "store_read", "store_write")
RATES = dict(download_failure_rate=0.3, slow_download_rate=0.5, slow_seconds=0.0,
             dispatch_failure_rate=0.2, resident_loss_rate=0.05,
             store_read_corrupt_rate=0.7, store_write_corrupt_rate=1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _key_sequence(seed: int, n: int = 400):
    """A seeded sequence of (channel, key) events over every channel."""
    rng = np.random.default_rng(seed)
    keys = [f"phi3.decode:{i:04x}" for i in range(7)]
    return [(CHANNELS[rng.integers(len(CHANNELS))], keys[rng.integers(len(keys))])
            for _ in range(n)]


def _as_tuples(events):
    return [(e.channel, e.key, e.n) for e in events]


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2**31 - 1])
@pytest.mark.parametrize("channel", CHANNELS)
def test_plan_fires_what_the_reference_fires(seed, channel):
    seq = _key_sequence(seed)
    jp, tp = jfaults.FaultPlan(seed, **RATES), tfaults.FaultPlan(seed, **RATES)
    fired = [(jp.fires(ch, k), tp.fires(ch, k)) for ch, k in seq]
    assert all(a == b for a, b in fired)
    # one channel alone, a key hit many times
    jc, tc = jfaults.FaultPlan(seed, **RATES), tfaults.FaultPlan(seed, **RATES)
    assert [jc.fires(channel, "k") for _ in range(200)] == \
        [tc.fires(channel, "k") for _ in range(200)]
    assert _as_tuples(tp.events()) == _as_tuples(jp.events())
    assert tp.event_counts() == jp.event_counts()
    assert tp.describe() == jp.describe()
    assert tfaults.replay_identical(tp.events(), tp.events())
    assert jfaults.replay_identical(jp.events(), jp.events())


@pytest.mark.parametrize("deaths", [{}, {0: 3}, {1: 10, 2: 5}, {0: 0, 3: 7, 5: 7}])
def test_member_deaths_match_the_reference(deaths):
    jp = jfaults.FaultPlan(3, member_deaths=deaths)
    tp = tfaults.FaultPlan(3, member_deaths=deaths)
    for count in (0, 2, 5, 5, 7, 11, 100):
        assert tp.members_to_kill(count) == jp.members_to_kill(count)
    assert tp.describe() == jp.describe()


def test_replay_identical_ignores_order_and_sees_differences():
    a = tfaults.FaultPlan(9, download_failure_rate=0.5)
    b = tfaults.FaultPlan(9, download_failure_rate=0.5)
    for _ in range(30):                    # the same per-key sequences,
        a.fires("download", "x")           # in another global order
    for _ in range(30):
        a.fires("download", "y")
    for _ in range(30):
        b.fires("download", "y")
        b.fires("download", "x")
    assert tfaults.replay_identical(a.events(), b.events())
    assert a.events() == b.events()
    c = tfaults.FaultPlan(10, download_failure_rate=0.5)
    for _ in range(30):
        c.fires("download", "x")
        c.fires("download", "y")
    assert not tfaults.replay_identical(a.events(), c.events())


def test_plan_validates_like_the_reference():
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError):
            mod.FaultPlan(0, download_failure_rate=1.5)
        with pytest.raises(ValueError):
            mod.FaultPlan(0).fires("no_such_channel", "k")
