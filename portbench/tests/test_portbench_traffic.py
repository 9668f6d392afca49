"""The generator: same sizes and arrival gaps for every seed, in another
order; and the open-loop server's due-time latency."""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic
from portbench.kinds import serve


def test_arrivals_same_gaps_other_order():
    a, b = traffic.arrivals(200, 10, 1), traffic.arrivals(200, 10, 2 ** 33 + 7)
    assert len(a) == len(b) == 2000
    assert a[0] == 0.0 and np.all(np.diff(a) > 0)
    assert not np.array_equal(a, b)
    assert np.array_equal(traffic.arrivals(200, 10, 1), a)
    # every seed draws from one multiset of gaps (less the one before 0)
    ga, gb = np.sort(np.diff(a)), np.sort(np.diff(b))
    assert np.sum(~np.isclose(ga[:, None], gb[None, :]).any(axis=1)) <= 1
    assert abs(a[-1] - 10.0) < 0.1


def test_scenes_sizes_and_dead_band():
    t = {"scene_side": 100, "bands": 13, "scenes": 2, "field_cell": 16}
    one = traffic.scenes(t, 5, torch.device("cpu"))
    two = traffic.scenes(t, 6, torch.device("cpu"))
    assert [s.shape for s in one] == [(100, 100, 13)] * 2 and one[0].dtype == np.uint16
    assert not np.array_equal(one[0], two[0])
    assert np.array_equal(one[0], traffic.scenes(t, 5, torch.device("cpu"))[0])
    live = one[0][one[0] < 4600]
    assert live.min() >= 100 and live.max() <= 4500
    assert (np.abs(one[0].astype(np.int32) - 5000) < 20).any()


def test_tiles_pool():
    t = {"tile_size": 32, "bands": 13, "pool": 4}
    pool = traffic.tiles(t, 3, torch.device("cpu"))
    assert len(pool) == 4 and pool[0].shape == (1, 32, 32, 13) and pool[0].dtype == np.float32
    rms = np.sqrt((pool[0][0] ** 2).mean(axis=(0, 1)))
    assert (rms < 0.05).sum() in (1, 2)


class _SlowSession:
    """Each predict takes 30 ms: requests due every 10 ms queue up."""

    def __init__(self):
        self.calls = 0

    def predict(self, x):
        import time

        time.sleep(0.03)
        self.calls += 1
        return x


def test_latency_runs_from_the_due_time():
    driver = serve.Driver.__new__(serve.Driver)
    driver.seed, driver.traffic = 1, {"sample": 2}
    driver.pool = [np.zeros((1, 4, 4, 13), np.float32)]
    driver.session = _SlowSession()
    driver.rng = np.random.default_rng(0)
    driver.attempted, driver.kept, driver.extra, driver.late_s = 0, {}, {}, []
    lat = driver.serve(100.0, 0.1)
    assert driver.attempted == len(lat) == 10
    # a closed loop would read 30 ms each; due-time latency counts the queue
    assert lat[-1] > 0.2 and max(driver.late_s) > 0.15
    assert np.percentile(lat, 95) > 0.15
    assert len(driver.kept) == 2
