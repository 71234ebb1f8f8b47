"""The kernels' byte counts against hand-worked cases: each request's
distinct probed lists once at their live rows, queries (and K3's LUTs)
once, outputs at 4 bytes a live scored row."""

import numpy as np
import torch

from portbench import roofline


def test_probed_lists_are_the_nearest_centroids():
    c = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [10.0, 10.0]])
    q = torch.tensor([[1.0, 1.0], [9.0, 9.5]])
    got = roofline.probed_lists(c, q, 2)
    assert set(got[0].tolist()) == {0, 1} or set(got[0].tolist()) == {0, 2}
    assert got[1, 0].item() == 3


def test_distinct_lists_once_pairs_each():
    sizes = torch.tensor([5, 7, 0, 11])
    probes = torch.tensor([[0, 1], [1, 3], [0, 3]])
    unique_live, pair_live = roofline.request_work(probes, sizes)
    assert unique_live == 5 + 7 + 11
    assert pair_live == (5 + 7) + (7 + 11) + (5 + 11)


def test_k1_bytes_by_hand():
    # 3 queries of d = 4, nprobe 2; fp16 rows with an id and a norm: 16 B
    nbytes = roofline.k1_request_bytes(3, 4, 2, 16, unique_live=23, pair_live=46)
    assert nbytes == 23 * 16 + 3 * 4 * 4 + 2 * 3 * 2 * 4 + 46 * 4


def test_k3_bytes_by_hand():
    # 3 queries, nprobe 2, m = 8, ksub 256, bf16 LUT: 6 LUTs of 4096 B
    nbytes = roofline.k3_request_bytes(3, 2, 8, 256, 2, unique_live=23, pair_live=46)
    assert nbytes == 6 * 8 * 256 * 2 + 23 * (8 + 4) + 2 * 3 * 2 * 4 + 46 * 4


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0.0) == 1.0
    assert roofline.least_seconds(0.0, 67e12) == 1.0
    assert roofline.least_seconds(3.35e9, 67e12) == 1.0


def test_mean_request_least_time_counts_each_request():
    c = np.array([[0.0, 0.0], [10.0, 0.0]], np.float32)
    sizes = np.array([4, 6])
    near0 = np.zeros((2, 2), np.float32)
    both = np.array([[0.0, 0.0], [10.0, 0.0]], np.float32)
    layout = {"row_bytes": 10}
    one = roofline.mean_request_least_s("K1", c, sizes, [near0], 1, layout, "cpu")
    assert one == (4 * 10 + 2 * 2 * 4 + 2 * 2 * 1 * 4 + 2 * 4 * 4) / roofline.HBM_BYTES_PER_S
    two = roofline.mean_request_least_s("K1", c, sizes, [near0, both], 1, layout, "cpu")
    other = (10 * 10 + 2 * 2 * 4 + 2 * 2 * 1 * 4 + 10 * 4) / roofline.HBM_BYTES_PER_S
    assert np.isclose(two, (one + other) / 2)
