"""Weak-scaling floor of the port's ray-sharded step in 4 gloo ranks: the
counterpart of tests/test_scaling.py.  Work scales with the ranks; the
baseline is the same work run as an independent render and gradient of
each rank's tile with the same intersector, measured back to back inside
the same ranks.  efficiency = t_independent / t_distributed is the share
of embarrassingly parallel throughput that survives the all-reduces."""

import os

import pytest

import torch_dist_worker as W
from spray_tpu_torch.dist.launch import run_world


@pytest.mark.skipif(
    os.environ.get("SPRAY_PERF_TESTS", "") == "0",
    reason="wall-clock perf assertion; set SPRAY_PERF_TESTS=0 to skip on "
    "loaded or shared machines",
)
def test_rayshard_weak_scaling_efficiency_floor():
    times = run_world(W.scaling_rank, 4, device="cpu")
    t_ind = max(t for t, _ in times)
    t_dist = max(t for _, t in times)
    eff = t_ind / t_dist
    assert eff >= 0.6, f"rayshard weak-scaling efficiency {eff:.2f} < 0.6 ({times})"
