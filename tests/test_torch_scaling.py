"""Weak-scaling floor of the port's ray-sharded step in 4 gloo ranks: the
counterpart of tests/test_scaling.py.  Work scales with the ranks; the
baseline is the same work run as an independent render and gradient of
each rank's tile with the same intersector, measured back to back inside
the same ranks by the scaling curve's own body.  efficiency =
t_independent / t_distributed is the share of embarrassingly parallel
throughput that survives the all-reduces.  The curve itself
(spray_tpu_torch.dist.scaling) runs at 1 and 2 ranks."""

import json
import math
import os
from pathlib import Path

import pytest

import torch_dist_worker as W
from spray_tpu_torch.dist import scaling
from spray_tpu_torch.dist.launch import run_world

ROOT = Path(__file__).resolve().parents[1]


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


def test_scaling_curve_rows_have_reference_keys():
    """The curve (spray_tpu_torch.dist.scaling, profiling/scaling_curve.py's
    counterpart) at 1 and 2 gloo ranks: a row per world with the reference
    curve's keys (those of BENCH_extra.json), positive finite times, and
    efficiencies in (0, inf), the capped ones at most 1."""
    ref = json.loads((ROOT / "BENCH_extra.json").read_text())["scaling_cpu_mesh"]
    out = scaling.curve(world_sizes=(1, 2), device="cpu")
    assert list(out) == [str(n) for n in (1, 2) if n <= os.cpu_count()]
    for n, row in out.items():
        assert set(row) == set(ref["1"]), n
        assert all(math.isfinite(v) and v > 0 for v in row.values()), row
        for path, (ind, dist) in {"insitu": ("indep_frame_s", "insitu_frame_s"),
                                  "rayshard": ("indep_grad_s",
                                               "rayshard_step_s")}.items():
            assert row[f"{path}_eff_raw"] == row[ind] / row[dist]
            assert row[f"{path}_eff"] == min(row[f"{path}_eff_raw"], 1.0)


@pytest.mark.parametrize("argv, device", [([], "cuda"),
                                          (["--device", "cpu"], "cpu")])
def test_scaling_command_line_device(argv, device, monkeypatch, capsys):
    """`python -m spray_tpu_torch.dist.scaling` runs the curve on the card
    unless --device cpu asks for gloo CPU ranks, and prints its rows as
    one JSON line."""
    monkeypatch.setattr(scaling, "curve", lambda device: {"1": {"d": device}})
    scaling.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == [{"1": {"d": device}}]
