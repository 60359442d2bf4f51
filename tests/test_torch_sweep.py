"""spray_tpu_torch sorted visit-sweep tracer (plain versions of the CUDA
visit kernels, on the CPU) == spray_tpu's (Pallas in interpret mode) over
one build carried by interop, and the port's brute oracle.  Tiny band and
chunk sizes force many chunks (the cursor and overflow paths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spray_tpu.io import scenes as js
from spray_tpu.kernels import sweep as jsw
from spray_tpu_torch.interop import binned_arrays
from spray_tpu_torch.kernels import sweep as tsw

from test_torch_binned import (assert_same_hits, check_against_oracle,
                               port_scene, windowed_rays)

WISP = dict(n_blobs=6, tris_per_blob=800, seed=2)
CASES = {
    # scene, options, centered, seed: the cases of tests/test_sweep.py
    "cornell_random": (lambda: js.cornell_box(), {}, False, 0),
    "cornell_coherent": (lambda: js.cornell_box(), {}, True, 1),
    "wisp_multi_supernode": (lambda: js.wisp_cloud(**WISP), {}, False, 2),
    "wisp_band1_cap1_many_chunks": (
        lambda: js.wisp_cloud(**WISP), dict(band0=1, v_cap_per_pkt=1), True, 3),
    "icosphere_unsorted": (lambda: js.icosphere(3), dict(sort=False), False, 4),
    "small_scene": (lambda: js.icosphere(1),
                    dict(band0=16, v_cap_per_pkt=32), False, 5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sweep_intersector_matches_reference_and_oracle(name):
    make, kw, centered, seed = CASES[name]
    kw = {"band0": 4, "v_cap_per_pkt": 2, **kw}
    scene = make()
    rays = windowed_rays(scene, 600, centered, seed)
    ji = jsw.SweepIntersector(scene, interpret=True, **kw)
    ti = tsw.SweepIntersector.from_arrays(port_scene(scene), binned_arrays(ji),
                                          device="cpu", **kw)
    jr = [jnp.asarray(x) for x in rays]
    tr = [torch.as_tensor(x) for x in rays]
    hj, occ_j = ji.intersect(*jr), ji.occluded(jr[0], jr[1], jr[3])
    ht, occ_t = ti.intersect(*tr), ti.occluded(tr[0], tr[1], tr[3])
    assert_same_hits(hj, ht, occ_j, occ_t)
    check_against_oracle(scene, rays, ht, occ_t)
    assert ht.valid.any() and occ_t.any() and not ht.valid[:8].any()
    st = ti.stats
    assert st["calls"] == 2 and st["rounds"] == st["syncs"] >= 2
    if "band1" in name:
        assert st["rounds"] > 6  # one-visit chunks: many trips of the loop


def test_chunk_assemble_matches_reference():
    """Packet-major packing by searchsorted: the cap cuts a packet's run,
    the padded tail extends the last run with null visits, taken sums to
    the chunk's live visits."""
    p, s, s_null = 6, 5, 5
    rs = np.random.RandomState(0)
    ent = np.sort(rs.uniform(0, 9, (p, s)).astype(np.float32), axis=1)
    order = np.stack([rs.permutation(s) for _ in range(p)]).astype(np.int32)
    for counts, cursor, v_cap in (
        ([2, 0, 3, 1, 0, 2], [0, 0, 1, 4, 0, 2], 16),  # a padded tail
        ([2, 0, 3, 1, 0, 2], [0, 0, 1, 4, 0, 2], 4),  # the cap cuts packet 2
        ([0, 0, 0, 0, 0, 0], [5, 5, 5, 5, 5, 5], 3),  # nothing owed
    ):
        counts, cursor = np.array(counts, np.int32), np.array(cursor, np.int32)
        ref = jsw._chunk_assemble(jnp.asarray(counts), jnp.asarray(cursor),
                                  jnp.asarray(order), jnp.asarray(ent), v_cap,
                                  s_null)
        got = tsw._chunk_assemble(
            torch.as_tensor(counts).long(), torch.as_tensor(cursor).long(),
            torch.as_tensor(order).long(), torch.as_tensor(ent), v_cap, s_null)
        for name, a, b in zip(("pkt", "sn", "ent", "first", "last", "taken"),
                              ref, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        assert int(got[5].sum()) == min(int(counts.sum()), v_cap)
        assert int(got[3].sum()) == int(got[4].sum())  # whole runs only
    upper = torch.tensor([4.0, 0.0, 9.5, 1.0, 3.0, 100.0])
    got = tsw._avail_counts(torch.as_tensor(ent), torch.as_tensor(cursor).long(),
                            upper)
    ref = jsw._avail_counts(jnp.asarray(ent), jnp.asarray(cursor),
                            jnp.asarray(upper.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
