"""Tie-tolerant comparison of two nearest-hit records, shared by
``chip_smoke.py`` and ``tests_gpu/parity_gate.py``.

Two intersectors may return different triangles for one ray where both
hits lie at (nearly) the same distance: a ray through a shared edge, or
coplanar triangles.  Such a lane is a tie, not a fault; a different prim at
a distinctly different t is.
"""

from __future__ import annotations


def close(a, b, rtol, atol=0.0, floor=0.0):
    """|a - b| <= atol + rtol * max(|b|, floor), elementwise."""
    return (a - b).abs() <= atol + rtol * b.abs().clamp(min=floor)


def hit_mismatch(ref, got, t_tol, tie_tol):
    """Compare the Hits `got` with the Hits `ref` (tensors on one device).

    t_tol and tie_tol are (rtol, atol, floor) of `close`: a lane valid in
    both has a bad t where its t is not close to ref's within t_tol, and a
    non-tie prim mismatch where the prims differ and t is not close within
    tie_tol.  Returns the counts, the shares (of all lanes for the valid
    masks, of the lanes valid in both for the rest) and the max abs t
    difference."""
    vr, vg = ref.valid, got.valid
    m = vr & vg
    tr, tg = ref.t[m], got.t[m]
    t_bad = ~close(tg, tr, *t_tol)
    nontie = (ref.prim[m] != got.prim[m]) & ~close(tg, tr, *tie_tol)
    n, nm = vr.numel(), int(m.sum())
    counts = {"valid_mismatch": int((vr != vg).sum()), "t_bad": int(t_bad.sum()),
              "prim_mismatch_nontie": int(nontie.sum())}
    return {
        "lanes": n, "both_valid": nm, "counts": counts,
        "valid_mismatch": counts["valid_mismatch"] / max(n, 1),
        "t_bad": counts["t_bad"] / max(nm, 1),
        "prim_mismatch_nontie": counts["prim_mismatch_nontie"] / max(nm, 1),
        "t_max_abs": float((tg - tr).abs().max()) if nm else 0.0,
    }
