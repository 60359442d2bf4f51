"""How `correct` is decided: what the timed path produced, held against the
plain reference (`benchmark.reference`), each number beside its limit.

- An image: a sample of its pixels, drawn from the seed, is rendered again
  by the reference.  `pixel_mismatch` is the share, among the sampled
  pixels that are lit (not black) in the reference or in the program's
  image, of those with a channel off the reference's value by more than
  ATOL + RTOL * |reference| (a pixel whose path took another triangle
  differs by far more; one whose paths agree differs by float rounding at
  most).  A pixel black on both sides agrees, and most pixels of a
  path-traced frame at a few samples can be black: over all pixels, a
  fault would be diluted by them.
- A training step: the reference's loss and gradients of the whole frame.
  `loss_gap` is |loss - reference| / |reference|; `grad_norm_gap` the
  worst leaf's |norm - reference norm| over the larger of the reference's
  norm of that leaf and of the median leaf.

A number that is not finite fails its limit.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from benchmark.reference.render import Reference

RTOL = 1e-3
ATOL = 1e-5


def sample_pixels(seed, npix, count):
    """`count` distinct pixel ids of the frame, drawn from the seed, sorted."""
    count = min(int(count), npix)
    pick = np.random.default_rng(int(seed)).choice(npix, count, replace=False)
    return np.sort(pick)


def reference_cfg(traffic, seed):
    return {"spp": traffic["spp"], "bounces": traffic["bounces"],
            "seed": int(seed), "nee": traffic["nee"],
            "background": (0.0, 0.0, 0.0)}


def pixel_mismatch(image, ref_pixels, ids):
    """Share of the lit pixels `ids` of `image` ((H, W, 3)) that differ
    from `ref_pixels` ((K, 3)) beyond the tolerance; 0 if none is lit."""
    got = torch.as_tensor(np.asarray(image, np.float32).reshape(-1, 3)[ids])
    want = ref_pixels.detach().float().cpu()
    ok = ((got - want).abs() <= ATOL + RTOL * want.abs()).all(dim=1)
    lit = ((got != 0) | (want != 0)).any(dim=1)
    return float((~ok).sum()) / max(int(lit.sum()), 1)


def loss_gap(loss, ref_loss):
    return abs(float(loss) - ref_loss) / max(abs(ref_loss), 1e-30)


def grad_norm_gap(grads, ref_grads):
    norms = {k: float(torch.linalg.vector_norm(g.float()))
             for k, g in ref_grads.items()}
    median = statistics.median(norms.values())
    gaps = []
    for k, g in ref_grads.items():
        mine = float(torch.linalg.vector_norm(grads[k].detach().float()))
        gaps.append(abs(mine - norms[k]) / max(norms[k], median, 1e-30))
    return max(gaps)


def numbers(output, ctx, ref=None):
    """{name: value} of every number compared for this output.  `ref` is a
    Reference to reuse (the control passes one in a lower dtype)."""
    if ref is None:
        ref = Reference(ctx.scene, ctx.device)
    # the frame's own render seed, where the entry cycles through a pool
    cfg = reference_cfg(ctx.traffic, output.get("render_seed", ctx.seed))
    out = {}
    if "image" in output:
        npix = ctx.camera["width"] * ctx.camera["height"]
        ids = sample_pixels(ctx.seed, npix, ctx.limits["check_pixels"])
        ref_px = ref.pixels(ctx.camera, cfg,
                            torch.as_tensor(ids, device=ref.device))
        img = output["image"]
        if torch.is_tensor(img):
            img = img.detach().cpu().numpy()
        out["pixel_mismatch"] = pixel_mismatch(img, ref_px, ids)
    if "loss" in output:
        ref_loss, ref_grads = ref.loss_and_grads(ctx.camera, cfg,
                                                 ctx.traffic["loss_weights"])
        out["loss_gap"] = loss_gap(output["loss"], ref_loss)
        out["grad_norm_gap"] = grad_norm_gap(output["grads"], ref_grads)
    return out


def judge(values, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and finite."""
    table = {k: {"value": v, "limit": limits["limits"][k]}
             for k, v in values.items()}
    correct = bool(table) and all(
        np.isfinite(e["value"]) and e["value"] <= e["limit"]
        for e in table.values())
    return correct, table
