"""Inverse-rendering loop with checkpoint and resume (counterpart of
``spray_tpu/optim.py``).

`fit` descends a pixel loss w.r.t. scene parameters (albedo / vertices /
emission) through the frozen-visibility differentiable renderer with
``torch.optim.Adam`` (the reference uses optax's Adam: the same update,
rounded in another order).  A checkpoint is a plain npz: the step, the
params, and Adam's ``exp_avg``, ``exp_avg_sq`` and step count of each
param.  The counter-based RNG needs no state beyond the step index, so a
resumed run repeats the uninterrupted one bit for bit: every op of the
step is deterministic on the card too (the gathers' backward sums in
fixed point, ``core.geom.gather_rows``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .core.device import resolve_device
from .diff import make_diff_render_fn

ADAM_STATE = ("exp_avg", "exp_avg_sq", "step")


def l2_image_loss(img, target):
    return torch.mean((img - target) ** 2)


def save_checkpoint(path, step, params, opt_state):
    """params: {name: tensor}; opt_state: {name: {exp_avg, exp_avg_sq,
    step}} (Adam's per-param state)."""
    arrays = {f"p_{k}": v.detach().cpu().numpy() for k, v in params.items()}
    for k, st in opt_state.items():
        for s in ADAM_STATE:
            arrays[f"o_{k}_{s}"] = np.asarray(torch.as_tensor(st[s]).cpu())
    np.savez(path, step=step, **arrays)


def load_checkpoint(path, device=None):
    """Returns (step, params {name: tensor}, opt_state as save_checkpoint
    takes it), the tensors on `device` (default: the card; Adam's step
    counts stay on the host, where torch.optim keeps them)."""
    device = resolve_device(device)
    with np.load(path) as z:
        step = int(z["step"])
        params = {k[2:]: torch.as_tensor(z[k], device=device)
                  for k in z.files if k.startswith("p_")}
        opt_state = {
            k: {s: torch.as_tensor(z[f"o_{k}_{s}"],
                                   device="cpu" if s == "step" else device)
                for s in ADAM_STATE}
            for k in params if f"o_{k}_step" in z.files}
    return step, params, opt_state


def fit(scene, camera, cfg, target, params, steps=100, lr=5e-2,
        make_intersector=None, checkpoint_path=None, checkpoint_every=50,
        resume=True, callback=None, device=None):
    """Optimize `params` (dict of scene arrays) against a target image.

    Returns (params as tensors, losses).  Resumes from checkpoint_path if
    it exists.
    """
    device = resolve_device(device)

    def on_device(x):  # a numpy array or a tensor on any device
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return x.detach().to(device=device, dtype=torch.float32)

    render = make_diff_render_fn(scene, camera, cfg, make_intersector,
                                 device=device)
    target = on_device(target)
    start, opt_state = 0, None
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        start, params, opt_state = load_checkpoint(checkpoint_path, device)
    names = sorted(params)
    leaves = [on_device(params[k]).clone().requires_grad_(True) for k in names]
    opt = torch.optim.Adam(leaves, lr=lr)
    if opt_state is not None:
        sd = opt.state_dict()
        sd["state"] = {i: dict(opt_state[k]) for i, k in enumerate(names)}
        opt.load_state_dict(sd)

    def state():
        return {k: {s: opt.state[p][s] for s in ADAM_STATE}
                for k, p in zip(names, leaves)}

    losses = []
    for i in range(start, steps):
        opt.zero_grad(set_to_none=True)
        loss = l2_image_loss(render(dict(zip(names, leaves))), target)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        current = {k: p.detach() for k, p in zip(names, leaves)}
        if callback:
            callback(i, losses[-1], current)
        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, i + 1, current, state())
    return {k: p.detach() for k, p in zip(names, leaves)}, losses
