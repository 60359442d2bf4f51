"""Scene partitioning into spatial domains: the median-split assignment of
``spray_tpu/domains/partition.py`` (host-side numpy)."""

from __future__ import annotations

import numpy as np


def median_split_assign(centers, n_domains):
    """Recursive median split along the widest axis -> (T,) domain id per tri.

    n_domains need not be a power of two: splits proportionally.
    """
    ntri = len(centers)
    assign = np.zeros(ntri, np.int32)

    def rec(idx, dom_lo, dom_hi):
        k = dom_hi - dom_lo
        if k <= 1 or len(idx) == 0:
            assign[idx] = dom_lo
            return
        c = centers[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        k_left = k // 2
        # proportional split point keeps tri counts balanced
        cut = int(round(len(idx) * k_left / k))
        order = np.argsort(c[:, axis], kind="stable")
        rec(idx[order[:cut]], dom_lo, dom_lo + k_left)
        rec(idx[order[cut:]], dom_lo + k_left, dom_hi)

    rec(np.arange(ntri), 0, n_domains)
    return assign
