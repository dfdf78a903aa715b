"""`top_k` with the reference's tie order.

`jax.lax.top_k` returns, among equal values, the lower index first.
`torch.topk` promises no order for ties on either device, so the port
selects with a stable descending sort: equal values keep their index
order, the same rows come out in the same order as in the reference.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the `k` largest entries along the last axis,
    descending, ties by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
