"""Compute/communication overlap (counterpart of
`repro/distributed/overlap.py`).

`collective_matmul_allgather` is the decomposed collective matmul
[Wang et al., "Overlap communication with dependent computation",
ASPLOS'23]: instead of all-gather(x) -> matmul, the gather is unrolled
into a ring of point-to-point sends, and each hop's transfer is in flight
while the block already held is multiplied.  Each block's product is the
same `buf @ w` the all-gather version computes row by row, so the two
agree bit for bit on one rank.
"""
from __future__ import annotations

import torch  # repro: noqa RPR001 -- torch-resident module behind PEP-562-lazy distributed/__init__
import torch.distributed as dist  # repro: noqa RPR001 -- torch-resident module


def collective_matmul_allgather(x_local: torch.Tensor, w: torch.Tensor,
                                group: dist.ProcessGroup) -> torch.Tensor:
    """all_gather(x, group) @ w without a monolithic all-gather.

    x_local: this rank's rows (B_local, K); w: (K, N), the same on every
    rank.  Returns (B_local * n, N), rows in group-rank order.  At step s
    the buffer held came from rank (my + s) % n; it is multiplied while the
    next one arrives from rank my + 1 (each rank forwards to my - 1)."""
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    b_local = x_local.shape[0]
    out = x_local.new_empty((b_local * n, w.shape[1]))
    send_to = dist.get_global_rank(group, (my - 1) % n)
    recv_from = dist.get_global_rank(group, (my + 1) % n)
    buf = x_local.contiguous()
    for s in range(n):
        reqs = []
        if s + 1 < n:  # forward the buffer around the ring (none after the last use)
            nxt = torch.empty_like(buf)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, buf, send_to, group),
                dist.P2POp(dist.irecv, nxt, recv_from, group),
            ])
        src = (my + s) % n
        out[src * b_local:(src + 1) * b_local] = buf @ w
        for r in reqs:
            r.wait()
        if s + 1 < n:
            buf = nxt
    return out


def allgather_matmul_reference(x_local: torch.Tensor, w: torch.Tensor,
                               group: dist.ProcessGroup) -> torch.Tensor:
    """The baseline the decomposition must match numerically."""
    from repro_torch.distributed.spmd import all_gather

    return all_gather(x_local, 0, group) @ w
