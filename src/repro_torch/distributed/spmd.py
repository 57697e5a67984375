"""Local regions: the port's counterpart of a `shard_map` body.

A model runs on DTensors placed by `distributed/sharding.py`, and DTensor's
sharding propagation decides the layout of each op it has a rule for.
Where it has none (a kernel bound by ctypes, `index_copy_`, `index_add`,
the attention loop), the op runs here on plain local tensors: its inputs
are redistributed to the layout the op needs, taken out with `to_local`,
and its result wrapped back with `from_local`.

The gradient of a local input follows the JAX transpose of a replicated
`shard_map` input: where a tensor is replicated over a mesh axis that the
region's tokens are split over, each rank's local gradient is a partial
sum (`Partial()`), and DTensor reduces it on the way back.
"""
from __future__ import annotations

import torch  # repro: noqa RPR001 -- mesh-region module; from models/ only
from torch.distributed.device_mesh import DeviceMesh  # repro: noqa RPR001 -- mesh-region module
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # repro: noqa RPR001 -- mesh


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def with_placements(x: DTensor, placements) -> DTensor:
    placements = tuple(placements)
    return x if tuple(x.placements) == placements else x.redistribute(x.device_mesh,
                                                                      placements)


def local_in(x: DTensor, placements, split_dims=()) -> torch.Tensor:
    """x redistributed to `placements`, as a plain local tensor.  Its
    gradient is partial over each mesh dimension in `split_dims` that
    `placements` replicate (the region's other inputs are split there)."""
    placements = tuple(placements)
    grad = tuple(Partial() if (i in split_dims and isinstance(p, Replicate)) else p
                 for i, p in enumerate(placements))
    return with_placements(x, placements).to_local(grad_placements=grad)


def local_out(t: torch.Tensor, mesh: DeviceMesh, placements, shape) -> DTensor:
    """A region's local result as a DTensor of global `shape`."""
    shape = torch.Size(shape)
    stride, step = [], 1
    for n in reversed(shape):   # contiguous strides, with no tensor made
        stride.append(step)
        step *= max(n, 1)
    stride = tuple(reversed(stride))
    return DTensor.from_local(t.contiguous(), mesh, tuple(placements), run_check=False, shape=shape,
                              stride=stride)


def global_offset(x: DTensor) -> tuple[int, ...]:
    """The global index of this rank's first element of `x`, from the mesh
    coordinate alone (no tensor op, so it works under a fake tensor mode).
    A dimension split over several mesh dimensions splits in mesh order, as
    DTensor does."""
    pl = tuple(x.placements)
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    size = list(x.shape)
    off = [0] * len(size)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            d = p.dim
            size[d] = -(-size[d] // mesh.size(i))
            off[d] += coord[i] * size[d]
    return tuple(off)


def replicated(ndim_mesh: int) -> tuple:
    return tuple(Replicate() for _ in range(ndim_mesh))


def split_mesh_dims(placements) -> tuple[int, ...]:
    """Mesh dimensions along which `placements` split a tensor."""
    return tuple(i for i, p in enumerate(placements) if isinstance(p, Shard))


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as fc

    return fc.wait_tensor(fc.all_reduce(x, "sum", group))


def all_gather(x: torch.Tensor, dim: int, group, *, autograd: bool = False) -> torch.Tensor:
    """Tiled all-gather along `dim` (group-rank order); with `autograd`, its
    backward is the reduce-scatter of the gradient."""
    from torch.distributed import _functional_collectives as fc

    if autograd:
        gather = getattr(fc, "all_gather_single_autograd", None) or fc.all_gather_tensor_autograd
    else:
        gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
    return fc.wait_tensor(gather(x.contiguous(), dim, group))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all along dim 0, with its backward."""
    from torch.distributed import _functional_collectives as fc

    return fc.wait_tensor(fc.all_to_all_single_autograd(x.contiguous(), None, None, group))


class _SumAcross(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the region's output is
    one global value held by every rank, so the cotangent each rank
    receives is already the global one."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedIn(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: a tensor every rank
    holds whole, used on local shards; its gradient is the sum of the
    ranks' partial gradients (JAX's transpose of a `P()` input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    return _SumAcross.apply(x, group)


def replicated_in(x: torch.Tensor, group) -> torch.Tensor:
    return _ReplicatedIn.apply(x, group)


def matmul(x, w):
    """`x @ w` for x (..., K) and a 2-D w, on DTensors or plain tensors.

    On a mesh the product is a local region in one of two layouts, the one
    that moves fewer elements: with many tokens (train, prefill) w is
    gathered whole and each rank multiplies its own tokens (FSDP: its
    gradient is reduce-scattered back to w's layout); with few tokens
    (decode) the tokens are gathered along the mesh dimensions that split
    w, each rank multiplies them by its own block of w, and the block
    products are summed or stitched back into x's layout.  An x split
    along K (head-parallel attention's output) is gathered along K first."""
    if not is_dtensor(w):
        return x @ w
    mesh = w.device_mesh
    k_split = Shard(x.ndim - 1)
    if k_split in x.placements:
        x = with_placements(x, tuple(Replicate() if p == k_split else p for p in x.placements))
    x_pl = tuple(x.placements)
    k_dim, n_dim = w.shape
    out_shape = (*x.shape[:-1], n_dim)
    tokens = x.numel() // k_dim
    if tokens * (k_dim + n_dim) >= k_dim * n_dim:
        w_full = local_in(w, replicated(mesh.ndim), split_mesh_dims(x_pl))
        return local_out(x.to_local() @ w_full, mesh, x_pl, out_shape)
    w_pl = tuple(w.placements)
    xg_pl = tuple(Replicate() if isinstance(wp, Shard) else xp for wp, xp in zip(w_pl, x_pl))
    grad = tuple(Partial() if isinstance(wp, Shard) else xp for wp, xp in zip(w_pl, xg_pl))
    x_g = with_placements(x, xg_pl).to_local(grad_placements=grad)
    k0 = global_offset(w)[0]
    w_loc = local_in(w, w_pl, split_mesh_dims(xg_pl))
    y = x_g[..., k0:k0 + w_loc.shape[0]] @ w_loc
    y_pl = tuple(Partial() if wp == Shard(0) else Shard(y.ndim - 1) if wp == Shard(1)
                 else xp for wp, xp in zip(w_pl, xg_pl))
    return with_placements(local_out(y, mesh, y_pl, out_shape), x_pl)


def embedding(table, idx):
    """`table[idx]` for a (V, D) table, on DTensors or plain tensors.  On a
    mesh each rank looks up, for the indices of the mesh dimensions that
    split the table, the rows its block holds (zero elsewhere), and the
    blocks' results are summed or stitched into idx's layout, the
    embedding dimension whole."""
    if not is_dtensor(table):
        return table[idx.long()]
    mesh = table.device_mesh
    i_pl = tuple(idx.placements)
    t_pl = tuple(table.placements)
    ig_pl = tuple(Replicate() if isinstance(tp, Shard) else ip for tp, ip in zip(t_pl, i_pl))
    ids = with_placements(idx, ig_pl).to_local().long()
    r0 = global_offset(table)[0]
    loc = local_in(table, t_pl, split_mesh_dims(ig_pl))
    rows = ids - r0
    mine = (rows >= 0) & (rows < loc.shape[0])
    y = loc[rows.clamp(0, loc.shape[0] - 1)] * mine[..., None].to(loc.dtype)
    y_pl = tuple(Partial() if tp == Shard(0) else Shard(y.ndim - 1) if tp == Shard(1)
                 else ip for tp, ip in zip(t_pl, ig_pl))
    out = local_out(y, mesh, y_pl, (*idx.shape, table.shape[1]))
    return with_placements(out, i_pl)
