"""The V-cycle's level-0 pack: the CUDA kernel, its wrapper, its plain
version, the compact layout the host uploads and the host's own pack, the
oracle of both.

From a batch model's CSR — indptr (n+1, int64), indices (e, int32),
edge_w (e, float32), node_w (n, float32), pinned (n, int64) — `csr_pack`
writes the padded buffers the device V-cycle reads:

    esrc, edst (e_pad, int64), ew (e_pad, float64)   the directed edge list,
        padded with (n_pad, n_pad, 0)                 `CSRGraph.to_coo_padded`
    node_w (n_pad, float64), pin (n_pad, int64)      padded with 0 and -2
    nbr (n_pad, w_pad, int64), wts (n_pad, w_pad, float32)
        only when `w_pad` (a multiple of 4) is given: the level-0 ELL
        tiles, -1 and 0 padding, rows cut to their first w_pad entries
                                                     `CSRGraph.to_ell_padded`

Replaces no TPU kernel: the reference pads these buffers on the host.  On a
card the host uploads the compact CSR instead (`compact_layout`: one block,
each section 16-byte aligned) and `csrc/csr_pack.cu` writes the padding,
bound by its writes (24·e_pad + 16·n_pad + 12·n_pad·w_pad bytes, `bound_bytes`).

`csr_pack` takes the plain version only for tensors on the CPU (the CPU
V-cycle's pack); for CUDA tensors it launches the kernel or raises.  Both
write into `pack_outputs` buffers, which a caller may allocate first.
`launches` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

launches = 0
# several threads may launch at once (the sharded driver's workers)
_count_lock = threading.Lock()

# the compact block's sections in order: (name, dtype, length for a CSR of
# n rows and e directed edges); the order is the entry point's
SECTIONS = (
    ("indptr", torch.int64, lambda n, e: n + 1),
    ("indices", torch.int32, lambda n, e: e),
    ("edge_w", torch.float32, lambda n, e: e),
    ("node_w", torch.float32, lambda n, e: n),
    ("pinned", torch.int64, lambda n, e: n),
)
_ALIGN = 16


def compact_layout(n: int, e: int) -> tuple[list[tuple[int, int]], int]:
    """([(byte offset, bytes)] a section, total bytes) of the compact block
    for a CSR of n rows and e directed edges; each section starts 16-byte
    aligned."""
    out, off = [], 0
    for _, dt, length in SECTIONS:
        size = int(length(n, e)) * dt.itemsize
        out.append((off, size))
        off += -(-size // _ALIGN) * _ALIGN
    return out, off


def compact_views(block: torch.Tensor, n: int, e: int) -> list[torch.Tensor]:
    """The five sections of a uint8 compact block (host or device) as typed
    1-D views, in `SECTIONS` order."""
    layout, _ = compact_layout(n, e)
    return [block[off:off + size].view(dt)
            for (off, size), (_, dt, _) in zip(layout, SECTIONS)]


def bound_bytes(n_pad: int, e_pad: int, w_pad: int | None) -> int:
    """The bytes the pack writes: the yardstick of its time."""
    return 24 * e_pad + 16 * n_pad + 12 * n_pad * (w_pad or 0)


def pack_outputs(n_pad: int, e_pad: int, w_pad: int | None, device) -> tuple:
    """The buffers `csr_pack` writes, allocated and not yet written, in its
    return order; nbr and wts are None without `w_pad`."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    tiles = (None, None) if w_pad is None else (
        empty((n_pad, w_pad), torch.int64), empty((n_pad, w_pad), torch.float32))
    return (empty(e_pad, torch.int64), empty(e_pad, torch.int64), empty(e_pad, torch.float64),
            empty(n_pad, torch.float64), empty(n_pad, torch.int64), *tiles)


def csr_pack_plain(indptr, indices, edge_w, node_w, pinned, n_pad: int, e_pad: int,
                   w_pad: int | None = None, out=None):
    """Plain PyTorch version: the host pack's arithmetic on tensors, into
    `out` (`pack_outputs`) when it is given."""
    dev = indptr.device
    n, e = node_w.shape[0], indices.shape[0]
    deg = indptr[1:] - indptr[:-1]
    esrc, edst, ew, nw, pin, nbr, wts = out or pack_outputs(n_pad, e_pad, w_pad, dev)
    esrc[e:] = n_pad
    edst[e:] = n_pad
    ew[e:] = 0
    esrc[:e] = torch.repeat_interleave(torch.arange(n, device=dev), deg, output_size=e)
    edst[:e] = indices.long()
    ew[:e] = edge_w.double()
    nw[n:] = 0
    nw[:n] = node_w.double()
    pin[n:] = -2
    pin[:n] = pinned
    if w_pad is None:
        return esrc, edst, ew, nw, pin, None, None
    col = torch.arange(w_pad, device=dev)
    take = col[None, :] < deg[:, None]
    pos = torch.where(take, indptr[:-1, None] + col, e)  # e: a -1 / 0 slot appended
    nbr[n:] = -1
    wts[n:] = 0
    nbr[:n] = torch.cat([indices.long(), indices.new_full((1,), -1).long()])[pos]
    wts[:n] = torch.cat([edge_w, edge_w.new_zeros(1)])[pos]
    return esrc, edst, ew, nw, pin, nbr, wts


def host_pack(g, pinned, n_pad: int, e_pad: int, w_pad: int | None = None) -> list:
    """The same buffers as numpy arrays from the host's own padding,
    `CSRGraph.to_coo_padded` and `to_ell_padded` (the tiles widened to
    int64), as the V-cycle packed before this kernel: the oracle that the
    tests and `chip_smoke.py` hold `csr_pack` to."""
    import numpy as np

    src, dst, w = g.to_coo_padded(n_pad, e_pad)
    node_w = np.zeros(n_pad, dtype=np.float64)
    node_w[:g.n] = g.node_w
    pin = np.full(n_pad, -2, dtype=np.int64)
    pin[:g.n] = pinned
    out = [src, dst, w, node_w, pin]
    if w_pad is None:
        return out + [None, None]
    nbr, wts, _ = g.to_ell_padded(np.arange(g.n, dtype=np.int64), row_bucket=n_pad,
                                  width_bucket=w_pad)
    return out + [nbr.astype(np.int64), wts]


def _check(arrays, n_pad: int, e_pad: int, w_pad: int | None, out) -> None:
    for (name, dt, _), t in zip(SECTIONS, arrays):
        if t.dtype != dt:
            raise TypeError(f"csr_pack takes {name} as {dt}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"csr_pack takes {name} as a contiguous 1-D tensor")
        if t.device != arrays[0].device:
            raise ValueError(f"tensors on {arrays[0].device} and {t.device}")
    indptr, indices, edge_w, node_w, pinned = arrays
    n, e = node_w.shape[0], indices.shape[0]
    if indptr.shape[0] != n + 1 or pinned.shape[0] != n or edge_w.shape[0] != e:
        raise ValueError(
            f"csr_pack takes indptr (n+1,), indices and edge_w (e,), node_w and pinned "
            f"(n,); got {[tuple(t.shape) for t in arrays]}")
    if n_pad < n or e_pad < e:
        raise ValueError(f"n_pad {n_pad} < {n} rows or e_pad {e_pad} < {e} edges")
    if w_pad is not None and (w_pad < 4 or w_pad % 4):
        raise ValueError(f"w_pad must be a positive multiple of 4, got {w_pad}")
    if out is not None:
        want = pack_outputs(n_pad, e_pad, w_pad, "meta")
        if len(out) != len(want) or any(
                (o is None) != (w is None) or o is not None and (
                    o.dtype != w.dtype or o.shape != w.shape or not o.is_contiguous()
                    or o.device != indptr.device)
                for o, w in zip(out, want)):
            raise ValueError("csr_pack's out does not match pack_outputs at this shape")


_LAUNCH = None


def _launcher():
    """The C entry point with its ctypes signature, loaded once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("csr_pack").csr_pack_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def csr_pack(indptr, indices, edge_w, node_w, pinned, n_pad: int, e_pad: int,
             w_pad: int | None = None, out=None):
    """(esrc, edst, ew, node_w, pin, nbr, wts): the padded level-0 buffers,
    written into `out` (`pack_outputs` on the tensors' device) when it is
    given; nbr and wts are None without `w_pad`."""
    arrays = (indptr, indices, edge_w, node_w, pinned)
    n_pad, e_pad = int(n_pad), int(e_pad)
    w_pad = None if w_pad is None else int(w_pad)
    if indptr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"csr_pack runs on cpu or cuda tensors, got {indptr.device}")
    _check(arrays, n_pad, e_pad, w_pad, out)
    if indptr.device.type == "cpu":
        return csr_pack_plain(*arrays, n_pad, e_pad, w_pad, out=out)
    return _pack_on_card(arrays, n_pad, e_pad, w_pad, out)


def _pack_on_card(arrays, n_pad: int, e_pad: int, w_pad: int | None, out):
    """The card path of `csr_pack`: one launch on the current stream of the
    tensors' device, counted."""
    global launches
    device = arrays[0].device
    n, e = arrays[3].shape[0], arrays[1].shape[0]
    esrc, edst, ew, nw, pin, nbr, wts = out or pack_outputs(n_pad, e_pad, w_pad, device)
    launch = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(*(t.data_ptr() for t in arrays),
                     esrc.data_ptr(), edst.data_ptr(), ew.data_ptr(), nw.data_ptr(),
                     pin.data_ptr(), 0 if nbr is None else nbr.data_ptr(),
                     0 if wts is None else wts.data_ptr(),
                     n, e, n_pad, e_pad, w_pad or 0, stream)
    if err != 0:
        raise RuntimeError(f"csr_pack launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    return esrc, edst, ew, nw, pin, nbr, wts
