"""Per-rank accounting of one mesh step: collective bytes, flops, bytes
accessed, peak live bytes and the roofline terms (counterpart of
`repro/launch/hlo_analysis.py`).

torch has no HLO to parse, so the counts come from what torch exposes:
`StepCounter`, a dispatch mode entered around a step (`launch/steps.py::
step_cell(..., mode=StepCounter())`), sees every op a rank runs on its
*local* tensors.  DTensor ops pass through it (it returns NotImplemented
for them), so what it counts is the ops DTensor runs on each rank's
shards, plus the functional collectives its redistributions and the
port's local regions issue (DTensor's sharding propagation, which runs an
op once on fake tensors of the global shapes, is not counted).  So every count is per rank:

- collective bytes: the output bytes of each `_c10d_functional`
  collective (the reference's rule: the output shape's bytes), by kind;
- flops: `torch.utils.flop_counter`'s formulas (matmuls, convolutions,
  attention) applied to the local ops;
- bytes accessed: each local op's input and output bytes, views excluded
  (an upper bound, no fusion);
- peak live bytes: the bytes of storages alive at once, the step's
  arguments included, tracked with storage weak references.

`RooflineTerms` turns them into times with one NVIDIA H100 SXM's published
peaks (NVIDIA's data sheet, dense, at the 700 W limit): 989e12 bf16
flop/s, 3.35e12 B/s of HBM, and NVLink at 450e9 B/s each way (900 GB/s
both ways).  Under the dry-run's fake process group on a CPU mesh,
DTensor runs an all-to-all as an all-gather and a chunk, and the bytes
counted are that all-gather's.
"""
from __future__ import annotations

import dataclasses
import sys

import torch  # repro: noqa RPR001 -- step analysis; dry-run only
from torch.utils._python_dispatch import TorchDispatchMode  # repro: noqa RPR001 -- base class at def

PEAK_FLOPS = 989e12   # bf16 dense flop/s, one H100 SXM (NVIDIA data sheet, 700 W)
HBM_BW = 3.35e12      # bytes/s of HBM3, one H100 SXM (NVIDIA data sheet)
NVLINK_BW = 450e9     # bytes/s one way of NVLink 4 (900 GB/s both ways), H100 SXM

COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
_KIND = {
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "all_reduce": "all_reduce",
    "all_reduce_": "all_reduce",
    "all_reduce_coalesced": "all_reduce",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_to_all_single": "all_to_all",
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _in_sharding_propagation() -> bool:
    """True inside DTensor's sharding propagation, which runs each new op
    once on fake tensors of the *global* shapes to learn the output's
    metadata: those calls are no rank's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts one rank's collectives, flops, bytes and live storage while
    a step runs under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collectives["count"] = 0
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.arg_bytes = 0
        self._storages: dict[int, tuple] = {}

    def track(self, tree) -> None:
        """Count tensors made before the step (its arguments) as live."""
        before = self.live
        for t in _tensors(tree):
            self._hold(t)
        self.arg_bytes += self.live - before

    def _hold(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef

        if t.device.type == "meta":   # shapes only, nothing any rank holds
            return
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        ref = StorageWeakRef(st)
        if ref.cdata in self._storages:
            return
        self._sweep()
        self._storages[ref.cdata] = (ref, st.nbytes())
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._storages.items() if ref.expired()]
        for k in dead:
            self.live -= self._storages.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor

        if any(issubclass(t, torch.Tensor) and not issubclass(t, FakeTensor)
               and t is not torch.Tensor and not issubclass(t, torch.nn.Parameter)
               for t in types):
            return NotImplemented   # a DTensor op: count the local ops it runs
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _KIND.get(packet.__name__)
            if kind is not None:
                self.collectives[kind] += sum(_nbytes(t) for t in _tensors(out))
                self.collectives["count"] += 1
        else:
            from torch.utils.flop_counter import flop_registry

            formula = flop_registry.get(packet)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                    + sum(_nbytes(t) for t in _tensors(out))
        if not func.is_view:
            for t in _tensors(out):
                self._hold(t)
        return out

    def collective_bytes(self) -> dict[str, int]:
        out = dict(self.collectives)
        out["total"] = sum(out[k] for k in COLLECTIVES)
        return out


def remat_duplication(flops_with_remat: float, flops_without: float) -> float:
    """The flops the per-layer recompute adds, as a share of the step's
    flops without it (`torch.utils.checkpoint` on and off; the reference
    reads a fusion ratio off the HLO instead)."""
    return (flops_with_remat - flops_without) / flops_without if flops_without else 0.0


@dataclasses.dataclass
class RooflineTerms:
    """All byte/flop counts are PER RANK (`StepCounter` counts a rank's
    local ops), so `flops / PEAK_FLOPS` is the step's compute time on one
    card."""

    flops: float              # flops per rank
    hbm_bytes: float          # bytes accessed per rank
    coll_bytes: float         # collective output bytes per rank
    n_devices: int
    model_flops: float = 0.0  # 6*N*D useful flops for the WHOLE step

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "peaks": "NVIDIA H100 SXM data sheet: 989e12 bf16 flop/s, 3.35e12 B/s HBM, "
                     "450e9 B/s NVLink one way",
        }


def analyze_counter(counter: StepCounter, n_devices: int,
                    model_flops: float = 0.0) -> RooflineTerms:
    return RooflineTerms(
        flops=float(counter.flops), hbm_bytes=float(counter.bytes_accessed),
        coll_bytes=float(counter.collective_bytes()["total"]),
        n_devices=n_devices, model_flops=model_flops,
    )
