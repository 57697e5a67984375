"""Device selection for the port: explicit, and never silently the CPU.

Engines take a device name (`MultilevelConfig.device`, `serve_lm`'s
`device`, default "cuda").  A CUDA request with no card raises instead of
running on the host, and `preflight`, which the driver and `serve_lm` call
first, also builds and loads the kernel libraries once, so a kernel that
does not build fails the run before the first record or request rather
than inside one.
"""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    dev = torch.device(name)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch runs on 'cpu' or 'cuda', got {str(dev)!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the host"
        )
    return dev


def preflight(name: str | torch.device) -> torch.device:
    """`resolve_device`, plus building and loading every kernel library
    when the device is a card."""
    dev = resolve_device(name)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
        for kernel in _build.SOURCES:
            _build.load(kernel)
    return dev
