"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

The package exports the reference's four public ops (`repro.kernels`) under
their names, with the reference's signatures less `use_kernel` and
`interpret`: on CPU tensors each takes its plain version, on CUDA tensors
it launches its kernel or raises.

    block_histogram       kernels/ell_histogram.py  csrc/ell_histogram.cu
    fennel_choose_batch   kernels/fennel_gain.py    csrc/fennel_gain.cu
    embedding_bag         kernels/embedding_bag.py  csrc/embedding_bag.cu
    swa_attention_decode  kernels/swa_attention.py  csrc/swa_attention.cu

The op `embedding_bag` takes the package attribute of its module's name, as
in the reference; `importlib.import_module("repro_torch.kernels.embedding_bag")`
reaches the module (its `launches` and plain version).  Kernel libraries are
built with nvcc at first use (`_build.py`); importing this package builds
nothing.
"""
from repro_torch.kernels.ell_histogram import block_histogram
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.fennel_gain import fennel_choose_batch
from repro_torch.kernels.swa_attention import swa_attention_decode

__all__ = ["block_histogram", "fennel_choose_batch", "embedding_bag", "swa_attention_decode"]
