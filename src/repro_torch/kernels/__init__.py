"""Hand-written Hopper kernels for the perf-critical compute layers.

  gemm.py     block-tiled GEMM (csrc/gemm.cu) + its plain version; the
              block shape comes from CrossFlow's hierarchical-roofline
              tiling search
  ops.py      public wrappers with the ``use_kernel`` switch
  ref.py      plain PyTorch oracles (the allclose targets)
  build.py    nvcc -> shared library -> ctypes, at first use
  csrc/       the CUDA C++ sources (sm_90a)

The other three TPU kernels of the reference (flash attention, the RG-LRU
scan, the mLSTM) are ported with the slices whose path launches them.

``repro_torch.kernels.gemm`` is the module (its `LAUNCHES` counter is
module state), so the package does not re-export the function of the same
name.
"""

from repro_torch.kernels import gemm, ops, ref
