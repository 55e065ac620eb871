"""Hand-written Hopper kernels for the perf-critical compute layers.

  gemm.py             block-tiled GEMM (csrc/gemm.cu) + its plain version;
                      the block shape comes from CrossFlow's
                      hierarchical-roofline tiling search
  flash_attention.py  online-softmax attention with causal / window /
                      kv_len masks and GQA (csrc/flash_attention.cu); the
                      LM runtime's every attention call
  ops.py              public wrappers with the ``use_kernel`` switch
  ref.py              plain PyTorch oracles (the allclose targets)
  build.py            nvcc -> shared library -> ctypes, at first use
  csrc/               the CUDA C++ sources (sm_90a)

The other two TPU kernels of the reference (the RG-LRU scan, the mLSTM) are
ported with the slices whose path launches them.

``repro_torch.kernels.gemm`` and ``repro_torch.kernels.flash_attention`` are
the modules (their `LAUNCHES` counters are module state), so the package
does not re-export the functions of the same names.
"""

from repro_torch.kernels import flash_attention, gemm, ops, ref
