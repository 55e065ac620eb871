"""Hand-written Hopper kernels for the perf-critical compute layers.

  gemm.py             block-tiled GEMM (csrc/gemm.cu) + its plain version;
                      the block shape comes from CrossFlow's
                      hierarchical-roofline tiling search
  flash_attention.py  online-softmax attention with causal / window /
                      kv_len masks and GQA (csrc/flash_attention.cu); the
                      LM runtime's every attention call
  rglru.py            the RG-LRU linear-recurrence scan
                      (csrc/rglru_scan.cu: a cp.async ring, or an
                      element-wise variant for unaligned shapes);
                      recurrentgemma's prefill
  mlstm.py            xLSTM's mLSTM parallel form (csrc/mlstm.cu); the
                      mLSTM blocks' prefill
  ops.py              public wrappers with the ``use_kernel`` switch
  ref.py              plain PyTorch oracles (the allclose targets)
  build.py            nvcc -> shared library -> ctypes, at first use
  csrc/               the CUDA C++ sources (sm_90a)

Each wrapper module holds its kernel's `LAUNCHES` counter (module state),
so the package re-exports the modules, not the functions of the same
names.
"""

from repro_torch.kernels import flash_attention, gemm, mlstm, ops, ref, \
    rglru
