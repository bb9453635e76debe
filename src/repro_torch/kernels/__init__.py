"""Hand-written Hopper (sm_90a) CUDA kernels, one per Pallas kernel of ``repro``:

  scale_search -- fused DAQ candidate sweep (the paper's Alg. 1 hot spot)
  fp8_quant    -- one-pass block absmax + E4M3 cast
  fp8_matmul   -- fused block-dequant fp8 matmul (fp8 serving): tensor-core
                  kernels for decode (mma.sync) and prefill (wgmma), and a
                  CUDA-core kernel for every other operand pair, picked by
                  ``kernel.route`` from the shapes and x's dtype

Each is a ``kernel/ops/ref`` triad like the reference's: ``kernel.py``
launches the CUDA source(s) in ``repro_torch/csrc/``, ``ref.py`` is the plain
PyTorch version, and ``ops.py`` picks the kernel for GPU tensors and the
plain version for CPU tensors.  ``_lib.KERNELS`` holds the launch counts.
"""
