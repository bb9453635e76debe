from repro_torch.kernels.fp8_quant import ops, ref  # noqa: F401
