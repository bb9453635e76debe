from repro_torch.kernels.fp8_matmul import ops, ref  # noqa: F401
