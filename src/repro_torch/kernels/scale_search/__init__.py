from repro_torch.kernels.scale_search import ops, ref  # noqa: F401
