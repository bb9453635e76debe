"""PyTorch + CUDA port of the DAQ reproduction (``repro`` is the JAX reference).

The package mirrors ``src/repro`` module for module.  It imports ``torch`` and
numpy only — never JAX, ``ml_dtypes`` or any module of ``repro``.  Entry
points run on the GPU unless the caller passes ``device="cpu"``; the three
hand-written Hopper kernels (``repro_torch.kernels``) launch for CUDA tensors
and fall back to their plain PyTorch versions only for CPU tensors.

    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize
    from repro_torch.engine import Engine

    model = build_model(get_arch("glm4-9b"))
    qparams, report = quantize(params_post, params_base,
                               QuantConfig(use_fused_kernel=True),
                               mode="storage")
    outputs = Engine(model, qparams, slots=8, cache_len=256,
                     k_steps=8).serve(requests, gen_tokens=64)
"""
