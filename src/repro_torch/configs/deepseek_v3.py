"""DeepSeek-V3 671B: the paper's own experimental model (DAQ pilot study).

MLA is approximated with GQA kv=8, as in the reference's config: the DAQ
technique operates on weight matrices and is agnostic to the attention
variant; keeping the MoE structure (256 routed experts top-8 + 1 shared,
first 3 layers dense) preserves the quantization surface that matters for
the delta-preservation study.

[arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,             # per-expert FFN width
    vocab_size=129280,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    first_k_dense=3,
    d_ff_dense=18432,
    rope_theta=10000.0,
    source="arXiv:2412.19437; hf",
    subquadratic=False,
    notes="Paper's pilot model. MLA approximated as GQA (see DESIGN.md).",
)
