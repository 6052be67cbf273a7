"""Kimi-K2 1T-A32B — trillion-param MoE, 384 experts top-8 (paper-table)
[arXiv:2501.kimi2; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=112,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, n_dense_layers=1,
    rope_theta=50_000.0,
    optimizer="adafactor", microbatches=8, grad_accum_dtype="bfloat16",
    notes="fine-grained 384e top-8; first layer dense; adafactor for HBM.",
)
