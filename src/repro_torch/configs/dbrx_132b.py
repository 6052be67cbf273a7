"""DBRX-132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=10752, vocab=100352,
    n_experts=16, top_k=4,
    rope_theta=500_000.0,
    optimizer="adafactor", microbatches=4,
    notes="16e top-4 fine-grained MoE.",
)
