"""StarCoder2-15B — dense GQA+RoPE code LLM [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_head=128,
    d_ff=24576, vocab=49152,
    rope_theta=100_000.0, qkv_bias=True, microbatches=2,
    notes="GQA kv=4, RoPE; code model.",
)
