"""Granite-34B-Code — llama-arch MQA code model [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab=49152,
    optimizer="adafactor", microbatches=4,
    notes="MQA (kv=1); deep 88-layer code model.",
)
