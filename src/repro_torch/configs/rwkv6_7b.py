"""RWKV6 (Finch) 7B — attention-free, data-dependent decay linear attention
[arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_head=64,
    d_ff=14336, vocab=65536,
    head_size=64, decay_lora=64,
    notes="attention-free; constant-size state -> runs long_500k.",
)
