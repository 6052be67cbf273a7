"""Chameleon-34B — early-fusion VLM backbone; VQ image tokens live in the
token vocabulary, so the modality frontend is a stub (token ids in)
[arXiv:2405.09818; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab=65536,
    optimizer="adafactor", microbatches=4,
    notes="early-fusion VLM: image VQ codes are ordinary vocab ids.",
)
