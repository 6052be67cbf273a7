"""Whisper-medium backbone — encoder-decoder audio transformer
[arXiv:2212.04356; unverified]. Conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, S, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab=51865,
    notes="enc-dec; vocab padded to 53248 for 16-way TP; frontend stub.",
)
