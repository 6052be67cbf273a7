"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, pattern
(rec, rec, attn) [arXiv:2402.19427; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab=256000,
    rnn_width=2560, conv_width=4, window=2048,
    block_pattern=("rec", "rec", "attn"),
    notes="10 q-heads not divisible by 16 -> attention weights FSDP-only; "
          "local attn window 2048; runs long_500k.",
)
