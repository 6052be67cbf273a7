"""Config system: model architecture configs + input-shape cells.

Every assigned architecture is a ``ModelConfig`` in its own module; the
registry in ``repro_torch.configs`` exposes ``get_config(name)`` and shape
cells.  A copy of the reference's ``repro/configs`` (the port imports
nothing of ``repro``); the fields keep their names and defaults, so a
config means the same in both packages.  The port reads ``remat`` (each
layer recomputed in the training backward, as the reference's
``jax.checkpoint``), ``seq_parallel`` (the residual stream split by
sequence over ``model``, ``models/transformer.py``) and ``attn_impl``
(the training forward's attention); ``scan_layers`` and the other
TPU-only fields it keeps but does not read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (public-literature configs).

    ``family`` is one of: dense | moe | ssm | hybrid | encdec.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # --- attention ---
    attention: str = "full"  # full | swa
    window: int = 0  # sliding window size when attention == "swa"
    rope_theta: float = 10_000.0
    qkv_bias: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_dense_layers: int = 0  # leading dense layers before MoE layers
    capacity_factor: float = 1.25
    moe_psum_dtype: str = "float32"  # bf16 halves EP combine wire bytes

    # --- SSM (rwkv6) ---
    head_size: int = 64  # rwkv head size
    decay_lora: int = 64  # low-rank dim for data-dependent decay
    # dtype of the intra-chunk decay tensor D in the XLA wkv path:
    # "compute" (bf16 on TPU; halves the dominant HBM stream) or "float32"
    rwkv_d_dtype: str = "compute"

    # --- hybrid (recurrentgemma) ---
    rnn_width: int = 0
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")

    # --- enc-dec (whisper backbone) ---
    n_enc_layers: int = 0

    # --- numerics / structure ---
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    scan_layers: bool = True
    remat: bool = True
    optimizer: str = "adamw"  # adamw | adafactor
    # gradient accumulation: global batch is processed as `microbatches`
    # sequential slices; activations cost 1/M, grads accumulate in
    # `grad_accum_dtype`
    microbatches: int = 1
    grad_accum_dtype: str = "float32"
    # attention implementation: "xla" (blockwise jnp; used on CPU & for
    # dry-run lowering) or "pallas" (TPU kernels).
    attn_impl: str = "xla"
    # Megatron-style sequence parallelism: residual stream sharded over
    # `model` on the sequence dim between blocks (norm/elementwise segments
    # run S-sharded; GSPMD inserts the all-gather/reduce-scatter pair
    # around attention/MLP)
    seq_parallel: bool = False
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    rwkv_chunk: int = 32
    notes: str = ""

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the LM head shards cleanly over 16-way TP."""
        return _round_up(self.vocab, 2048)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is bounded (supports long_500k)."""
        return self.family in ("ssm", "hybrid") or self.attention == "swa"

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def n_params(self) -> int:
        """Analytic parameter count (embedding unpadded)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.family == "moe":
            moe_layers = self.n_layers - self.n_dense_layers
            ffn_moe = self.n_experts * 3 * d * f + d * self.n_experts
            ffn_dense = 3 * d * f
            ffn_total = moe_layers * ffn_moe + self.n_dense_layers * ffn_dense
            per_layer_rest = attn + 2 * d
            core = ffn_total + self.n_layers * per_layer_rest
        elif self.family == "ssm":
            # rwkv6: time-mix (r,k,v,g,o ≈ 5 d^2 + decay lora) + channel mix
            tmix = 5 * d * d + 2 * d * self.decay_lora + 6 * d
            cmix = 2 * d * f
            core = self.n_layers * (tmix + cmix + 2 * d)
        elif self.family == "hybrid":
            n_attn = sum(1 for i in range(self.n_layers)
                         if self.block_pattern[i % len(self.block_pattern)] == "attn")
            n_rec = self.n_layers - n_attn
            rec = (2 * d * self.rnn_width + self.rnn_width * d
                   + 2 * self.rnn_width * self.rnn_width // 1  # gates (lr + ig)
                   + self.conv_width * self.rnn_width + self.rnn_width)
            ffn = 3 * d * f
            core = n_attn * (attn + ffn + 2 * d) + n_rec * (rec + ffn + 2 * d)
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn + 2 * d * f + 2 * d)
            dec = self.n_layers * (2 * attn + 2 * d * f + 3 * d)
            core = enc + dec
        else:  # dense
            core = self.n_layers * (attn + 3 * d * f + 2 * d)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return core + emb

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        moe_layers = self.n_layers - self.n_dense_layers
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 * d * f
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supported_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Shape cells defined for this arch (long_500k only if sub-quadratic)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return tuple(names)


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    small: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
        d_head=16,
        d_ff=128,
        vocab=256,
        scan_layers=cfg.scan_layers,
        remat=False,
        param_dtype="float32",
        compute_dtype="float32",
        attn_block_q=16,
        attn_block_kv=16,
        rwkv_chunk=8,
        microbatches=1,
        grad_accum_dtype="float32",
    )
    if cfg.family == "moe":
        small.update(n_experts=4, top_k=2, n_dense_layers=min(cfg.n_dense_layers, 1))
    if cfg.family == "hybrid":
        small.update(rnn_width=64, block_pattern=cfg.block_pattern, n_layers=3)
    if cfg.family == "ssm":
        small.update(head_size=16, decay_lora=8)
    if cfg.family == "encdec":
        small.update(n_enc_layers=2)
    if cfg.attention == "swa":
        small.update(window=32)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
