"""The dry run's records as a markdown table, one row per (arch x shape)
cell with both production meshes side by side (arithmetic for one H100
80GB rank, not a measurement).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod --out DIR
    python scripts/dryrun_table.py DIR

Per rank and mesh: argument, temp and output GB (``memory``), whether
argument + temp fit the card's 80 GB, the tensor-core FLOPs
(``hlo_totals.flops``), the memory bytes and the collective wire bytes.
Then, for the sanity row, qwen1.5-0.5b ``train_4k`` on 16 x 16 against
6 N T over the 16 ``model`` ranks, with remat's extra forward (2 N T).
"""
from __future__ import annotations

import glob
import json
import os
import sys

MESHES = ("pod16x16", "pod2x16x16")
CARD_BYTES = 80e9


def load(out_dir: str) -> dict:
    recs = {}
    for path in glob.glob(os.path.join(out_dir, "*.json")):
        with open(path) as f:
            rec = json.load(f)
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return recs


def cell(rec) -> str:
    if not rec.get("ok"):
        return f"FAILED: {rec.get('error', '?')[:60]}"
    mem, tot = rec["memory"], rec["hlo_totals"]
    gb = lambda n: f"{n / 1e9:.2f}"
    fits = "yes" if mem["argument_bytes"] + mem["temp_bytes"] <= CARD_BYTES \
        else "no"
    return (f"{gb(mem['argument_bytes'])} / {gb(mem['temp_bytes'])} / "
            f"{gb(mem['output_bytes'])} | {fits} | {tot['flops']:.3e} | "
            f"{tot['memory_bytes']:.3e} | {tot['collective_wire_bytes']:.3e}")


def main(out_dir: str) -> None:
    recs = load(out_dir)
    cells = sorted({(a, s) for a, s, _ in recs})
    head = " | ".join(f"{m}: arg / temp / out GB | fits | flops | memory "
                      f"bytes | wire bytes" for m in MESHES)
    print(f"| arch | shape | {head} |")
    print("| --- | --- |" + " --- | --- | --- | --- | --- |" * len(MESHES))
    for arch, shape in cells:
        row = " | ".join(cell(recs[(arch, shape, m)]) if (arch, shape, m)
                         in recs else "not run | | | |" for m in MESHES)
        print(f"| {arch} | {shape} | {row} |")
    qwen = recs.get(("qwen1.5-0.5b", "train_4k", "pod16x16"))
    if qwen and qwen.get("ok"):
        print(json.dumps(sanity(qwen)))


def sanity(rec) -> dict:
    """qwen1.5-0.5b's ``train_4k`` FLOPs a rank on 16 x 16 by hand: 6 N T
    over the 16 ``model`` ranks; with the port's step, each block's
    forward once more (``cfg.remat``: 8 N_blocks T) but its last product,
    the MLP's ``w_down`` (2 d_ff d T a layer: the non-reentrant
    recompute stops once the backward has what it saved), the tied head
    over the padded vocab (6 d V_padded T; its lookup is no product), and
    the blockwise attention's visited blocks four times (forward,
    recompute, a backward of two)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.layers import block_pairs

    cfg, shape, m = get_config("qwen1.5-0.5b"), SHAPES["train_4k"], 16
    rows, s = shape.global_batch // 16, shape.seq_len
    tokens = rows * s
    n = cfg.n_params()
    emb = cfg.vocab * cfg.d_model
    bq, bkv = min(cfg.attn_block_q, s), min(cfg.attn_block_kv, s)
    pairs = len(block_pairs(s // bq, s // bkv, bq, bkv, True, 0, 0)) \
        * bq * bkv
    attn = 4 * (4 * cfg.d_head * (cfg.n_heads // m) * rows * pairs
                * cfg.n_layers)
    early_stop = 2 * cfg.d_ff * cfg.d_model * tokens * cfg.n_layers
    by_hand = (8 * (n - emb) * tokens - early_stop
               + 6 * cfg.d_model * cfg.vocab_padded * tokens) / m + attn
    counted = rec["hlo_totals"]["flops"]
    return {"sanity": "qwen1.5-0.5b train_4k pod16x16", "params": n,
            "tokens_per_rank": tokens, "six_n_t_over_16": 6 * n * tokens / m,
            "attention_flops": attn, "remat_early_stop_flops": early_stop / m,
            "by_hand_flops": by_hand,
            "counted_flops": counted, "counted_over_by_hand": counted / by_hand}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch")
