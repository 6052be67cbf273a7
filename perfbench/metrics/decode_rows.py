"""Mean requests running in a decode of the window (the batch a decode
serves; the engine decodes every slot whatever runs in it)."""


def read(rec):
    rows = [it.rows for _, it in rec.window_steps("decode")]
    return sum(rows) / len(rows) if rows else None
