"""Mean engine time of the window's decodes (``iteration_log`` dt), ms."""


def read(rec):
    dts = [it.dt for _, it in rec.window_steps("decode")]
    return 1e3 * sum(dts) / len(dts) if dts else None
