"""Mean engine time of the window's prefills (``iteration_log`` dt: the
graph replay through the synchronising copy of its token), ms."""


def read(rec):
    dts = [it.dt for _, it in rec.window_steps("prefill")]
    return 1e3 * sum(dts) / len(dts) if dts else None
