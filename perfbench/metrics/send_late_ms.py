"""99th percentile of how late the client sent a request (sent - due), ms:
the client can send only between the server's steps."""
import numpy as np


def read(rec):
    late = rec.window.lateness()
    late = late[np.isfinite(late)]
    return float(np.percentile(late, 99)) * 1e3 if late.size else None
