"""The check catches a broken timed path: a run (everything but the look
for a card) with the server broken underneath comes out not correct, once
for each fault a served cell can have, and a sound run comes out correct.
One chip, so no exchange between chips to leave out.  A weight rounded in
place by the program is caught too, since the reference draws its own.  And the control:
at a tiny size, the reference computed in fp8 in the program's place
reads gaps several times the bf16 program's, and the check under a limit
between them passes the program and fails the control."""
import numpy as np
import pytest
import torch

from perfbench import control, run, tiny
from perfbench.references import transformer as reference

SEED = 2 ** 31 + 99


def altered_token(server):
    """Every third decode returns each slot's token plus one."""
    decode, calls = server._decode_all, [0]

    def broken(tokens):
        out = decode(tokens)
        calls[0] += 1
        return (out + 1) % server.cfg.vocab if calls[0] % 3 == 0 else out
    server._decode_all = broken


def state_unchanged(server):
    """A decode leaves the cache's keys and values as it found them."""
    step = server._decode_step

    def broken():
        k, v = server.cache["k"].clone(), server.cache["v"].clone()
        out = step()
        server.cache["k"].copy_(k)
        server.cache["v"].copy_(v)
        return out
    server._decode_step = broken


def half_batch(server):
    """A decode computes the first half of the slots; the others get back
    the token they fed."""
    decode = server._decode_all
    half = server.slots // 2

    def broken(tokens):
        out = decode(tokens).clone()
        out[half:] = torch.as_tensor(np.asarray(tokens[half:]),
                                     dtype=out.dtype)
        return out
    server._decode_all = broken


def weights_rounded(server):
    """Every matrix of the served model rounded in place to float8 e4m3
    with a scale per output channel, as a program serving at fp8 would
    hold it."""
    with torch.no_grad():
        for p in server.params.parameters():
            if p.dim() > 1:
                p.copy_(reference.fp8_round(p.float(), 1).to(p.dtype))


def one_run(family, fault=None):
    cell = tiny.cell(family)
    with tiny.one_thread():
        sess = run.Session(cell, SEED, "cpu")
        sess.warm_up()
        if fault is not None:
            fault(sess.server)
        win = sess.window(cell.cell["rate"], 1.0, cell.cell["grace_s"], SEED)
        sess.close_server()
        r = sess.judge(win)
    checks = run.checks(r, sess.cell.cell["check"]["limits"])
    return all(run.passes(c) for c in checks.values()), r


@pytest.mark.parametrize("family", ["dense", "moe"])
@pytest.mark.parametrize("fault", [None, altered_token, state_unchanged,
                                   half_batch, weights_rounded],
                         ids=["sound", "altered_token", "state_unchanged",
                              "half_batch", "weights_rounded"])
def test_fault_makes_the_run_incorrect(family, fault):
    correct, r = one_run(family, fault)
    assert correct == (fault is None), r


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_control_reads_far_above_the_program(family):
    cell = tiny.cell(family, "bfloat16", margin=0.02, rate=12.0)
    # a mean-gap limit between the readings, as the card's cells have it
    cell.cell["check"]["limits"] = {"mean_gap": 1e-3}
    with tiny.one_thread():
        r = control.readings(cell, SEED, 1.0, "cpu", True)
    assert r["failed"] == 0 and r["judged"] >= 40
    assert r["control_max_gap"] >= 3 * r["max_gap"] > 0, r
    assert r["control_mean_gap"] >= 3 * r["mean_gap"] > 0, r
    assert r["correct"] and not r["control_correct"], r
