"""The collectives and the engine's ``"shard"`` backend on 4 gloo ranks
(``tests/torch_dist_worker.py``, one process per rank on a ``FileStore``
under ``tmp_path``; every worker runs one CPU thread, and a run fails as
soon as a rank exits with an error or its deadline passes)."""
import torch

from torch_dist_worker import run_world


def test_shard_engine_equals_torch_backend(tmp_path):
    """``advance_all(backend="shard")`` on 4 ranks, N=16 (4 experts a
    rank), R=W=4, two envs of 100 Poisson steps: queues, clocks and each
    step's completions bit-equal to ``backend="torch"`` on every rank."""
    res = run_world("shard_engine", 4, tmp_path)
    want = res[0]["torch"]
    assert float(want["done"].sum()) > 10.0
    for rank, r in enumerate(res):
        assert r["rows"] == (4 * rank, 4 * rank + 4)
        got = r["shard"]
        assert torch.equal(got["clocks"], want["clocks"]), rank
        assert torch.equal(got["done"], want["done"]), rank
        for k, x in want["queues"].items():
            assert torch.equal(got["queues"][k], x), (rank, k)


def test_shard_env_keeps_blocks_and_gathers_what_it_reads(tmp_path):
    """The env under ``engine_backend="shard"`` on 4 ranks, N=8: each
    rank's state holds its 2 experts' queue rows and clocks, which,
    concatenated in rank order, equal the ``"torch"`` backend's, with the
    same metrics, for QLL on a ragged fleet, a SAC router on the padded
    observation and QLL under ``rolling_outage`` with failover.  The
    advance gathers the six accumulators alone (B x N x 6 words a step)
    and never the queue rows; each reader's gather moves what it reads:
    the routers' two counts per expert, one float per env for the impact
    penalty, one word per env for the push, the channels it reads for
    the observation (six words a running slot, five a waiting one),
    every row for the failover step, one float per expert for the shed
    watermark."""
    res = run_world("shard_env", 4, tmp_path)
    b, n, r, w = 2, 8, 5, 5
    rows_words = n * (2 * 5 * r + 2 * 4 * w)     # run_i/f 5 ch, wait_i/f 4
    obs_words = n * (6 * r + 5 * w)
    per_step = {"accumulators": b * n * 6 * 4, "impact": b * 4,
                "admit": b * 4}
    expect = {
        "qll": {**per_step, "router load": b * n * 2 * 4},
        "sac": {**per_step, "observation": b * obs_words * 4},
        "failover": {**per_step, "router load": b * n * 2 * 4,
                     "failover": b * rows_words * 4,
                     "occupancy": b * n * 4}}
    steps = {"qll": 60, "sac": 20, "failover": 160}
    assert res[0]["failover torch"]["metrics"]["redispatched"] > 0
    for name, want_bytes in expect.items():
        want = res[0][name + " torch"]
        assert want["metrics"]["completed"] > 0, name
        for rank, rk in enumerate(res):
            assert rk["rows"] == (2 * rank, 2 * rank + 2)
            got = rk[name]
            assert got["metrics"] == want["metrics"], (name, rank)
            assert got["bytes"] == {k: v * steps[name]
                                    for k, v in want_bytes.items()}, (
                name, got["bytes"])
        for k, x in want["tensors"].items():
            dim = 0 if k.startswith("retry_buf") else 1
            got = (res[0][name]["tensors"][k] if dim == 0 else torch.cat(
                [rk[name]["tensors"][k] for rk in res], dim=1))
            assert torch.equal(got, x), (name, k)


def test_collectives_on_four_ranks(tmp_path):
    """``ring_allreduce`` within 1e-4 of the exact sum and
    ``compressed_allreduce`` of a replicated input within ``max|g| / 127 +
    1e-6`` of it (the reference test's bounds), alike on every rank, the
    residual the quantisation error; ``sum_disjoint`` bit-exact (``-0.0``
    kept, bools and ints) and ``gather_rows`` in rank order."""
    res = run_world("collectives", 4, tmp_path)
    x, g, vals = res[0]["x"], res[0]["g"], res[0]["vals"]
    exact = x.double().sum(0)
    bound = float(g.abs().max()) / 127 + 1e-6
    for r in res:
        assert float((r["ring"].double() - exact).abs().max()) < 1e-4
        assert torch.equal(r["ring"], res[0]["ring"])
        assert float((r["avg"] - g).abs().max()) <= bound
        assert torch.equal(r["avg"], res[0]["avg"])
        assert torch.equal(r["res"], g - r["avg"])
        s = r["sum"]
        assert torch.equal(s["v"].view(torch.int32), vals.view(torch.int32))
        assert torch.equal(s["m"]["b"], vals[:, 0] > 0)
        assert torch.equal(s["m"]["i"], torch.arange(8, dtype=torch.int32))
        assert torch.equal(r["gathered"]["v"], vals)
        assert torch.equal(r["gathered"]["i"],
                           torch.arange(8, dtype=torch.int32))
