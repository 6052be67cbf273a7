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
