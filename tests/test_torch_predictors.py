"""The port's request predictor (``core/predictors.py``) against the JAX
reference on the CPU, and Table II's parameter counts.

Weights come across with ``core.io.predictor_params_from_numpy``; the
reference runs under ``jax.jit``.  Standards: the type-token table and the
buckets of carried draws exact; logits, the loss and one AdamW step within
1e-5; a port trained 150 steps on its own draws clears the accuracy
thresholds of ``tests/test_system.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import han as jhan, predictors as jpred, sac as jsac
from repro.env import env as jenv
from repro.train import optimizer as jopt
from repro_torch.core import io, predictors, sac
from repro_torch.env import env as env_lib

TOL = 1e-5


def _pair(seed=0):
    jcfg, cfg = jpred.PredictorConfig(), predictors.PredictorConfig()
    jparams = jpred.init_params(jax.random.PRNGKey(seed), jcfg, 6)
    model = io.predictor_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, 6, device="cpu")
    return jcfg, cfg, jparams, model


def test_table_forward_and_parameter_count_match_reference():
    jcfg, cfg, jparams, model = _pair()
    for seed in (0, 3):
        np.testing.assert_array_equal(
            np.asarray(jpred.make_type_token_table(jcfg, 8, seed)),
            predictors.make_type_token_table(cfg, 8, seed, device="cpu").numpy())
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (16, cfg.seq_len)).astype(np.int32)
    experts = rng.integers(0, 6, 16).astype(np.int32)
    want = jax.jit(lambda p, t, e: jpred.forward(p, jcfg, t, e))(
        jparams, toks, experts)
    with torch.no_grad():
        got = predictors.forward(model, cfg, torch.as_tensor(toks),
                                 torch.as_tensor(experts))
    for g, w in zip(got, want):
        assert g.shape == (16, cfg.n_buckets)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    n_ref = sum(int(x.size) for x in jax.tree_util.tree_leaves(jparams))
    assert predictors.count_params(model) == n_ref
    fresh = predictors.init_params(cfg, 6, device="cpu")
    assert predictors.count_params(fresh) == n_ref
    for (k, a), b in zip(fresh.state_dict().items(),
                         model.state_dict().values()):
        assert a.shape == b.shape, k


def test_han_and_actor_critic_parameter_counts_match_reference():
    """Table II's other rows: the HAN's and the actor-critic's counts."""
    jcfg = jsac.SACConfig()
    jparams = jsac.init_params(jax.random.PRNGKey(0), jcfg)
    model = sac.SAC(sac.SACConfig(), torch.Generator().manual_seed(0))
    count = lambda m: sum(p.numel() for p in m.parameters())
    assert count(model.han) == jhan.count_params(jparams["han"])
    assert sum(count(getattr(model, k)) for k in ("actor", "q1", "q2")) == \
        sum(jhan.count_params(jparams[k]) for k in ("actor", "q1", "q2"))


def test_buckets_of_carried_draws_are_exact():
    """``buckets`` on the reference's own request draws (scores and output
    lengths, edge values included) equals the reference's ``make_batch``
    arithmetic bit for bit."""
    jcfg, cfg = jpred.PredictorConfig(), predictors.PredictorConfig()
    jpool = jenv.make_env_pool(jenv.EnvConfig())
    pool = env_lib.make_env_pool(env_lib.EnvConfig(), device="cpu")
    table = jpred.make_type_token_table(jcfg, jpool.n_types, 0)
    b = jax.jit(lambda k: jpred.make_batch(jcfg, jpool, table, k, 512))(
        jax.random.PRNGKey(4))
    keys = jax.random.split(jax.random.PRNGKey(4), 512)

    def draws(k):
        k1, _, k3 = jax.random.split(k, 3)
        from repro.env.profiles import sample_request
        r = sample_request(jpool, k1)
        n = jax.random.randint(k3, (), 0, jpool.n_experts)
        return r["score"][n], r["out_len"][n]

    score, out_len = jax.jit(jax.vmap(draws))(keys)
    sb, lb = predictors.buckets(cfg, torch.as_tensor(np.array(score)),
                                torch.as_tensor(np.array(out_len)))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(b["score_bucket"]))
    np.testing.assert_array_equal(lb.numpy(), np.asarray(b["len_bucket"]))
    edges = torch.tensor([0.0, 0.0999999, 0.1, 0.95, 1.0])
    lens = torch.tensor([8, 29, 30, 299, 300], dtype=torch.int32)
    sb, lb = predictors.buckets(cfg, edges, lens)
    assert sb.tolist() == [0, 0, 1, 9, 9] and lb.tolist() == [0, 0, 1, 9, 9]
    # the port's own batch: shapes, dtypes and ranges
    batch = predictors.make_batch(
        cfg, pool, predictors.make_type_token_table(cfg, 8, device="cpu"),
        torch.Generator().manual_seed(0), 64)
    assert batch["text"].shape == (64, cfg.seq_len)
    assert int(batch["text"].max()) < cfg.vocab
    for k in ("expert", "score_bucket", "len_bucket"):
        assert batch[k].dtype == torch.int32 and batch[k].shape == (64,)
    assert int(batch["expert"].max()) < 6


def test_one_adamw_step_on_a_carried_batch_matches_reference():
    """The loss and its gradient (``jax.value_and_grad`` of the reference's
    loss) and one AdamW step of the reference's ``train`` settings (warmup
    50, weight decay 0), taken at step 60 so the learning rate is live."""
    jcfg, cfg, jparams, model = _pair(seed=2)
    jpool = jenv.make_env_pool(jenv.EnvConfig())
    table = jpred.make_type_token_table(jcfg, jpool.n_types, 0)
    jb = jax.jit(lambda k: jpred.make_batch(jcfg, jpool, table, k, 64))(
        jax.random.PRNGKey(9))

    def jloss(p):
        ls, ll = jpred.forward(p, jcfg, jb["text"], jb["expert"])
        ce = lambda lg, y: -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(lg), y[:, None], axis=-1))
        return ce(ls, jb["score_bucket"]) + ce(ll, jb["len_bucket"])

    jo = jopt.make_optimizer("adamw", peak_lr=1e-3, warmup_steps=50,
                             total_steps=1500, weight_decay=0.0)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    jnew, _, _ = jax.jit(jo.update)(jg, jo.init(jparams), jparams,
                                    jnp.asarray(60))
    opt = predictors.make_optimizer(model, 1500, 1e-3)
    opt.step.fill_(60)
    b = {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}
    loss = predictors.loss_fn(model, cfg, b)
    grads = torch.autograd.grad(loss, opt.tensors())
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    flat = lambda t: {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                               for p in path): np.asarray(x) for path, x in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    name = lambda k: k.replace(".", "/")
    jgrads, jparams_new = flat(jg), flat(jnew)
    assert len(jgrads) == len(grads)
    for (k, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), jgrads[name(k)], atol=TOL,
                                   rtol=1e-4, err_msg=k)
    opt.update(grads)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams_new[name(k)],
                                   atol=TOL, rtol=0, err_msg=k)


def test_port_trained_150_steps_clears_the_references_thresholds():
    """``train`` on the port's own draws, 150 steps of 256 on the CPU: the
    thresholds of ``tests/test_system.py`` (score top-1 > 0.25, top-3 >
    0.6; length top-1 > 0.2)."""
    pool = env_lib.make_env_pool(env_lib.EnvConfig(), device="cpu")
    cfg = predictors.PredictorConfig()
    logs = []
    # one thread: many small products, which threads beside other test
    # workers slow down many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, m = predictors.train(cfg, pool, steps=150,
                                     log_fn=logs.append, log_every=50)
    finally:
        torch.set_num_threads(threads)
    assert [x["step"] for x in logs] == [0, 50, 100, 149]
    assert logs[-1]["loss"] < logs[0]["loss"]
    assert m["score_top1"] > 0.25 and m["score_top3"] > 0.6, m
    assert m["len_top1"] > 0.2, m
    assert m["n_params"] == predictors.count_params(params)
