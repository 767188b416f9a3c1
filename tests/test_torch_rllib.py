"""The port's RLlib (``ray_tpu_torch.rllib``) against ``ray_tpu.rllib``,
module by module, on the CPU at small widths (hidden (8, 8) or (16,
16)).

The same numpy-seeded inputs and the JAX package's parameters (bridged
by ``bridge.rl_params_from_jax``) go through both. Where the reference
draws from ``jax.random`` inside an update, its own draws are passed to
the port: PPO's per-epoch ``jax.random.permutation``s, SAC's two
``jax.random.normal``s per minibatch. Tolerances:
- bitwise: the envs, ``collect`` and the replay buffer (the same numpy
  code on both sides), the bridge's round trip;
- forwards, GAE and V-trace: 1e-6 relative to the largest entry (f32
  sums in another order);
- Adam: 1e-6 relative over 10 steps of optax.adam;
- updates: each tensor after the update within 3e-5 of its largest
  entry, the loss within 3e-5 relative (observed: up to 7.7e-6 for the
  parameters after PPO's 12 and SAC's 6 minibatch steps, 1.7e-6 for the
  losses). The first Adam steps move a parameter by about
  ``lr * sign(g)``, so a gradient near 0 could flip between XLA's and
  torch's f32 summation orders and move it by 2 lr; on these seeded
  batches none does, and DQN's batch is built so that the online net's
  argmax margins are far above the cross-package error (see
  ``test_dqn_update_matches_jax``).
The categorical sampler of the runners cannot match ``jax.random``
draw for draw, so it is checked by its distribution: a chi-square test
of 40,000 draws against softmax(logits) at p >= 1e-3.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib import appo as jappo
from ray_tpu.rllib import bc as jbc
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib import rollout as jrollout
from ray_tpu.rllib import sac as jsac

from ray_tpu_torch import bridge
from ray_tpu_torch.rllib import (appo, bc, dqn, env, impala, multi_agent,
                                 nets, ppo, rollout, sac)

FWD_TOL = 1e-6
UPD_TOL = 3e-5
H = (16, 16)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    gap = float(np.abs(got - want).max()) / scale
    assert gap <= tol, (what, gap)


def close_tree(got: dict, want: dict, tol, what=""):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            close_tree(got[k], want[k], tol, f"{what}.{k}")
        else:
            close(got[k], want[k], tol, f"{what}.{k}")


def host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def port(tree, module):
    return bridge.rl_params_from_jax(host(tree), module)


def policy_pair(seed, obs_dim=4, n_actions=2, hidden=H):
    jp = jppo.init_policy(jax.random.PRNGKey(seed), obs_dim, n_actions,
                          hidden)
    return jp, port(jp, ppo.init_policy(torch.Generator(), obs_dim,
                                        n_actions, hidden))


# --- envs, collect, replay buffer: bitwise ------------------------------

def pd_actions(obs):
    """A balancing controller: long CartPole episodes, so the 500-step
    time limit (truncation) is reached."""
    return ((obs[:, 2] + 0.5 * obs[:, 3]) > 0).astype(np.int32)


@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_envs_step_bitwise(name):
    a, b = jenv.make_env(name, 6, seed=3), env.make_env(name, 6, seed=3)
    rng = np.random.default_rng(0)
    oa, ob = a.reset_all(), b.reset_all()
    assert np.array_equal(oa, ob)
    truncs = 0
    for i in range(520):
        if name == "CartPole-v1":
            act = pd_actions(oa) if i % 7 else rng.integers(0, 2, size=6)
        else:
            act = rng.uniform(-2, 2, size=(6, 1)).astype(np.float32)
        ra, rb = a.step(act), b.step(act)
        for x, y in zip(ra, rb):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert np.array_equal(a.truncated, b.truncated)
        truncs += int(a.truncated.sum())
        oa = ra[0]
    assert truncs > 0
    with pytest.raises(ValueError, match="unknown env"):
        env.make_env("Nope-v0", 1)


def test_multi_cartpole_steps_bitwise():
    a = jenv.MultiCartPoleVec(4, seed=1)
    b = env.MultiCartPoleVec(4, seed=1)
    oa, ob = a.reset_all(), b.reset_all()
    rng = np.random.default_rng(2)
    for _ in range(200):
        act = {ag: rng.integers(0, 2, size=4) for ag in a.agents}
        ra, rb = a.step(act), b.step(act)
        for da, db in zip(ra, rb):
            assert set(da) == set(db)
            for ag in da:
                assert np.array_equal(da[ag], db[ag])
    assert env.MULTI_AGENT_ENVS.keys() == jenv.MULTI_AGENT_ENVS.keys()


def test_collect_bitwise_with_truncation_and_auto_reset():
    ja, tb = jenv.CartPoleVec(4, seed=5), env.CartPoleVec(4, seed=5)
    oa, ob = ja.reset_all(), tb.reset_all()
    ra, rb = np.zeros(4, np.float32), np.zeros(4, np.float32)
    da, db = [], []
    saw_trunc = False
    for _ in range(6):
        ba, oa = jrollout.collect(ja, oa, 100, pd_actions, ra, da)
        bb, ob = rollout.collect(tb, ob, 100, pd_actions, rb, db)
        assert set(ba) == set(bb)
        for k in ba:
            assert ba[k].dtype == bb[k].dtype and np.array_equal(ba[k], bb[k])
        assert np.array_equal(oa, ob) and np.array_equal(ra, rb)
        saw_trunc |= bool(ja.truncated.any())
    # a time-limit cut is stored as no terminal; returns count it
    assert saw_trunc and 500.0 in da and da == db


def _rb_batch(rng, n, obs_dim=3, act_shape=(1,)):
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": rng.normal(size=(n, *act_shape)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


def test_replay_buffer_ring_bitwise():
    kw = dict(act_shape=(1,), act_dtype="float32")
    a = jdqn.ReplayBuffer._cls(50, 3, 7, **kw)
    b = dqn.ReplayBuffer._cls(50, 3, 7, **kw)
    assert a.sample(8, 2) is None and b.sample(8, 2) is None
    rng = np.random.default_rng(0)
    for n in (20, 20, 25, 50, 7):        # wraps, then wraps exactly
        batch = _rb_batch(rng, n)
        assert a.add(batch) == b.add(batch)
        assert (a.idx, a.full, len(a)) == (b.idx, b.full, len(b))
        for k in ("obs", "next_obs", "actions", "rewards", "dones"):
            assert np.array_equal(getattr(a, k), getattr(b, k))
        sa, sb = a.sample(8, 3), b.sample(8, 3)
        for k in sa:
            assert sa[k].shape[:2] == (3, 8)
            assert np.array_equal(sa[k], sb[k])
    assert b.full and b.size() == 50


# --- the bridge, the forwards, the runner's act function -----------------

def _modules():
    g = torch.Generator().manual_seed(0)
    return [ppo.init_policy(g, 4, 3, H), dqn.init_q(g, 4, 2, H),
            sac.init_actor(g, 3, 2, H), sac.init_critic(g, 3, 2, H)]


@pytest.mark.parametrize("i", range(4),
                         ids=["policy", "q", "actor", "critic"])
def test_bridge_round_trip_bitwise(i):
    m = _modules()[i]
    tree = bridge.rl_params_to_jax(m)
    fresh = copy.deepcopy(m)
    for p in fresh.parameters():
        torch.nn.init.zeros_(p)
    back = bridge.rl_params_to_jax(bridge.rl_params_from_jax(tree, fresh))
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(x, y),
                 tree, back)
    for p, q in zip(m.parameters(), fresh.parameters()):
        assert torch.equal(p, q)
    jref = {
        0: lambda: jppo.init_policy(jax.random.PRNGKey(0), 4, 3, H),
        1: lambda: jdqn.init_q(jax.random.PRNGKey(0), 4, 2, H),
        2: lambda: jsac.init_actor(jax.random.PRNGKey(0), 3, 2, H),
        3: lambda: jsac.init_critic(jax.random.PRNGKey(0), 3, 2, H)}[i]()
    # the reference's own layout, key for key and shape for shape
    jax.tree.map(lambda x, y: np.testing.assert_equal(
        np.shape(x), np.shape(y)), host(jref), tree)
    with pytest.raises(ValueError, match="param keys"):
        bridge.rl_params_from_jax({"w9": np.zeros(1)}, copy.deepcopy(m))


def test_init_scales_follow_the_reference():
    g = torch.Generator().manual_seed(0)
    p = ppo.init_policy(g, 64, 64, (256, 256))
    std = {k: float(lin.weight.detach().std()) for k, lin in p.linears().items()}
    assert abs(std["0"] - np.sqrt(2 / 64)) < 0.01
    assert abs(std["1"] - np.sqrt(2 / 256)) < 0.005
    assert abs(std["_pi"] - 0.01) < 0.001 and abs(std["_v"] - 1.0) < 0.2
    assert all(float(lin.bias.detach().abs().max()) == 0
               for lin in p.linears().values())
    again = ppo.init_policy(torch.Generator().manual_seed(0), 64, 64,
                            (256, 256))
    assert all(torch.equal(a, b) for a, b in
               zip(p.parameters(), again.parameters()))


def test_forwards_match_jax():
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(32, 4)).astype(np.float32)
    jp, tp = policy_pair(3, n_actions=3)
    jl, jv = jppo.policy_forward(jp, obs)
    tl, tv = ppo.policy_forward(tp, t(obs))
    close(tl.detach(), jl, FWD_TOL, "logits")
    close(tv.detach(), jv, FWD_TOL, "value")
    assert tv.shape == (32,)

    jq = jdqn.init_q(jax.random.PRNGKey(4), 4, 2, H)
    tq = port(jq, dqn.init_q(torch.Generator(), 4, 2, H))
    close(dqn.q_forward(tq, t(obs)).detach(), jdqn.q_forward(jq, obs),
          FWD_TOL, "q")

    so = rng.normal(size=(32, 3)).astype(np.float32) * 3
    act = rng.uniform(-1, 1, size=(32, 2)).astype(np.float32)
    ja = jsac.init_actor(jax.random.PRNGKey(5), 3, 2, H)
    # widen the log-std head so the [-10, 2] clip is active
    ja = dict(ja, w_ls=ja["w_ls"] * 400.0)
    ta = port(ja, sac.init_actor(torch.Generator(), 3, 2, H))
    jmu, jls = jsac.actor_dist(ja, so)
    tmu, tls = sac.actor_dist(ta, t(so))
    close(tmu.detach(), jmu, FWD_TOL, "mu")
    close(tls.detach(), jls, FWD_TOL, "log_std")
    assert float(tls.detach().max()) == 2.0 and float(tls.detach().min()) < 0
    jc = jsac.init_critic(jax.random.PRNGKey(6), 3, 2, H)
    tc = port(jc, sac.init_critic(torch.Generator(), 3, 2, H))
    for jx, tx in zip(jsac.q_values(jc, so, act),
                      sac.q_values(tc, t(so), t(act))):
        close(tx.detach(), jx, FWD_TOL, "q_values")
    ja = jsac.init_actor(jax.random.PRNGKey(5), 3, 2, H)
    ta = port(ja, sac.init_actor(torch.Generator(), 3, 2, H))
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (32, 2)))
    jx, jlp = jsac.sample_action(ja, so, key, 2.0)
    tx, tlp = sac.sample_action(ta, t(so), t(noise), 2.0)
    close(tx.detach(), jx, FWD_TOL, "action")
    close(tlp.detach(), jlp, FWD_TOL, "logp")


def test_act_logp_and_value_match_jax_and_sampling_follows_softmax():
    from scipy.stats import chisquare
    jp, tp = policy_pair(7, n_actions=4)
    jp = dict(jp, w_pi=jp["w_pi"] * 30.0)      # logits far from uniform
    tp = port(jp, tp)
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(64, 4)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    a, logp, v = ppo.act(tp, obs, gen)
    assert a.dtype == np.int32 and logp.dtype == np.float32
    jl, jv = jppo.policy_forward(jp, obs)
    jlogp = np.asarray(jax.nn.log_softmax(jl))[np.arange(64), a]
    close(logp, jlogp, FWD_TOL, "logp")
    close(v, jv, FWD_TOL, "value")

    one = np.repeat(obs[:1], 40_000, axis=0)
    draws, _, _ = ppo.act(tp, one, gen)
    probs = np.asarray(jax.nn.softmax(jl[0]), np.float64)
    assert probs.min() > 0.02 and probs.max() < 0.9
    counts = np.bincount(draws, minlength=4)
    assert chisquare(counts, probs / probs.sum() * counts.sum()
                     ).pvalue >= 1e-3


# --- returns ------------------------------------------------------------

def _returns_inputs(T=24, N=5, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    dones = (rng.random((T, N)) < 0.15).astype(np.float32)
    assert dones[: T - 1].any()                      # mid-fragment
    return (f(T, N), f(T, N), dones, f(N), f(T, N) * 0.5, f(T, N) * 0.5)


def test_gae_matches_jax():
    r, v, d, last, _, _ = _returns_inputs()
    ja, jr = jppo._gae(r, v, d, last, 0.99, 0.95)
    ta, tr = ppo._gae(t(r), t(v), t(d), t(last), 0.99, 0.95)
    close(ta, ja, FWD_TOL, "advantages")
    close(tr, jr, FWD_TOL, "returns")


@pytest.mark.parametrize("bars", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_matches_jax(bars):
    r, v, d, last, b_logp, t_logp = _returns_inputs(seed=1)
    ratio = np.exp(t_logp - b_logp)
    assert (ratio > max(bars)).any() and (ratio < min(bars)).any()
    jvs, jadv = jimpala._vtrace(b_logp, t_logp, r, d, v, last, 0.99,
                                rho_bar=bars[0], c_bar=bars[1])
    tvs, tadv = impala._vtrace(t(b_logp), t(t_logp), t(r), t(d), t(v),
                               t(last), 0.99, rho_bar=bars[0],
                               c_bar=bars[1])
    close(tvs, jvs, FWD_TOL, "vs")
    close(tadv, jadv, FWD_TOL, "pg_adv")


# --- Adam ---------------------------------------------------------------

def test_adam_matches_optax_over_10_steps():
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(7, 5)).astype(np.float32),
            "b": rng.normal(size=5).astype(np.float32),
            "s": np.float32(0.3)}
    opt = optax.adam(3e-3)
    jp = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}
    topt = nets.adam(tp.values(), 3e-3)
    for step in range(10):
        g = {k: (rng.normal(size=np.shape(v)) * 10.0 ** (step % 3 - 1))
             .astype(np.float32) for k, v in tree.items()}
        up, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, up)
        topt.zero_grad()
        for k, p in tp.items():
            p.grad.copy_(t(g[k]))
        topt.step()
        for k in tree:
            close(tp[k].detach(), jp[k], FWD_TOL, k)
            assert tp[k].grad.data_ptr() >= topt.grad.data_ptr()


# --- updates ------------------------------------------------------------

def _fragment(T=16, N=4, obs_dim=4, n_actions=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(T, N, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, n_actions, (T, N)).astype(np.int32),
            "logp": (np.log(1 / n_actions) + 0.3 * rng.normal(size=(T, N))
                     ).astype(np.float32),
            "rewards": rng.normal(size=(T, N)).astype(np.float32),
            "dones": (rng.random((T, N)) < 0.1).astype(np.float32),
            "values": rng.normal(size=(T, N)).astype(np.float32),
            "last_value": rng.normal(size=N).astype(np.float32),
            "last_obs": rng.normal(size=(N, obs_dim)).astype(np.float32)}


def _check_policy(tp, jp, tloss, jloss):
    close_tree(bridge.rl_params_to_jax(tp), host(jp), UPD_TOL, "params")
    close(float(tloss), float(jloss), UPD_TOL, "loss")


def _jax_perms(key, epochs, n):
    return torch.stack([t(jax.random.permutation(k, n))
                        for k in jax.random.split(key, epochs)])


def test_ppo_update_matches_jax():
    frag = _fragment()
    jp, tp = policy_pair(11)
    advs, rets = jppo._gae(frag["rewards"], frag["values"], frag["dones"],
                           frag["last_value"], 0.99, 0.95)
    jb = {"obs": frag["obs"], "actions": frag["actions"],
          "logp": frag["logp"], "advantages": advs, "returns": rets}
    key = jax.random.PRNGKey(2)
    jopt = optax.adam(3e-3)
    jp2, _, jl = jppo.ppo_update(jp, jopt.init(jp), jb, key, lr=3e-3,
                                 epochs=3, minibatches=4)
    tb = {k: t(v) for k, v in jb.items()}
    tl = ppo.ppo_update(tp, nets.adam(tp.parameters(), 3e-3), tb,
                        _jax_perms(key, 3, 64), minibatches=4)
    _check_policy(tp, jp2, tl, jl)


def _vtrace_batch(frag):
    return {"obs": frag["obs"], "actions": frag["actions"],
            "behavior_logp": frag["logp"], "rewards": frag["rewards"],
            "dones": frag["dones"], "last_obs": frag["last_obs"]}


@pytest.mark.parametrize("which", ["impala", "appo"])
def test_vtrace_updates_match_jax(which):
    frag = _fragment(seed=3)
    jp, tp = policy_pair(12)
    jb = _vtrace_batch(frag)
    jopt = optax.adam(1e-3)
    if which == "impala":
        jp2, _, jl, jrho = jimpala.impala_update(
            jp, jopt.init(jp), jb, lr=1e-3, rho_bar=0.9, c_bar=1.1)
        tl, trho = impala.impala_update(
            tp, nets.adam(tp.parameters(), 1e-3),
            {k: t(v) for k, v in jb.items()}, rho_bar=0.9, c_bar=1.1)
    else:
        jp2, _, jl, jrho = jappo.appo_update(jp, jopt.init(jp), jb,
                                             lr=1e-3, clip=0.1)
        tl, trho = appo.appo_update(
            tp, nets.adam(tp.parameters(), 1e-3),
            {k: t(v) for k, v in jb.items()}, clip=0.1)
    _check_policy(tp, jp2, tl, jl)
    close(float(trho), float(jrho), UPD_TOL, "mean ratio")


def test_dqn_update_matches_jax():
    """16 double-DQN minibatches. The Q head is scaled up (x 300) and
    the next observations kept only where the online net's two Q values
    differ by more than 0.05 of their scale, so the argmax that picks
    the next action is the same on both sides through all 16 steps (the
    cross-package error is ~1e-7 of the scale)."""
    jq = jdqn.init_q(jax.random.PRNGKey(21), 4, 2, H)
    jq = dict(jq, w_q=jq["w_q"] * 300.0)
    tq = port(jq, dqn.init_q(torch.Generator(), 4, 2, H))
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(20000, 4)).astype(np.float32)
    q = np.asarray(jdqn.q_forward(jq, pool))
    keep = pool[np.abs(q[:, 0] - q[:, 1]) > 0.05 * np.abs(q).max()]
    K, B = 16, 32
    mbs = {"obs": rng.normal(size=(K, B, 4)).astype(np.float32),
           "next_obs": keep[: K * B].reshape(K, B, 4),
           "actions": rng.integers(0, 2, (K, B)).astype(np.int32),
           "rewards": rng.normal(size=(K, B)).astype(np.float32),
           "dones": (rng.random((K, B)) < 0.2).astype(np.float32)}
    jt = jax.tree.map(lambda x: x * 0.5, jq)        # a stale target
    opt = optax.adam(1e-3)
    jq2, _, jl = jdqn.dqn_update(jq, jt, opt.init(jq), mbs, lr=1e-3)
    tt = port(jt, dqn.init_q(torch.Generator(), 4, 2, H))
    tl = dqn.dqn_update(tq, tt, nets.adam(tq.parameters(), 1e-3),
                        {k: t(v) for k, v in mbs.items()})
    _check_policy(tq, jq2, tl, jl)
    nxt = keep[: K * B]
    assert np.array_equal(
        dqn.q_forward(tq, t(nxt)).argmax(1).numpy(),
        np.argmax(np.asarray(jdqn.q_forward(jq2, nxt)), 1))


def test_bc_update_matches_jax():
    jp, tp = policy_pair(13)
    rng = np.random.default_rng(5)
    mbs = {"obs": rng.normal(size=(8, 32, 4)).astype(np.float32),
           "actions": rng.integers(0, 2, (8, 32)).astype(np.int64)}
    opt = optax.adam(1e-3)
    jp2, _, jl = jbc.bc_update(jp, opt.init(jp), mbs, lr=1e-3)
    tl = bc.bc_update(tp, nets.adam(tp.parameters(), 1e-3),
                      {k: t(v) for k, v in mbs.items()})
    _check_policy(tp, jp2, tl, jl)


def test_sac_update_matches_jax():
    K, B = 6, 32
    ja = jsac.init_actor(jax.random.PRNGKey(31), 3, 1, H)
    jc = jsac.init_critic(jax.random.PRNGKey(32), 3, 1, H)
    jtc = jax.tree.map(lambda x: x * 0.9, jc)
    jla = jnp.asarray(np.log(0.1), jnp.float32)
    opt = optax.adam(1e-3)
    rng = np.random.default_rng(6)
    mbs = {"obs": rng.normal(size=(K, B, 3)).astype(np.float32),
           "next_obs": rng.normal(size=(K, B, 3)).astype(np.float32),
           "actions": rng.uniform(-2, 2, (K, B, 1)).astype(np.float32),
           "rewards": -rng.random((K, B)).astype(np.float32),
           "dones": (rng.random((K, B)) < 0.1).astype(np.float32)}
    keys = jax.random.split(jax.random.PRNGKey(8), K)
    kw = dict(gamma=0.99, tau=0.05, action_high=2.0, target_entropy=-1.0)
    ja2, jc2, jtc2, jla2, _, jls = jsac.sac_update(
        ja, jc, jtc, jla, (opt.init(ja), opt.init(jc), opt.init(jla)),
        mbs, keys, lr=1e-3, **kw)
    noise = []
    for k in keys:                 # the draws sac_update makes inside
        k1, k2 = jax.random.split(k)
        noise.append([np.asarray(jax.random.normal(kk, (B, 1)))
                      for kk in (k1, k2)])
    ta = port(ja, sac.init_actor(torch.Generator(), 3, 1, H))
    tc = port(jc, sac.init_critic(torch.Generator(), 3, 1, H))
    ttc = port(jtc, sac.init_critic(torch.Generator(), 3, 1, H))
    ttc.requires_grad_(False)
    tla = torch.tensor(np.log(0.1), dtype=torch.float32, requires_grad=True)
    opts = (nets.adam(ta.parameters(), 1e-3),
            nets.adam(tc.parameters(), 1e-3), nets.adam([tla], 1e-3))
    tls = sac.sac_update(ta, tc, ttc, tla, opts,
                         {k: t(v) for k, v in mbs.items()},
                         t(np.array(noise)), **kw)
    close_tree(bridge.rl_params_to_jax(ta), host(ja2), UPD_TOL, "actor")
    close_tree(bridge.rl_params_to_jax(tc), host(jc2), UPD_TOL, "critic")
    close_tree(bridge.rl_params_to_jax(ttc), host(jtc2), UPD_TOL,
               "target")
    close(float(tla.detach()), float(jla2), UPD_TOL, "log_alpha")
    close(tls, jls, UPD_TOL, "losses")


def test_ppo_learner_iteration_matches_jax():
    """A fragment of a fixed deterministic policy on CartPoleVec (the
    behaviour's logp and values under the initial params), through the
    reference's ``_gae`` and ``ppo_update`` and through the port's
    ``concat_fragments``/``gae_batch``/``ppo_update``."""
    jp, tp = policy_pair(14, hidden=(8, 8))
    frags = []
    for seed in (0, 1):
        e = env.CartPoleVec(4, seed=seed)
        o = e.reset_all()
        out = {k: [] for k in ("obs", "actions", "logp", "rewards",
                               "dones", "values")}
        for _ in range(32):
            a = pd_actions(o)
            logits, v = jppo.policy_forward(jp, o)
            out["obs"].append(o)
            out["actions"].append(a)
            out["logp"].append(np.asarray(jax.nn.log_softmax(logits))[
                np.arange(4), a])
            out["values"].append(np.asarray(v))
            o, r, d = e.step(a)
            out["rewards"].append(r)
            out["dones"].append(d.astype(np.float32))
        frag = {k: np.stack(v) for k, v in out.items()}
        frag["last_value"] = np.asarray(jppo.policy_forward(jp, o)[1])
        frags.append(frag)
    cat = ppo.concat_fragments(frags)
    advs, rets = jppo._gae(cat["rewards"], cat["values"], cat["dones"],
                           cat["last_value"], 0.99, 0.95)
    key = jax.random.PRNGKey(5)
    jb = {"obs": cat["obs"], "actions": cat["actions"],
          "logp": cat["logp"], "advantages": advs, "returns": rets}
    jopt = optax.adam(3e-4)
    jp2, _, jl = jppo.ppo_update(jp, jopt.init(jp), jb, key)
    tb = ppo.gae_batch(cat, torch.device("cpu"), 0.99, 0.95)
    close(tb["advantages"], advs, FWD_TOL, "advantages")
    tl = ppo.ppo_update(tp, nets.adam(tp.parameters(), 3e-4), tb,
                        _jax_perms(key, 4, 256))
    _check_policy(tp, jp2, tl, jl)


def test_multi_agent_pooling_follows_reference_order():
    """For a shared mapping the policy's batch is every runner's
    fragments, agent by agent, along the env axis: what the reference's
    ``[res[a] for res in results for a in agents if mapping[a] == pid]``
    gives."""
    agents = ("agent_0", "agent_1")
    results = []
    for r in range(2):
        res = {}
        for i, a in enumerate(agents):
            f = _fragment(T=3, N=2, seed=10 * r + i)
            f["obs"][...] = 10 * r + i      # marks runner and agent
            res[a] = f
        results.append(res)
    shared = {a: "shared" for a in agents}
    cat = multi_agent.pool_fragments(results, agents, shared, "shared")
    marks = cat["obs"][0, :, 0]
    assert marks.tolist() == [0, 0, 1, 1, 10, 10, 11, 11]
    want = [res[a] for res in results for a in agents
            if shared[a] == "shared"]
    for k in ("rewards", "dones", "values", "logp", "actions"):
        assert np.array_equal(cat[k], np.concatenate([f[k] for f in want],
                                                     axis=1))
    assert np.array_equal(cat["last_value"], np.concatenate(
        [f["last_value"] for f in want]))
    own = multi_agent.pool_fragments(results, agents,
                                     {a: a for a in agents}, "agent_1")
    assert own["obs"][0, :, 0].tolist() == [1, 1, 11, 11]


# --- placement ----------------------------------------------------------

def _bc_data():
    from ray_tpu_torch import data
    return data.from_blocks([{"obs": np.zeros((4, 4), np.float32),
                              "action": np.zeros(4, np.int64)}])


LEARNERS = {
    "PPO": lambda c: ppo.PPO(c), "IMPALA": lambda c: impala.IMPALA(c),
    "APPO": lambda c: appo.APPO(c), "DQN": lambda c: dqn.DQN(c),
    "SAC": lambda c: sac.SAC(c), "BC": lambda c: bc.BC(_bc_data(), c),
    "MultiAgentPPO": lambda c: multi_agent.MultiAgentPPO(c)}
CONFIGS = {"PPO": ppo.PPOConfig, "IMPALA": impala.IMPALAConfig,
           "APPO": appo.APPOConfig, "DQN": dqn.DQNConfig,
           "SAC": sac.SACConfig, "BC": bc.BCConfig,
           "MultiAgentPPO": multi_agent.MultiAgentPPOConfig}


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_learner_defaults_to_cuda_and_raises_without_it(name,
                                                        monkeypatch):
    """Every config's device is None (the card); with no CUDA the
    learner raises before it starts a runner, instead of training on
    the CPU."""
    assert CONFIGS[name]().device is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LEARNERS[name](CONFIGS[name]())


def test_bc_learns_on_the_cpu_when_asked():
    """BC needs no runtime: one iteration on the CPU, its policy there,
    its evaluation rollouts run by the learner's own module."""
    rng = np.random.default_rng(0)
    e = env.CartPoleVec(8, seed=1)
    o = e.reset_all()
    obs, act = [], []
    for _ in range(50):
        a = pd_actions(o)
        obs.append(o)
        act.append(a)
        o, _, _ = e.step(a)
    from ray_tpu_torch import data
    ds = data.from_blocks([{"obs": np.concatenate(obs),
                            "action": np.concatenate(act)}])
    algo = bc.BC(ds, bc.BCConfig(device="cpu", updates_per_iter=4,
                                 batch_size=16, hidden=(8, 8),
                                 eval_episodes=2))
    m = algo.train()
    assert m["dataset_size"] == 400 and np.isfinite(m["loss"])
    assert all(p.device.type == "cpu" for p in algo.policy.parameters())
    assert set(algo.get_policy_params()) == {
        "w0", "b0", "w1", "b1", "w_pi", "b_pi", "w_v", "b_v"}
    del rng
