"""The port's MoE family against the JAX package, on the CPU.

The same numpy inputs from a seed go through `repro` and `repro_torch`;
weights are JAX's `init_moe` / `models.model.init` carried across as
numpy (fp32 unless noted), with the norm weights and biases perturbed so
that every parameter counts:

  layer        `moe_capacity` over a grid; `init_moe`'s leaves; `run_moe`'s
               y and aux at slack capacity (also against both packages'
               `run_moe_reference`), at capacity factor 0.5 (JAX's index
               for a dropped entry out of range) and at 1.25 with a router
               biased so that JAX's index for a dropped entry lands on a
               later expert's kept row, with the gradients of every input
               and weight; the port's dispatch writes no read row twice and
               its drop count; bf16 in relative norm
  model        forward logits and aux, the loss with router_aux_coef · aux
               and its gradient into every leaf (a train step's),
               prefill logits and KV cache, decode steps across the ring's
               wrap, greedy generation, for qwen2-moe-smoke and
               granite-moe-smoke
  configs      the two archs' configs and counts; qwen2-moe-a2.7b's and
               granite-moe-3b-a800m's full size on the meta device against
               `jax.eval_shape` of the JAX init; the MoE sub-tree through
               `lm_params_from_numpy`
  CLI          `launch.serve_llm` and `launch.train` on the smoke configs

fp32 at rtol 1e-4 / atol 1e-5.  The whole training step of each smoke
config (clipping, AdamW, the new parameters) is held against
`repro.training.trainer` by tests/test_torch_train.py (`STEP_CASES`).  The card against the CPU: tests/test_torch_cuda.py and
`chip_smoke.py` phases 29-33.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serving import generate as jax_generate

from repro_torch.checkpoint.store import lm_params_from_numpy
from repro_torch.configs import ARCHS, LATER, get_config
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.serving import generate, make_serve_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = dict(rtol=1e-4, atol=1e-5)
MOE = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")
# the JAX functions under jit (the config static), as the JAX package's
# engine and trainer run them: op by op they take seconds a call here
jax_run_moe = jax.jit(JMoE.run_moe, static_argnums=2)
jax_forward = jax.jit(JM.forward, static_argnums=2)
jax_loss = jax.jit(JM.loss_fn, static_argnums=2)
jax_prefill = jax.jit(JM.prefill, static_argnums=(2, 3))
jax_decode = jax.jit(JM.decode_step, static_argnums=3)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, want, tol=FP32):
    np.testing.assert_allclose(port.detach().float().numpy(), _np(want),
                               **tol)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _smoke(arch, **kw):
    kw.setdefault("dtype", "float32")
    jcfg = jax_get_config(arch, smoke=True).replace(**kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _t(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(dtype or torch.float32), tree)


# ----------------------------------------------------------------------------
# the layer


def test_moe_capacity_matches_jax():
    for arch in MOE:
        for smoke in (False, True):
            jcfg = jax_get_config(arch, smoke=smoke)
            for cf in (0.5, 1.0, 1.25, 2.0):
                c = jcfg.replace(capacity_factor=cf)
                for tokens in (1, 8, 31, 128, 257, 2048, 8192):
                    assert moe.moe_capacity(tokens, ModelConfig(
                        **dataclasses.asdict(c))) == \
                        JMoE.moe_capacity(tokens, c)


@pytest.mark.parametrize("arch", MOE)
def test_init_moe_leaves_match_jax(arch):
    jcfg, cfg = _smoke(arch, dtype="bfloat16")
    want = JMoE.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_w) == len(list(M.leaves(got)))
    for path, a in flat_w.items():
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype)[6:] == str(a.dtype), path
    assert got["router"].dtype == torch.float32
    assert ("shared" in got) == bool(cfg.num_shared_experts)


def _moe_case(arch, case, seed=1):
    """(JAX cfg, port cfg, numpy params, x [4, 32, D]) for a case:
    "slack" (capacity factor 8), "tight" (0.5), "biased" (1.25, x with a
    mean of 0.5 and the router's columns of experts 0 and 2 raised)."""
    cf = {"slack": 8.0, "tight": 0.5, "biased": 1.25}[case]
    jcfg, cfg = _smoke(arch, capacity_factor=cf)
    p = jax.tree.map(np.array, JMoE.init_moe(jax.random.PRNGKey(seed), jcfg,
                                             jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        (4, 32, jcfg.d_model)).astype(np.float32)
    if case == "biased":
        x = x + 0.5
        p["router"][:, [0, 2]] += 0.05
    return jcfg, cfg, p, x


def _jax_slots(cfg, idx, T):
    """JAX's buffer index of each assignment in sorted order, and the
    port's (order, slot, keep), from the expert ids idx [T, K]."""
    E, K = cfg.num_experts, cfg.top_k
    C = moe.moe_capacity(T, cfg)
    order, slot, keep = moe.dispatch(idx.reshape(-1), E, C)
    e_sorted = idx.reshape(-1)[order]
    rank = slot - e_sorted * C
    jslot = e_sorted * C + torch.where(keep, rank, T * K)
    return jslot, slot, keep, C


@pytest.mark.parametrize("case", ["slack", "tight", "biased"])
@pytest.mark.parametrize("arch", MOE)
def test_run_moe_matches_jax(arch, case):
    jcfg, cfg, p, x = _moe_case(arch, case)
    want_y, want_aux = jax_run_moe(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), jcfg)
    tap = moe.Tap()
    got_y, got_aux = moe.run_moe(_t(p), torch.from_numpy(x), cfg, tap)
    _close(got_y, want_y)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    # what JAX drops, the port drops
    T, E, K = 128, cfg.num_experts, cfg.top_k
    _, idx = torch.topk(torch.softmax(torch.from_numpy(x).reshape(T, -1)
                                      @ torch.from_numpy(p["router"]), -1), K)
    jslot, slot, keep, C = _jax_slots(cfg, idx, T)
    assert tap.dropped == int((~keep).sum()) and tap.calls == 1
    if case == "slack":
        assert tap.dropped == 0
        _close(moe.run_moe_reference(_t(p), torch.from_numpy(x), cfg), want_y)
        _close(got_y, JMoE.run_moe_reference(jax.tree.map(jnp.asarray, p),
                                             jnp.asarray(x), jcfg))
    elif case == "tight":     # JAX's index of every dropped entry >= E·C
        assert tap.dropped > 0
        assert bool((jslot[~keep] >= E * C).all())
    else:     # JAX's index of some dropped entry is a later expert's kept row
        kept_rows = set(slot[keep].tolist())
        on_kept = [int(s) for s in jslot[~keep] if int(s) in kept_rows]
        assert on_kept, "the biased router dropped no entry onto a kept row"


@pytest.mark.parametrize("arch", MOE)
def test_run_moe_gradients_match_jax(arch):
    """The biased case (drops onto kept rows in JAX): the gradients of
    <y, ct> + aux into x, the router and every expert weight.  These sum
    128 tokens' terms of one sign (x has a mean of 0.5) into leaves of up
    to ~200, where both packages sit ~1e-6 of the leaf's largest entry from
    a float64 run, so each leaf is held at rtol 1e-4 and atol 1e-5 times
    its largest entry."""
    jcfg, cfg, p, x = _moe_case(arch, "biased")
    ct = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = JMoE.run_moe(p, x, jcfg)
        return jnp.sum(y * ct) + aux
    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = M.map_params(lambda t: t.requires_grad_(), _t(p))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.run_moe(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(ct)) + aux).backward()
    pairs = [(tx.grad, jg_x)] + [(tp[k].grad, jg_p[k])
                                 for k in ("router", "we1", "we3", "we2")]
    if "shared" in p:
        pairs += [(tp["shared"][k].grad, jg_p["shared"][k])
                  for k in ("w1", "w2", "w3")]
    for got, want in pairs:
        scale = float(np.abs(_np(want)).max())
        _close(got, want, dict(rtol=1e-4, atol=1e-5 * scale))


def test_dispatch_writes_no_read_row_twice():
    """Kept assignments get distinct rows below E·C; dropped ones the
    spare row E·C; within an expert the kept are its first C in token
    order."""
    g = torch.Generator().manual_seed(3)
    E, C = 5, 8
    e = torch.randint(0, E, (200,), generator=g)
    e[:40] = 0                                    # expert 0 overflows
    order, slot, keep = moe.dispatch(e, E, C)
    kept = slot[keep]
    assert len(set(kept.tolist())) == kept.numel()
    assert bool((kept < E * C).all()) and bool((slot[~keep] == E * C).all())
    assert bool((e[order][:-1] <= e[order][1:]).all())
    for x in range(E):
        mine = order[e[order] == x]
        assert torch.equal(mine, torch.sort(mine).values)     # stable
        assert int(keep[e[order] == x].sum()) == min(C, mine.numel())


def test_run_moe_bf16_within_relative_norm():
    """bf16 weights and activations in both packages (ROADMAP queue C
    item 3: they round at other places), held in relative norm: the port
    against JAX, and each against the JAX fp32 run of the same weights."""
    jcfg, cfg, p, x = _moe_case("qwen2-moe-a2.7b", "biased")
    jb = jax.tree.map(lambda a: jnp.asarray(a).astype(
        jnp.float32 if a.shape == p["router"].shape else jnp.bfloat16), p)
    jb["router"] = jnp.asarray(p["router"])               # fp32 router
    want, _ = jax_run_moe(jb, jnp.asarray(x).astype(jnp.bfloat16),
                          jcfg.replace(dtype="bfloat16"))
    exact, _ = jax_run_moe(jax.tree.map(lambda a: a.astype(jnp.float32), jb),
                           jnp.asarray(x, jnp.bfloat16).astype(jnp.float32),
                           jcfg)
    tp = M.map_params(lambda t: t.to(torch.bfloat16), _t(p))
    tp["router"] = torch.from_numpy(p["router"])
    got, _ = moe.run_moe(tp, torch.from_numpy(x).to(torch.bfloat16),
                         cfg.replace(dtype="bfloat16"))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), _np(want)) < 2e-2
    assert _rel(got.float(), _np(exact)) < 2e-2
    assert _rel(_np(want), _np(exact)) < 2e-2


# ----------------------------------------------------------------------------
# the model


def _weights(jcfg, seed=0):
    """JAX init with norm weights and qkv biases perturbed: (JAX params,
    the port's params on the CPU)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, JM.init(jax.random.PRNGKey(seed), jcfg))
    sub = tree["periods"]["sub0"]
    for key in ("bq", "bk", "bv"):
        if key in sub["attn"]:
            sub["attn"][key] = (0.1 * rng.standard_normal(
                sub["attn"][key].shape)).astype(np.float32)
    for node, key in ((sub, "ln1"), (sub, "ln2"), (tree, "final_norm")):
        node[key] = (1 + 0.1 * rng.standard_normal(node[key].shape)
                     ).astype(np.float32)
    return (jax.tree.map(jnp.asarray, tree),
            lm_params_from_numpy(tree, "cpu", "float32"))


def _tokens(shape, vocab, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, shape)
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_loss_match_jax(arch):
    """The aux losses of the layers summed, and added to the loss at
    router_aux_coef."""
    jcfg, cfg = _smoke(arch)
    jparams, params = _weights(jcfg)
    jtok, tok = _tokens((2, 48), jcfg.vocab_size)
    got, aux = M.forward(params, {"tokens": tok}, cfg)
    want, jaux = jax_forward(jparams, {"tokens": jtok}, jcfg)
    _close(got, want)
    assert float(aux) > 1.0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    loss, met = M.loss_fn(params, {"tokens": tok}, cfg)
    jloss, jmet = jax_loss(jparams, {"tokens": jtok}, jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_train_step_gradients_match_jax(arch):
    """A training step's gradients: `loss_fn` (cross entropy plus
    router_aux_coef · aux, remat on) differentiated into every leaf, the
    router's and the experts' included, against `jax.grad` of the JAX
    `loss_fn`.  The whole step (clipping, AdamW, the new parameters)
    against `repro.training.trainer` is `STEP_CASES` in
    tests/test_torch_train.py."""
    jcfg, cfg = _smoke(arch)
    jparams, params = _weights(jcfg)
    jtok, tok = _tokens((2, 40), jcfg.vocab_size, seed=5)
    want = jax.jit(jax.grad(lambda p: JM.loss_fn(p, {"tokens": jtok},
                                                 jcfg)[0]))(jparams)
    ps = M.map_params(lambda t: t.requires_grad_(), params)
    M.loss_fn(ps, {"tokens": tok}, cfg)[0].backward()
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat) == len(list(M.leaves(ps)))
    for path, w in flat.items():
        t = ps
        for k in path:
            t = t[k.key]
        _close(t.grad, w)
    router = ps["periods"]["sub0"]["moe"]["router"].grad
    assert float(router.abs().max()) > 0


@pytest.mark.parametrize("arch", MOE)
def test_prefill_matches_jax(arch):
    jcfg, cfg = _smoke(arch)
    jparams, params = _weights(jcfg)
    jtok, tok = _tokens((2, 64), jcfg.vocab_size)
    want, jcache = jax_prefill(jparams, {"tokens": jtok}, jcfg, 72)
    got, cache = M.prefill(params, {"tokens": tok}, cfg, 72)
    _close(got, want)
    assert cache["pos"] == int(jcache["pos"]) == 64
    for name in ("k", "v"):
        _close(cache["blocks"]["sub0"][name], jcache["blocks"]["sub0"][name])


@pytest.mark.parametrize("arch", MOE)
def test_decode_steps_match_jax_across_the_ring_wrap(arch):
    """Prefill 6 tokens into a ring of 4 slots, then 6 decode steps."""
    jcfg, cfg = _smoke(arch, sliding_window=4)
    jparams, params = _weights(jcfg)
    jtok, tok = _tokens((2, 12), jcfg.vocab_size, seed=4)
    _, jcache = jax_prefill(jparams, {"tokens": jtok[:, :6]}, jcfg, 12)
    _, cache = M.prefill(params, {"tokens": tok[:, :6]}, cfg, 12)
    step = make_serve_step(cfg)
    for t in range(6, 12):
        want, jcache = jax_decode(jparams, jtok[:, t:t + 1], jcache, jcfg)
        got, cache = step(params, tok[:, t:t + 1], cache)
        _close(got, want)
        for name in ("k", "v"):
            _close(cache["blocks"]["sub0"][name],
                   jcache["blocks"]["sub0"][name])


@pytest.mark.parametrize("arch", MOE)
def test_greedy_generate_matches_jax(arch):
    jcfg, cfg = _smoke(arch)
    jparams, params = _weights(jcfg)
    jtok, tok = _tokens((3, 16), jcfg.vocab_size, seed=2)
    want = jax_generate(jparams, jcfg, jtok, 8, temperature=0.0)
    got = generate(params, cfg, tok, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE)
def test_tap_records_and_pins_the_routing_through_generate(arch):
    """A `Tap` handed to `generate` sees every MoE call (each layer's
    prefill and decode steps), and pins them: at the run's own choices the
    tokens are the same; at other choices every call takes those."""
    _, cfg = _smoke(arch)
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(3))
    seen = moe.Tap(record=True)
    out = generate(params, cfg, tok, 4, tap=seen)
    assert seen.calls == len(seen.routes) == 4 * cfg.num_layers
    assert torch.equal(out, generate(params, cfg, tok, 4))
    own = [i for _, i in seen.routes]
    assert torch.equal(out, generate(params, cfg, tok, 4,
                                     tap=moe.Tap(choices=own)))
    other = [(i + 1) % cfg.num_experts for i in own]
    pinned = moe.Tap(record=True, choices=other)
    generate(params, cfg, tok, 4, tap=pinned)
    assert all(torch.equal(i, want) for (_, i), want in
               zip(pinned.routes, other))


# ----------------------------------------------------------------------------
# configs, size, weights, CLI


def test_configs_match_jax():
    assert set(LATER) == set()
    for arch in MOE:
        assert arch in ARCHS
        for smoke in (False, True):
            got, want = get_config(arch, smoke), jax_get_config(arch, smoke)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.param_counts() == want.param_counts()
            assert [got.mlp_kind(i) for i in range(got.num_layers)] == \
                ["moe"] * got.num_layers


@pytest.mark.parametrize("arch,total", [("qwen2-moe-a2.7b", 14_004_322_304),
                                        ("granite-moe-3b-a800m",
                                         3_298_693_632)])
def test_full_size_on_the_meta_device_matches_jax(arch, total):
    cfg = get_config(arch)
    assert cfg.param_counts()["total"] == total
    params = M.init(torch.Generator(), cfg, device="meta")
    shapes = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0),
                                            jax_get_config(arch)))
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}

    def walk(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{prefix}['{k}']")
        else:
            yield prefix, t
    got = dict(walk(params))
    assert set(got) == set(want)
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape, key
        assert str(t.dtype)[6:] == str(want[key].dtype), key
    assert M.param_count(params) == sum(int(np.prod(v.shape))
                                        for v in want.values())
    moe_p = params["periods"]["sub0"]["moe"]
    assert moe_p["router"].dtype == torch.float32
    assert moe_p["we1"].shape == (cfg.num_layers, cfg.num_experts,
                                  cfg.d_model, cfg.moe_d_ff)


def test_lm_params_from_numpy_takes_the_moe_subtree():
    jcfg = jax_get_config("qwen2-moe-a2.7b", smoke=True)       # bf16
    tree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jcfg))
    kept = lm_params_from_numpy(tree, "cpu")
    sub = kept["periods"]["sub0"]["moe"]
    assert sub["router"].dtype == torch.float32
    assert sub["router"].shape == (2, 256, 4)
    assert sub["we1"].dtype == torch.bfloat16
    assert sub["we1"].shape == (2, 4, 256, 128)
    assert sub["we2"].shape == (2, 4, 128, 256)
    assert sub["shared"]["w1"].shape == (2, 256, 128)
    np.testing.assert_array_equal(
        sub["we3"].float().numpy(),
        np.asarray(tree["periods"]["sub0"]["moe"]["we3"], np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_numpy(dict(tree, vision={"proj": np.zeros(2)}), "cpu")


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_serve_llm_cli_serves_qwen2_moe_on_the_cpu():
    out = _run("repro_torch.launch.serve_llm", "--smoke", "--device", "cpu",
               "--arch", "qwen2-moe-a2.7b", "--batch", "2", "--prompt-len",
               "20", "--new-tokens", "4")
    assert "qwen2-moe-smoke" in out and "2 plain calls" in out
    assert "dropped by capacity over 8 run_moe calls" in out


def test_train_cli_trains_granite_moe_on_the_cpu():
    out = _run("repro_torch.launch.train", "--smoke", "--device", "cpu",
               "--arch", "granite-moe-3b-a800m", "--steps", "2", "--batch",
               "2", "--seq", "32")
    assert "granite-moe-smoke" in out and "step     1 loss" in out
    assert "flash attention (B4): 0 kernel launches, 8 plain calls" in out
    assert "dropped by capacity over 8 run_moe calls" in out
