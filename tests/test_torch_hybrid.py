"""The port's hybrid family (jamba-1.5-large-398b) against the JAX
package, on the CPU.

The same numpy inputs from a seed go through `repro` and `repro_torch`;
weights are JAX's `models.model.init` pytree (norm weights, the SSM's
conv bias, dt bias and D skip perturbed in numpy so that every parameter
counts) carried across by `lm_params_from_numpy`, fp32 rtol 1e-4 / atol
1e-5 unless stated.  The model tests run jamba's own period on the smoke
widths (`PERIOD`: 8 layers, attention at offset 4, MoE on the odd
layers), which the smoke config lacks (its period is 2 layers):

  config, size    `get_config("jamba-1.5-large-398b")` and its smoke
                  config field for field; the full config on the meta
                  device against `jax.eval_shape` of JAX's init
                  (397,711,939,584 parameters) and the one-period,
                  8-expert cut that one card holds (25,817,044,992)
  init            a one-period stack is views of its draws, not copies,
                  and every registered arch's seeded smoke init is the
                  stacking by copy, value for value
  weights         `lm_params_from_numpy` carries a JAX hybrid across and
                  names the hybrid's blocks when it refuses one
  model           forward logits, aux loss and `loss_fn` (JAX at
                  attn_impl "naive" and at "pallas" in interpret mode, the
                  port on B4's and B5's plain versions); prefill and three
                  greedy decode steps: logits, the k/v ring and the SSM
                  caches (state, conv), `pos`, the tokens; without a
                  window and with one shorter than the prompt
  training        one `Trainer` step: loss, every gradient leaf, the new
                  parameters (within 1e-6 plus the gap Adam's first step
                  puts between the two packages' gradients where they lie
                  near its eps)
  CLIs            `serve_llm` and `launch.train` on the smoke config

The logits of the 8-layer period are held at atol 5e-5 (`DEEP`): the
JAX package's SSM scan sums in fp32 and the port's plain scan in fp64
within a chunk, so the two round apart layer by layer (1.1e-5 at the
smoke config's 2 layers, 2.5e-5 at 8, at |logits| up to 6.2; JAX's own
"naive" and "pallas" routes differ by 6.9e-6 there).

B4 and B5 at jamba's shapes on the card are held by
tests/test_torch_cuda.py and `chip_smoke.py` (phases 56-58).
"""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.data import make_batch as jax_make_batch
from repro.models import model as JM
from repro.training import trainer as JT

from repro_torch.checkpoint.store import lm_params_from_numpy
from repro_torch.configs import ARCHS, LATER, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import serve_llm
from repro_torch.models import blocks, layers
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving import make_prefill_fn, make_serve_step
from repro_torch.training import trainer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "jamba-1.5-large-398b"
FP32 = dict(rtol=1e-4, atol=1e-5)
DEEP = dict(rtol=1e-4, atol=5e-5)     # logits after the 8-layer period
PERIOD = dict(num_layers=8, attn_period=8, attn_offset=4)
LR, WARMUP = 1e-3, 2
JAMBA_PARAMS = 397_711_939_584         # the JAX init's leaves
ONE_CARD_PARAMS = 25_817_044_992       # one period, 8 of 16 experts


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _period(**kw):
    """(JAX config, port config) of the smoke widths at jamba's period,
    fp32."""
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32",
                                                    **PERIOD, **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _jax_init(jcfg, seed=0):
    """JAX's init as a numpy tree."""
    return jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(seed), jcfg))


def _weights(jcfg, seed=0):
    """JAX init with the norm weights and the SSM's zero or unit vectors
    perturbed in numpy: (JAX params, the port's params on the CPU)."""
    rng = np.random.default_rng(seed)
    tree = _jax_init(jcfg, seed)

    def perturb(node, key, base):
        node[key] = (base + 0.1 * rng.standard_normal(node[key].shape)
                     ).astype(node[key].dtype)
    for blk in tree["periods"].values():
        for key in ("ln1", "ln2"):
            perturb(blk, key, 1.0)
        if "ssm" in blk:
            for key, base in (("gnorm", 1.0), ("D", 1.0), ("conv_b", 0.0),
                              ("dt_bias", 0.0)):
                perturb(blk["ssm"], key, base)
    perturb(tree, "final_norm", 1.0)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")


def _batch(jcfg, B, S, seed=1):
    jb = jax_make_batch(jcfg, B, S, seed=seed)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _close(port, want, tol=FP32):
    np.testing.assert_allclose(port.float().numpy(), _np(want), **tol)


# ----------------------------------------------------------------------------
# config and size


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    got, want = get_config(ARCH, smoke), jax_get_config(ARCH, smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_counts() == want.param_counts()
    assert got.family == "hybrid" and got.causal and got.supports_decode
    assert ARCH in ARCHS and set(LATER) == set()
    if not smoke:
        kinds = [got.layer_kind(j) for j in range(8)]
        assert kinds == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
        assert [got.mlp_kind(j) for j in range(8)] == ["dense", "moe"] * 4
        assert (got.num_heads // got.num_kv_heads, got.resolved_head_dim,
                got.ssm_heads, got.ssm_head_dim, got.ssm_state,
                got.ssm_chunk) == (8, 128, 256, 64, 128, 256)


def test_full_size_on_meta_matches_jax_and_the_one_card_cut():
    """The full config on the meta device against `jax.eval_shape` of
    JAX's init, key for key (9 periods of 8 blocks); then the cut one
    card holds: one period, 8 of the 16 experts, every width as
    published."""
    cfg = get_config(ARCH)
    got = M.init(None, cfg, "meta")
    want = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0),
                                          jax_get_config(ARCH)))
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for key in w:
        assert tuple(g[key].shape) == tuple(w[key].shape), key
        assert str(g[key].dtype)[6:] == str(w[key].dtype), key
    assert M.param_count(got) == JAMBA_PARAMS
    assert g["periods/sub4/attn/wk"].shape == (9, 8192, 1024)
    assert g["periods/sub1/moe/we1"].shape == (9, 16, 8192, 24_576)
    assert g["periods/sub0/ssm/wx"].shape == (9, 8192, 16_384)
    cut = M.init(None, cfg.replace(num_layers=8, num_experts=8), "meta")
    assert M.param_count(cut) == ONE_CARD_PARAMS
    assert 2 * ONE_CARD_PARAMS / 2**30 < 48.1


# ----------------------------------------------------------------------------
# init


def _init_by_copy(seed, cfg):
    """`models.model.init` on the CPU with every depth stacked by copy, as
    it stacked one period too before one-period stacks became views."""
    gen = torch.Generator().manual_seed(seed)
    dtype = layers.torch_dtype(cfg.dtype)
    n_periods, plen, kinds, mlp_kinds = M.period_structure(cfg)
    periods = [{f"sub{j}": blocks.init_block(gen, cfg, kinds[j],
                                             mlp_kinds[j], dtype, "cpu")
                for j in range(plen)} for _ in range(n_periods)]
    stacked = M.map_params(lambda t: t.new_empty((n_periods,) + t.shape),
                           periods[0])
    for i, made in enumerate(periods):
        for dst, src in zip(M.leaves(stacked), M.leaves(made)):
            dst[i].copy_(src)
    p = {"periods": stacked,
         "final_norm": torch.ones((cfg.d_model,), dtype=dtype)}
    audio = cfg.family == "audio"
    if not audio:
        p["embed"] = layers.kaiming(gen, (cfg.vocab_size, cfg.d_model), dtype,
                                    fan_in=cfg.d_model)
    if not cfg.tie_embeddings or audio:
        p["lm_head"] = layers.kaiming(gen, (cfg.d_model, cfg.vocab_size),
                                      dtype)
    feat = {"audio": M.AUDIO_FEAT_DIM, "vision": M.VISION_EMB_DIM}.get(
        cfg.frontend)
    if feat is not None:
        p["frontend"] = {"proj": layers.kaiming(gen, (feat, cfg.d_model),
                                                dtype)}
    return p


def test_one_period_init_is_views_of_its_draws():
    """Each stacked leaf of a one-period init is `unsqueeze(0)` of a drawn
    tensor: a view sharing its storage, no second copy of the model."""
    _, cfg = _period()
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    n_periods = M.period_structure(cfg)[0]
    assert n_periods == 1
    seen = set()
    for t in M.leaves(params["periods"]):
        assert t._is_view() and t.shape[0] == 1
        assert tuple(t._base.shape) == tuple(t.shape[1:])
        assert t.untyped_storage().data_ptr() == \
            t._base.untyped_storage().data_ptr()
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
        seen.add(t.untyped_storage().data_ptr())
    assert len(seen) == len(list(M.leaves(params["periods"])))
    multi = M.init(torch.Generator().manual_seed(0),
                   cfg.replace(num_layers=16), "cpu")
    assert not any(t._is_view() for t in M.leaves(multi["periods"]))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_seeded_smoke_init_is_unchanged(arch):
    """Every registered arch's smoke init from a seed, value for value the
    stacking by copy (the same draws in the same order); jamba's smoke
    config is one period of 2 layers, its 8-layer period one of 8."""
    cfgs = [get_config(arch, smoke=True)]
    if arch == ARCH:
        cfgs.append(_period()[1])
    for cfg in cfgs:
        got = M.init(torch.Generator().manual_seed(3), cfg, "cpu")
        want = _init_by_copy(3, cfg)
        g, w = _flat(got), _flat(want)
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            assert torch.equal(g[key], w[key]), key


def test_lm_params_from_numpy_takes_the_hybrid_tree():
    tree = _jax_init(_period()[0])
    params = lm_params_from_numpy(tree, "cpu")
    assert set(params) == {"periods", "final_norm", "embed", "lm_head"}
    assert set(params["periods"]["sub0"]) == {"ln1", "ssm", "ln2", "mlp"}
    assert set(params["periods"]["sub1"]) == {"ln1", "ssm", "ln2", "moe"}
    assert set(params["periods"]["sub4"]) == {"ln1", "attn", "ln2", "mlp"}
    g, w = _flat(params), _flat(tree)
    assert set(g) == set(w)
    for key in w:
        np.testing.assert_array_equal(g[key].numpy(), w[key], err_msg=key)
    for bad in ({"ln1": 0, "ssm": 0, "mlp": 0},          # an MLP without ln2
                {"ln1": 0, "ssm": 0, "ln2": 0, "mlp": 0, "moe": 0},
                {"ln1": 0, "ssm": 0, "attn": 0, "ln2": 0, "mlp": 0},
                {"ln1": 0, "ln2": 0, "mlp": 0}):
        periods = dict(tree["periods"], sub1={
            k: tree["periods"]["sub1"].get(k, tree["periods"]["sub0"].get(
                k, tree["periods"]["sub4"].get(k))) for k in bad})
        with pytest.raises(ValueError, match="Mamba-2 blocks with 'ln2'"):
            lm_params_from_numpy(dict(tree, periods=periods), "cpu")
    with pytest.raises(ValueError, match="hybrid, whose periods hold"):
        lm_params_from_numpy(dict(tree, vision=np.zeros(2)), "cpu")


# ----------------------------------------------------------------------------
# model


@pytest.mark.parametrize("jax_impl", ["naive", "pallas"])
def test_forward_and_loss_match_jax(jax_impl):
    """The port's B4 (causal, 8 heads over 2) and B5 (4 chunks of 16) on
    their plain versions against JAX's plain route and its Pallas kernels
    in interpret mode, at jamba's 8-layer period."""
    jcfg, cfg = _period()
    jparams, params = _weights(jcfg)
    jb, b = _batch(jcfg, 2, 64)
    jc = jcfg.replace(attn_impl=jax_impl)
    want, jaux = jax.jit(lambda p, x: JM.forward(p, x, jc))(jparams, jb)
    fa.counts.reset()
    ssd.counts.reset()
    got, aux = M.forward(params, b, cfg)
    assert (fa.counts.launches, fa.counts.plain_calls) == (0, 1)
    assert (ssd.counts.launches, ssd.counts.plain_calls) == (0, 7)
    assert got.shape == (2, 64, cfg.vocab_size)
    _close(got, want, DEEP)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    want, jmet = jax.jit(lambda p, x: JM.loss_fn(p, x, jc))(jparams, jb)
    loss, met = M.loss_fn(params, b, cfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_prefill_and_greedy_decode_match_jax(window):
    """A 40-token prompt prefilled at context 48: the logits, every
    block's cache (the attention block's k/v ring, each Mamba-2 block's
    state and conv window) and `pos`; then three greedy decode steps:
    each step's logits and caches, and the tokens, equal.  With a window
    of 24 the prompt overflows the attention ring, so prefill rolls it
    and decode goes on writing it at pos % 24, beside the SSM state."""
    jcfg, cfg = _period(sliding_window=window)
    jparams, params = _weights(jcfg, seed=1)
    jb, b = _batch(jcfg, 2, 40, seed=3)
    want, jcache = jax.jit(lambda p, x: JM.prefill(p, x, jcfg, 48))(
        jparams, jb)
    fa.counts.reset()
    ssd.counts.reset()
    got, cache = make_prefill_fn(cfg)(params, b, 48)
    assert (fa.counts.plain_calls, ssd.counts.plain_calls) == (1, 0)
    _close(got, want, DEEP)

    def check_cache(pos):
        assert cache["pos"] == int(jcache["pos"]) == pos
        assert set(cache["blocks"]) == set(jcache["blocks"])
        for j, blk in cache["blocks"].items():
            names = ("k", "v") if j == "sub4" else ("state", "conv")
            assert set(blk) == set(names), j
            for name in names:
                want_c = jcache["blocks"][j][name]
                assert tuple(blk[name].shape) == want_c.shape, (j, name)
                _close(blk[name], want_c, DEEP)
    check_cache(40)
    W = cache["blocks"]["sub4"]["k"].shape[2]
    assert W == (window or 48)
    step = make_serve_step(cfg)
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    jtok, tok = jnp.argmax(want[:, -1:], -1), torch.argmax(got[:, -1:], -1)
    for t in range(3):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        want, jcache = jstep(jparams, jtok.astype(jnp.int32), jcache)
        got, cache = step(params, tok, cache)
        _close(got, want, DEEP)
        check_cache(41 + t)
        jtok, tok = jnp.argmax(want, -1), torch.argmax(got, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


# ----------------------------------------------------------------------------
# training


def test_trainer_step_matches_jax():
    """One step of the `Trainer` from a JAX-initialised fp32 state at
    jamba's 8-layer period and one batch: loss and every gradient leaf
    (the JAX step's gradient read back from its first Adam moment) at
    rtol 1e-4 / atol 1e-5.  Adam's first step moves a parameter by
    lr_t·ĝ/(|ĝ| + eps), ĝ the clipped gradient: where |ĝ| is near eps
    (1e-8) the step turns on gradient digits far below that tolerance.
    So each new parameter is held within 1e-6 of JAX's plus the gap that
    this formula puts between the two packages' own gradients (~0 where
    |ĝ| >> eps), and 99.9% of them within 1e-6."""
    jcfg, cfg = _period()
    jt = JT.TrainConfig(lr=LR, warmup=WARMUP, total_steps=10)
    tt = T.TrainConfig(**dataclasses.asdict(jt))
    jstate = JT.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                                  "cpu")
    jb, b = _batch(jcfg, 2, 40, seed=5)
    jstep, _ = JT.make_train_step(jcfg, jt, donate=False)
    jnew, jmet = jstep(jstate, jb)
    scale = min(1.0, jt.grad_clip / float(jmet["gnorm"]))
    jg = jax.tree.map(lambda m: m / (1 - 0.9) / scale, jnew["opt"]["mu"])

    trainer = T.Trainer(cfg, tt, device="cpu")
    trainer.state = T.train_state_from_params(params, tt)
    seen = []
    fa.counts.reset()
    ssd.counts.reset()
    tl, _, tg = T._compute_grads(params, b, cfg, tt)
    grads = _flat(tg)
    state = trainer.run(iter([b]), 1, log=lambda s: None,
                        on_step=lambda i, m: seen.append(m))
    # twice over: the forward and the remat recompute a layer, one VJP
    assert (fa.counts.plain_calls, fa.counts.backward_plain) == (4, 2)
    assert (ssd.counts.plain_calls, ssd.counts.backward_plain) == (28, 14)
    for loss in (float(tl), float(seen[0]["loss"])):
        np.testing.assert_allclose(loss, float(jmet["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(seen[0]["gnorm"]), float(jmet["gnorm"]),
                               rtol=1e-5)
    w = _flat(jg)
    assert set(grads) == set(w) and "periods/sub1/moe/router" in w
    for key in w:
        np.testing.assert_allclose(grads[key].numpy(), _np(w[key]),
                                   err_msg=key, **FP32)
    lr_t = LR / WARMUP

    def direction(grad, gnorm):           # Adam's first step over lr_t
        scaled = min(1.0, jt.grad_clip / float(gnorm)) * grad
        return scaled / (np.abs(scaled) + 1e-8)
    got, want = _flat(state["params"]), _flat(jnew["params"])
    assert set(got) == set(want)
    far = total = 0
    for key in want:
        a, ref = got[key].numpy(), _np(want[key])
        gap = lr_t * np.abs(direction(grads[key].numpy(), seen[0]["gnorm"])
                            - direction(_np(w[key]), jmet["gnorm"]))
        assert (np.abs(a - ref) <= 1e-6 + gap).all(), key
        far += int((np.abs(a - ref) > 1e-6).sum())
        total += ref.size
    assert far <= 1e-3 * total, (far, total)


# ----------------------------------------------------------------------------
# CLIs


def test_serve_llm_serves_the_hybrid_on_the_cpu(capsys):
    out = serve_llm.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "24",
                          "--new-tokens", "4", "--temperature", "0"])
    text = capsys.readouterr().out
    assert tuple(out.shape) == (2, 28)
    assert "jamba-smoke" in text and "tok/s incl. prefill" in text
    assert "0 kernel launches, 1 plain calls" in text
    assert "run_moe calls" in text


def test_train_cli_trains_the_hybrid_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "jamba-smoke" in out.stdout
    losses = [float(v) for v in re.findall(r"step +\d+ loss (\S+)",
                                           out.stdout)]
    assert len(losses) == 3 and np.isfinite(losses).all(), out.stdout
    # 1 Mamba-2 and 1 attention layer: forward and remat recompute a step
    assert ("SSD scan (B5): 0 kernel launches, 6 plain calls, 3 backward "
            "passes") in out.stdout
    assert ("flash attention (B4): 0 kernel launches, 6 plain calls, 3 "
            "backward passes") in out.stdout
