"""The port's vlm family (internvl2-1b) against the JAX package, on the
CPU.

The same numpy inputs from a seed go through `repro` and `repro_torch`;
weights are JAX's `models.model.init` pytree (qkv biases and norm
weights perturbed in numpy so that every parameter counts) carried
across by `lm_params_from_numpy`, fp32 rtol 1e-4 / atol 1e-5 unless
stated:

  config, data    `get_config("internvl2-1b")` and its smoke config field
                  for field; `make_batch`/`TokenStream` bitwise (tokens,
                  patches in fp32 and bf16; where seq // 2 binds and where
                  num_vision_tokens does); the init's leaves against
                  JAX's, the full size on the meta device
  model           forward logits and `loss_fn` (JAX at attn_impl "naive"
                  and at "pallas" in interpret mode, the port on B4's
                  plain version, causal at GQA group 2 in the smoke
                  config); the loss read at the text positions only, the
                  last patch's logits trained on the first text token;
                  prefill logits, k/v cache and `pos` of an
                  image-plus-prompt batch, then three decode steps and
                  their greedy tokens; a full-width depth-2 forward (14
                  heads over 2: G 7, head dim 64)
  training        one `Trainer` step: loss, every gradient leaf (the tied
                  `embed` and `frontend/proj` among them), the new
                  parameters (within 1e-6 plus the gap Adam's first
                  step puts between the two packages' gradients where
                  they lie near its eps)
  CLIs            `serve_llm --arch internvl2-1b` exits: its prompts are
                  text only; `launch.train --arch internvl2-1b --smoke`
                  trains

B4's CUDA kernel at internvl2's shapes (G 7) is held on the card by
tests/test_torch_cuda.py and `chip_smoke.py` (phases 11 and 53-55).
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
from repro.data import TokenStream as JaxTokenStream
from repro.data import make_batch as jax_make_batch
from repro.models import model as JM
from repro.training import trainer as JT

from repro_torch.checkpoint.store import lm_params_from_numpy
from repro_torch.configs import LATER, get_config
from repro_torch.data import TokenStream, make_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve_llm
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving import make_prefill_fn, make_serve_step
from repro_torch.training import trainer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internvl2-1b"
FP32 = dict(rtol=1e-4, atol=1e-5)
LR, WARMUP = 1e-3, 2
INTERNVL2_PARAMS = 494_698_496      # the JAX init's leaves


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _smoke(**kw):
    """(JAX config, port config) of internvl2's smoke config in fp32."""
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32", **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, seed=0):
    """JAX init with the qkv biases and norm weights perturbed in numpy:
    (JAX params, the port's params on the CPU)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(seed), jcfg))
    sub = tree["periods"]["sub0"]
    for key in ("bq", "bk", "bv"):
        sub["attn"][key] = (0.1 * rng.standard_normal(
            sub["attn"][key].shape)).astype(sub["attn"][key].dtype)
    for node, key in ((sub, "ln1"), (sub, "ln2"), (tree, "final_norm")):
        node[key] = (1 + 0.1 * rng.standard_normal(node[key].shape)
                     ).astype(node[key].dtype)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")


def _batch(jcfg, B, S, seed=1):
    """One image-plus-prompt batch of JAX's `make_batch` (S positions:
    the patches and the text), in both packages."""
    jb = jax_make_batch(jcfg, B, S, seed=seed)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _close(port, want, tol=FP32):
    np.testing.assert_allclose(port.float().numpy(), _np(want), **tol)


# ----------------------------------------------------------------------------
# config and data


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    got, want = get_config(ARCH, smoke), jax_get_config(ARCH, smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_counts() == want.param_counts()
    assert got.family == "vlm" and got.frontend == "vision"
    assert got.causal and got.supports_decode and got.tie_embeddings
    if not smoke:
        assert (got.num_heads // got.num_kv_heads,
                got.resolved_head_dim) == (7, 64)
    assert set(LATER) == set()


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,n_vis", [(9, 4), (40, 8)],
                         ids=["seq-halves-bind", "num-vision-tokens-bind"])
def test_make_batch_and_token_stream_are_bitwise_jax(dtype, seq, n_vis):
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype=dtype)
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
    got = make_batch(cfg, 3, seq, seed=5, device="cpu")
    want = jax_make_batch(jcfg, 3, seq, seed=5)
    assert set(got) == set(want) == {"tokens", "vision"}
    assert got["tokens"].shape == (3, seq - n_vis)
    assert got["tokens"].dtype == torch.int32
    assert got["vision"].shape == (3, n_vis, M.VISION_EMB_DIM)
    assert str(got["vision"].dtype)[6:] == dtype
    for key in want:
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))
    ours = TokenStream(cfg, 2, seq, seed=3, shard_index=1, num_shards=2,
                       device="cpu")
    theirs = JaxTokenStream(jcfg, 2, seq, seed=3, shard_index=1,
                            num_shards=2)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for key in b:
            np.testing.assert_array_equal(_bits(a[key]), _bits(b[key]))


def test_init_leaves_match_jax_and_full_size_on_meta():
    """The smoke init's keys, shapes and dtypes against JAX's; the full
    config on the meta device against `jax.eval_shape` of its init:
    494,698,496 parameters (24 layers of 14,912,384, `embed` [151655,
    896], the patch projection [1024, 896] and the final norm; tied, so
    no head)."""
    for smoke in (True, False):
        cfg = get_config(ARCH, smoke)
        if smoke:
            got = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
            want = JM.init(jax.random.PRNGKey(0), jax_get_config(ARCH, smoke))
        else:
            got = M.init(None, cfg, "meta")
            want = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0),
                                                  jax_get_config(ARCH)))
        g, w = _flat(got), _flat(want)
        assert set(g) == set(w)
        assert "lm_head" not in got and set(got["frontend"]) == {"proj"}
        for key in w:
            assert tuple(g[key].shape) == tuple(w[key].shape), key
            assert str(g[key].dtype)[6:] == str(w[key].dtype), key
    assert M.param_count(got) == INTERNVL2_PARAMS
    assert tuple(got["frontend"]["proj"].shape) == (M.VISION_EMB_DIM, 896)
    assert tuple(got["embed"].shape) == (151_655, 896)


def test_lm_params_from_numpy_takes_the_vlm_tree():
    jcfg, _ = _smoke()
    tree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jcfg))
    params = lm_params_from_numpy(tree, "cpu")
    assert set(params) == {"periods", "final_norm", "embed", "frontend"}
    np.testing.assert_array_equal(params["frontend"]["proj"].numpy(),
                                  tree["frontend"]["proj"])
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])
    untied = dict(tree, lm_head=tree["embed"].T.copy())
    assert "lm_head" in lm_params_from_numpy(untied, "cpu")
    neither = {k: v for k, v in tree.items() if k not in ("embed",
                                                          "frontend")}
    with pytest.raises(ValueError, match="not an LLM"):
        lm_params_from_numpy(neither, "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_numpy(dict(tree, vision=np.zeros(2)), "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_numpy(dict(tree, frontend=dict(
            tree["frontend"], extra=np.zeros(2))), "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_numpy(dict(tree, frontend=tree["frontend"]["proj"]),
                             "cpu")


# ----------------------------------------------------------------------------
# model


@pytest.mark.parametrize("jax_impl", ["naive", "pallas"])
def test_forward_and_loss_match_jax(jax_impl):
    """The port's B4 (plain on the CPU, causal) against JAX's plain
    attention and its Pallas kernel in interpret mode; 8 patches and 56
    text tokens a row."""
    jcfg, cfg = _smoke()
    jparams, params = _weights(jcfg)
    jb, b = _batch(jcfg, 2, 64)
    assert b["vision"].shape == (2, 8, M.VISION_EMB_DIM)
    jc = jcfg.replace(attn_impl=jax_impl)
    want, jaux = JM.forward(jparams, jb, jc)
    fa.counts.reset()
    got, aux = M.forward(params, b, cfg)
    assert (fa.counts.launches, fa.counts.plain_calls) == (0, cfg.num_layers)
    assert got.shape == (2, 64, cfg.vocab_size)
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0
    want, jmet = JM.loss_fn(jparams, jb, jc)
    loss, met = M.loss_fn(params, b, cfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]),
                               rtol=1e-6)


def test_loss_reads_the_text_positions_only():
    """After the causal shift the loss is the mean NLL of each text token
    given the positions before it: the last patch's logits are trained on
    the first text token, and no patch position is a label.  The labels
    are 0 over the patches, the mask 0 there and 1 over the text."""
    jcfg, cfg = _smoke()
    jparams, params = _weights(jcfg)
    jb, b = _batch(jcfg, 2, 40, seed=2)
    n_vis = b["vision"].shape[1]
    x, labels, mask = M.embed_inputs(params, b, cfg)
    jx, jlabels, jmask = JM.embed_inputs(jparams, jb, jcfg)
    _close(x, jx)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert labels.dtype == torch.int32 and mask.dtype == torch.float32
    assert not labels[:, :n_vis].any() and not mask[:, :n_vis].any()
    assert bool(mask[:, n_vis:].eq(1).all())
    logits, _ = M.forward(params, b, cfg)
    logp = torch.log_softmax(logits[:, n_vis - 1:-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, b["tokens"].long()[..., None])
    loss, _ = M.loss_fn(params, b, cfg)
    torch.testing.assert_close(loss, nll.mean(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("context", [None, 72])
def test_prefill_and_greedy_decode_match_jax(context):
    """An image-plus-prompt batch (8 patches, 56 tokens) prefilled: the
    logits, k/v cache and `pos` 64; then three greedy decode steps on text
    tokens from that position (context 72: a cold cache; None: the cache
    holds the prompt only, so decode wraps its ring): each step's logits
    and cache, and the tokens, equal."""
    jcfg, cfg = _smoke()
    jparams, params = _weights(jcfg)
    jb, b = _batch(jcfg, 2, 64, seed=3)
    want, jcache = JM.prefill(jparams, jb, jcfg, context)
    fa.counts.reset()
    got, cache = make_prefill_fn(cfg)(params, b, context)
    assert fa.counts.plain_calls == cfg.num_layers
    _close(got, want)
    assert cache["pos"] == int(jcache["pos"]) == 64
    for name in ("k", "v"):
        assert tuple(cache["blocks"]["sub0"][name].shape) == \
            jcache["blocks"]["sub0"][name].shape
        _close(cache["blocks"]["sub0"][name], jcache["blocks"]["sub0"][name])
    last, _ = make_prefill_fn(cfg)(params, b, context, last_logits_only=True)
    torch.testing.assert_close(last, got[:, -1:])
    step = make_serve_step(cfg)
    jtok, tok = jnp.argmax(want[:, -1:], -1), torch.argmax(got[:, -1:], -1)
    for t in range(3):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        want, jcache = JM.decode_step(jparams, jtok.astype(jnp.int32), jcache,
                                      jcfg)
        got, cache = step(params, tok, cache)
        _close(got, want)
        assert cache["pos"] == int(jcache["pos"]) == 65 + t
        for name in ("k", "v"):
            _close(cache["blocks"]["sub0"][name],
                   jcache["blocks"]["sub0"][name])
        jtok, tok = jnp.argmax(want, -1), torch.argmax(got, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_full_width_depth_2_forward_matches_jax():
    """internvl2-1b's widths (d_model 896, 14 heads over 2 KV heads: GQA
    group 7, head dim 64; d_ff 4864) at depth 2, its vocab cut to 257,
    batch 1, 16 patches and 16 tokens."""
    jcfg = jax_get_config(ARCH).replace(num_layers=2, vocab_size=257,
                                        dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim) == \
        (7, 64)
    jparams, params = _weights(jcfg)
    jb, b = _batch(jcfg, 1, 32, seed=4)
    assert b["vision"].shape == (1, 16, M.VISION_EMB_DIM)
    want, _ = JM.forward(jparams, jb, jcfg)
    got, _ = M.forward(params, b, cfg)
    _close(got, want)


# ----------------------------------------------------------------------------
# training


def test_trainer_step_matches_jax():
    """One step of the `Trainer` from a JAX-initialised fp32 state and one
    image-plus-prompt batch: loss and every gradient leaf (the JAX step's
    gradient read back from its first Adam moment) at rtol 1e-4 / atol
    1e-5.  Adam's first step moves a parameter by lr_t·ĝ/(|ĝ| + eps), ĝ
    the clipped gradient: where |ĝ| is near eps (1e-8) the step turns on
    gradient digits far below that tolerance (a wk entry here: ĝ -3.8e-9
    in one package, 1.4e-10 in the other).  So each new parameter is held
    within 1e-6 of JAX's plus the gap that this formula puts between the
    two packages' own gradients (~0 where |ĝ| >> eps), and 99.9% of them
    within 1e-6."""
    jcfg, cfg = _smoke()
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
    tl, _, tg = T._compute_grads(params, b, cfg, tt)
    np.testing.assert_allclose(float(tl), float(jmet["loss"]), rtol=1e-6)
    g, w = _flat(tg), _flat(jg)
    assert set(g) == set(w) and {"embed", "frontend/proj"} <= set(w)
    assert "lm_head" not in w
    for key in w:
        np.testing.assert_allclose(g[key].numpy(), _np(w[key]), err_msg=key,
                                   **FP32)

    trainer = T.Trainer(cfg, tt, device="cpu")
    trainer.state = T.train_state_from_params(params, tt)
    seen = []
    fa.counts.reset()
    state = trainer.run(iter([b]), 1, log=lambda s: None,
                        on_step=lambda i, m: seen.append(m))
    # forward and remat recompute a layer, and one VJP a layer
    assert (fa.counts.plain_calls, fa.counts.backward_plain) == \
        (2 * cfg.num_layers, cfg.num_layers)
    np.testing.assert_allclose(float(seen[0]["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(seen[0]["gnorm"]), float(jmet["gnorm"]),
                               rtol=1e-5)
    lr_t = LR / WARMUP

    def direction(grad, gnorm):           # Adam's first step over lr_t
        scaled = min(1.0, jt.grad_clip / float(gnorm)) * grad
        return scaled / (np.abs(scaled) + 1e-8)
    got, want = _flat(state["params"]), _flat(jnew["params"])
    assert set(got) == set(want)
    far = total = 0
    for key in want:
        a, ref = got[key].numpy(), _np(want[key])
        gap = lr_t * np.abs(direction(g[key].numpy(), seen[0]["gnorm"])
                            - direction(_np(w[key]), jmet["gnorm"]))
        assert (np.abs(a - ref) <= 1e-6 + gap).all(), key
        far += int((np.abs(a - ref) > 1e-6).sum())
        total += ref.size
    assert far <= 1e-3 * total, (far, total)


# ----------------------------------------------------------------------------
# CLIs


def test_serve_llm_exits_text_only():
    with pytest.raises(SystemExit, match="prompts are text only"):
        serve_llm.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_train_cli_trains_internvl2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "internvl2-smoke" in out.stdout
    losses = [float(v) for v in re.findall(r"step +\d+ loss (\S+)",
                                           out.stdout)]
    assert len(losses) == 3 and np.isfinite(losses).all(), out.stdout
    assert ("flash attention (B4): 0 kernel launches, 12 plain calls, 6 "
            "backward passes") in out.stdout
