"""The port's audio family (hubert-xlarge) against the JAX package, on
the CPU.

The same numpy inputs from a seed go through `repro` and `repro_torch`;
weights are JAX's `models.model.init` pytree (norm weights perturbed in
numpy so that every parameter counts) carried across by
`lm_params_from_numpy`, fp32 rtol 1e-4 / atol 1e-5 unless stated:

  config, data    `get_config("hubert-xlarge")` and its smoke config
                  field for field; `make_batch`/`TokenStream` bitwise
                  (features in fp32 and bf16, labels); the init's leaves
                  against JAX's, the full size on the meta device; the
                  hybrid still raises
  model           forward logits (JAX at attn_impl "naive" and at
                  "pallas" in interpret mode, the port on B4's plain
                  version, non-causal), the non-causal loss, prefill
                  logits and k/v cache, a full-width depth-2 forward (head
                  dim 80); `decode_step` raises on the encoder
  training        one `Trainer` step: loss, every gradient leaf, the new
                  parameters (at atol lr_t / 4, as tests/test_torch_train.py
                  holds the decoders)
  CLIs            `serve_llm --arch hubert-xlarge` exits "encoder-only";
                  `launch.train --arch hubert-xlarge --smoke` trains

B4's CUDA kernel at hubert's shapes is held on the card by
tests/test_torch_cuda.py and `chip_smoke.py` (phases 50-52).
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
from repro_torch.training import trainer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "hubert-xlarge"
FP32 = dict(rtol=1e-4, atol=1e-5)
LR, WARMUP = 1e-3, 2


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
    """(JAX config, port config) of hubert's smoke config in fp32."""
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32", **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, seed=0):
    """JAX init with the norm weights perturbed in numpy: (JAX params,
    the port's params on the CPU)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(seed), jcfg))
    sub = tree["periods"]["sub0"]
    for node, key in ((sub, "ln1"), (sub, "ln2"), (tree, "final_norm")):
        node[key] = (1 + 0.1 * rng.standard_normal(node[key].shape)
                     ).astype(node[key].dtype)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")


def _batch(jcfg, B, S, seed=1):
    """One audio batch of JAX's `make_batch`, in both packages."""
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
    assert not got.causal and not got.supports_decode
    assert set(LATER) == set()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_batch_and_token_stream_are_bitwise_jax(dtype):
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype=dtype)
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype)

    def bits(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()

    def jbits(a):
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a

    got = make_batch(cfg, 3, 17, seed=5, device="cpu")
    want = jax_make_batch(jcfg, 3, 17, seed=5)
    assert set(got) == set(want) == {"features", "labels"}
    assert got["features"].shape == (3, 17, M.AUDIO_FEAT_DIM)
    assert str(got["features"].dtype)[6:] == dtype
    assert got["labels"].dtype == torch.int32
    for key in want:
        np.testing.assert_array_equal(bits(got[key]), jbits(want[key]))
    ours = TokenStream(cfg, 2, 9, seed=3, shard_index=1, num_shards=2,
                       device="cpu")
    theirs = JaxTokenStream(jcfg, 2, 9, seed=3, shard_index=1, num_shards=2)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for key in b:
            np.testing.assert_array_equal(bits(a[key]), jbits(b[key]))


def test_vlm_still_raises():
    """The archs this test pinned as not ported, the VLM and then the
    hybrid jamba-1.5-large-398b, are ported (tests/test_torch_vlm.py,
    tests/test_torch_hybrid.py): the hybrid's config resolves, and it is
    JAX's field for field."""
    for smoke in (False, True):
        got = get_config("jamba-1.5-large-398b", smoke)
        want = jax_get_config("jamba-1.5-large-398b", smoke)
        assert got.family == "hybrid"
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_init_leaves_match_jax_and_full_size_on_meta():
    """The smoke init's keys, shapes and dtypes against JAX's; the full
    config on the meta device against `jax.eval_shape` of its init:
    1,259,715,840 parameters (48 layers of 26,216,960, the frame
    projection [512, 1280], the head [1280, 504] and the final norm)."""
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
        assert "embed" not in got and set(got["frontend"]) == {"proj"}
        for key in w:
            assert tuple(g[key].shape) == tuple(w[key].shape), key
            assert str(g[key].dtype)[6:] == str(w[key].dtype), key
    assert M.param_count(got) == 1_259_715_840
    assert tuple(got["frontend"]["proj"].shape) == (M.AUDIO_FEAT_DIM, 1280)


def test_lm_params_from_numpy_takes_the_audio_tree_only():
    jcfg, _ = _smoke()
    tree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jcfg))
    params = lm_params_from_numpy(tree, "cpu")
    np.testing.assert_array_equal(params["frontend"]["proj"].numpy(),
                                  tree["frontend"]["proj"])
    no_input = {k: v for k, v in tree.items() if k != "frontend"}
    with pytest.raises(ValueError, match="not an LLM"):
        lm_params_from_numpy(no_input, "cpu")
    with pytest.raises(ValueError, match="not an LLM"):
        lm_params_from_numpy({k: v for k, v in tree.items()
                              if k != "lm_head"}, "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_numpy(dict(tree, vision=np.zeros(2)), "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_numpy(dict(tree, frontend=dict(
            tree["frontend"], extra=np.zeros(2))), "cpu")


# ----------------------------------------------------------------------------
# model


@pytest.mark.parametrize("jax_impl", ["naive", "pallas"])
def test_forward_matches_jax(jax_impl):
    """The port's B4 (plain on the CPU, non-causal) against JAX's plain
    attention and its Pallas kernel in interpret mode."""
    jcfg, cfg = _smoke()
    jparams, params = _weights(jcfg)
    jb, b = _batch(jcfg, 2, 64)
    want, jaux = JM.forward(jparams, jb, jcfg.replace(attn_impl=jax_impl))
    fa.counts.reset()
    got, aux = M.forward(params, b, cfg)
    assert (fa.counts.launches, fa.counts.plain_calls) == (0, cfg.num_layers)
    assert got.shape == (2, 64, cfg.vocab_size)
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0


def test_non_causal_loss_matches_jax():
    """Every frame is labelled: the loss is the mean over all of them,
    with no shift, and a frame's logits see the frames after it."""
    jcfg, cfg = _smoke()
    jparams, params = _weights(jcfg)
    jb, b = _batch(jcfg, 2, 48, seed=2)
    want, jmet = JM.loss_fn(jparams, jb, jcfg)
    got, met = M.loss_fn(params, b, cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=1e-6)
    later = dict(b, features=b["features"].clone())
    later["features"][:, -1] += 1.0
    logits, _ = M.forward(params, b, cfg)
    moved, _ = M.forward(params, later, cfg)
    assert not torch.allclose(logits[:, 0], moved[:, 0])


@pytest.mark.parametrize("context", [None, 72])
def test_prefill_matches_jax(context):
    """Logits and the k/v cache of an audio batch (S 64; a cold cache of
    72 slots)."""
    jcfg, cfg = _smoke()
    jparams, params = _weights(jcfg)
    jb, b = _batch(jcfg, 2, 64, seed=3)
    want, jcache = JM.prefill(jparams, jb, jcfg, context)
    got, cache = M.prefill(params, b, cfg, context)
    _close(got, want)
    assert cache["pos"] == int(jcache["pos"]) == 64
    for name in ("k", "v"):
        assert tuple(cache["blocks"]["sub0"][name].shape) == \
            jcache["blocks"]["sub0"][name].shape
        _close(cache["blocks"]["sub0"][name], jcache["blocks"]["sub0"][name])
    last, _ = M.prefill(params, b, cfg, context, last_logits_only=True)
    torch.testing.assert_close(last, got[:, -1:])


def test_full_width_depth_2_forward_matches_jax():
    """hubert-xlarge's widths (d_model 1280, 16 heads of 80, d_ff 5120,
    vocab 504) at depth 2, batch 1, 32 frames."""
    jcfg = jax_get_config(ARCH).replace(num_layers=2, dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert cfg.resolved_head_dim == 80
    jparams, params = _weights(jcfg)
    jb, b = _batch(jcfg, 1, 32, seed=4)
    want, _ = JM.forward(jparams, jb, jcfg)
    got, _ = M.forward(params, b, cfg)
    _close(got, want)


def test_decode_step_raises_on_the_encoder():
    _, cfg = _smoke()
    params = M.init(torch.Generator().manual_seed(0), cfg, "cpu")
    _, cache = M.prefill(params, make_batch(cfg, 1, 8, device="cpu"), cfg)
    with pytest.raises(ValueError, match="supports_decode"):
        M.decode_step(params, torch.zeros((1, 1), dtype=torch.long), cache,
                      cfg)


# ----------------------------------------------------------------------------
# training


def test_trainer_step_matches_jax():
    """One step of the `Trainer` from a JAX-initialised fp32 state and one
    audio batch: loss and every gradient leaf (the JAX step's gradient
    read back from its first Adam moment) at rtol 1e-4 / atol 1e-5, the
    new parameters at atol lr_t / 4 and 99.9% of them within 1e-6."""
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
    assert set(g) == set(w) and "frontend/proj" in w
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
    got, want = _flat(state["params"]), _flat(jnew["params"])
    assert set(got) == set(want)
    far = total = 0
    for key in want:
        a, ref = got[key].numpy(), _np(want[key])
        np.testing.assert_allclose(a, ref, rtol=0, atol=lr_t / 4,
                                   err_msg=key)
        far += int((np.abs(a - ref) > 1e-6).sum())
        total += ref.size
    assert far <= 1e-3 * total, (far, total)


# ----------------------------------------------------------------------------
# CLIs


def test_serve_llm_exits_encoder_only():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_llm.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_train_cli_trains_hubert_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    losses = [float(v) for v in re.findall(r"step +\d+ loss (\S+)",
                                           out.stdout)]
    assert len(losses) == 3 and np.isfinite(losses).all(), out.stdout
    assert ("flash attention (B4): 0 kernel launches, 12 plain calls, 6 "
            "backward passes") in out.stdout
