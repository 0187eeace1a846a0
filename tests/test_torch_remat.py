"""The remat policy "dots" of the port's `models.model.forward` against
the JAX package's, on the CPU.

JAX wraps each period in `jax.checkpoint(period_body, policy=
jax.checkpoint_policies.dots_with_no_batch_dims_saveable)` when
`cfg.remat_policy == "dots"`; the port runs each period under the
non-reentrant `torch.utils.checkpoint` with the selective-checkpoint
policy `models.model.keep_dots`.  The same numpy inputs from a seed go
through both packages, weights from JAX's `models.model.init` carried
across by `lm_params_from_numpy`, fp32 smoke configs, TF32 off (the CPU
has none), rtol 1e-4 / atol 1e-5; jamba's 8-layer period at atol 5e-5
(`DEEP`, as tests/test_torch_hybrid.py holds its logits):

  parity      one config of each family with a remat period, dense
              (tinyllama-1.1b), MoE (granite-moe-3b-a800m, the routing of
              the port's "full" run pinned to its "dots" run's), ssm
              (mamba2-130m), hybrid (jamba-1.5-large-398b at its period
              of 8) and audio (hubert-xlarge, non-causal): the loss and
              every gradient leaf under "dots" against `jax.value_and_grad`
              of JAX's `loss_fn` under "dots", and bitwise the port's own
              under "full" (the kept outputs are the values the recompute
              would make)
  what is kept  over one period: the products the port's recompute
              re-runs under "full" are, in number and shape, the
              `dot_general` outputs `jax.ad_checkpoint.
              print_saved_residuals` lists for JAX's checkpointed period;
              "dots" keeps those and re-runs none of them (the backward's
              `aten.mm`/`aten.addmm` are the backward's without remat);
              it also keeps the period's last product where only the
              residual add reads it (JAX's partial evaluation drops that
              one as dead; torch's recompute stops before it); the B4 and
              B5 wrappers run their forward again in the backward, once a
              layer, under both policies
  refusal     an unknown remat_policy raises ValueError

B4 and B5 under both policies on the card are held by
tests/test_torch_cuda.py and `chip_smoke.py` (phases 59-60).
"""
import collections
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy
from torch_threads import torch_one_thread  # noqa: F401

import jax
import jax.ad_checkpoint
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.data import make_batch as jax_make_batch
from repro.models import blocks as JB
from repro.models import model as JM

from repro_torch.checkpoint.store import lm_params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

FP32 = dict(rtol=1e-4, atol=1e-5)
DEEP = dict(rtol=1e-4, atol=5e-5)     # jamba's 8-layer period
JAMBA_PERIOD = dict(num_layers=8, attn_period=8, attn_offset=4)
CASES = {"tinyllama-1.1b": {}, "granite-moe-3b-a800m": {},
         "mamba2-130m": {}, "jamba-1.5-large-398b": JAMBA_PERIOD,
         "hubert-xlarge": {}}
# the period's last product whose output only the residual add reads
# (the dense MLP's w2, the SSM's out_proj): kept by "dots", never read
DEAD_LAST = {"tinyllama-1.1b": 1, "granite-moe-3b-a800m": 0,
             "mamba2-130m": 1, "jamba-1.5-large-398b": 0,
             "hubert-xlarge": 1}
B, S = 2, 32
MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(arch, **kw):
    jcfg = jax_get_config(arch, smoke=True).replace(
        dtype="float32", remat_policy="dots", **{**CASES[arch], **kw})
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _inputs(jcfg, seed=0):
    """JAX's init and batch, and the same on the port's side."""
    tree = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(seed), jcfg))
    jb = jax_make_batch(jcfg, B, S, seed=seed + 1)
    return (jax.tree.map(jnp.asarray, tree), jb,
            lm_params_from_numpy(tree, "cpu"),
            {k: torch.from_numpy(np.array(v)) for k, v in jb.items()})


def _grads(params, batch, cfg, tap=None):
    ps = M.map_params(lambda t: t.detach().requires_grad_(), params)
    loss, _ = M.loss_fn(ps, batch, cfg, tap)
    got = iter(torch.autograd.grad(loss, list(M.leaves(ps))))
    return float(loss.detach()), M.map_params(lambda _: next(got), ps)


@pytest.mark.parametrize("arch", list(CASES))
def test_dots_loss_and_gradients_match_jax_and_full(arch):
    jcfg, cfg = _configs(arch)
    jparams, jb, params, batch = _inputs(jcfg)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jb, jcfg)[0]))(jparams)
    seen = moe.Tap(record=True)
    loss, got = _grads(params, batch, cfg, seen)
    tol = DEEP if arch == "jamba-1.5-large-398b" else FP32
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat) == len(list(M.leaves(got)))
    for path, w in flat.items():
        t = got
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t.numpy(), _np(w), err_msg=str(path),
                                   **tol)
    pinned = moe.Tap(choices=[i for _, i in seen.routes])
    full_loss, full = _grads(params, batch, cfg.replace(remat_policy="full"),
                             pinned)
    assert full_loss == loss
    assert all(torch.equal(a, b)
               for a, b in zip(M.leaves(got), M.leaves(full)))


# ----------------------------------------------------------------------------
# what is kept over one period


def _rows_cols(shape):
    shape = tuple(shape)
    return (int(np.prod(shape[:-1])), shape[-1])


def _jax_kept(jcfg, jparams):
    """The non-argument residuals `print_saved_residuals` lists for JAX's
    checkpointed period under "dots", as (rows, cols); under this policy
    only a `dot_general` output is saveable."""
    _, plen, kinds, mlp_kinds = JM.period_structure(jcfg)
    pp = jax.tree.map(lambda v: v[0], jparams["periods"])
    positions = jnp.arange(S)

    def period_body(x, pp):
        aux = jnp.zeros((), jnp.float32)
        for j in range(plen):
            x, a = JB.run_block(pp[f"sub{j}"], x, jcfg, kinds[j],
                                mlp_kinds[j], positions)
            aux = aux + a
        return x, aux
    body = jax.checkpoint(
        period_body,
        policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    x = jax.random.normal(jax.random.PRNGKey(3), (B, S, jcfg.d_model))

    def f(x, pp):
        y, aux = body(x, pp)
        return jnp.sum(y) + aux
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax.ad_checkpoint.print_saved_residuals(f, x, pp)
    kept = []
    for line in out.getvalue().splitlines():
        m = re.match(r"\w+\[([\d,]*)\] (.*)", line)
        if m and "from the argument" not in m[2] \
                and "from a constant" not in m[2]:
            kept.append(_rows_cols(int(d) for d in m[1].split(",")))
    return sorted(kept)


class _Products(TorchDispatchMode):
    """The (rows, cols) of every aten.mm / aten.addmm dispatched."""

    def __init__(self):
        super().__init__()
        self.shapes = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in MM:
            self.shapes[tuple(out.shape)] += 1
        return out


def _port_run(params, batch, cfg, monkeypatch):
    """One forward and backward of `cfg`: (the outputs `keep_dots` kept,
    as a Counter of (rows, cols); the backward's products, likewise; the
    B4 and B5 wrappers' forward calls after the forward and after the
    backward)."""
    kept = collections.Counter()
    keep = M.keep_dots

    def spy(ctx, op, *args, **kwargs):
        policy = keep(ctx, op, *args, **kwargs)
        if policy == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2:]
            kept[(a.shape[0], b.shape[1])] += 1
        return policy
    monkeypatch.setattr(M, "keep_dots", spy)
    for c in (fa.counts, ssd.counts):
        c.reset()
    ps = M.map_params(lambda t: t.detach().requires_grad_(), params)
    loss, _ = M.loss_fn(ps, batch, cfg)
    after_forward = (fa.counts.plain_calls, ssd.counts.plain_calls)
    with _Products() as bwd:
        torch.autograd.grad(loss, list(M.leaves(ps)))
    monkeypatch.setattr(M, "keep_dots", keep)
    return kept, bwd.shapes, after_forward, (fa.counts.plain_calls,
                                              ssd.counts.plain_calls)


@pytest.mark.parametrize("arch", list(CASES))
def test_dots_keeps_the_products_jax_keeps(arch, monkeypatch):
    jcfg0, _ = _configs(arch)
    _, plen, kinds, _ = JM.period_structure(jcfg0)
    jcfg, cfg = _configs(arch, num_layers=plen)          # one period
    jparams, _, params, batch = _inputs(jcfg)
    want = _jax_kept(jcfg, jparams)
    runs = {name: _port_run(params, batch, c, monkeypatch) for name, c in (
        ("none", cfg.replace(remat=False)),
        ("full", cfg.replace(remat_policy="full")), ("dots", cfg))}
    rerun_full = runs["full"][1] - runs["none"][1]
    assert sorted(rerun_full.elements()) == want
    assert runs["dots"][1] == runs["none"][1]      # no product re-run
    kept = runs["dots"][0]
    assert not runs["full"][0] and not runs["none"][0]
    extra = kept - rerun_full
    assert kept - extra == rerun_full
    assert sum(extra.values()) == DEAD_LAST[arch]
    assert all(cols == cfg.d_model for _, cols in extra)
    n_attn = sum(k == "attn" for k in kinds)
    n_ssm = plen - n_attn
    assert runs["none"][2:] == ((n_attn, n_ssm), (n_attn, n_ssm))
    for name in ("full", "dots"):       # B4 and B5 recomputed once a layer
        assert runs[name][2:] == ((n_attn, n_ssm), (2 * n_attn, 2 * n_ssm))


def test_unknown_remat_policy_raises():
    jcfg, cfg = _configs("mamba2-130m", num_layers=1)
    _, _, params, batch = _inputs(jcfg)
    with pytest.raises(ValueError, match="remat_policy 'offload'"):
        M.loss_fn(params, batch, cfg.replace(remat_policy="offload"))
