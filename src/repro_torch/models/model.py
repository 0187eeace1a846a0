"""Unified LM: embed, the layer stack, final norm, LM head; the training
loss; prefill and one-token decode for serving.  Counterpart of
`repro.models.model` for the text-only decoders of the dense, moe,
ssm and hybrid families (jamba-1.5-large-398b: periods of 8 blocks, one
attention and seven Mamba-2 mixers, each with a dense or a MoE MLP), the
encoder-only audio family (hubert-xlarge) and the vlm family
(internvl2-1b).

Batch formats, as in the JAX package:
    text  {"tokens": [B, S] int32}
    audio {"features": [B, S, AUDIO_FEAT_DIM], "labels": [B, S] int32}
    vlm   {"tokens": [B, S_text] int32,
           "vision": [B, N_VIS, VISION_EMB_DIM]}

The vlm batch's patch embeddings are projected and put before the token
embeddings, so its sequence is N_VIS + S_text long: the loss is masked
to the text positions, `prefill` takes the whole sequence and returns
`pos` = N_VIS + S_text, and `decode_step` continues on text tokens.

Parameters keep the JAX package's layout, so checkpoint and parameter
keys map one to one: `params["periods"]["sub{j}"]` holds the blocks,
stacked with a leading `n_periods` axis (one period of one layer for a
homogeneous stack, of attn_period layers for the hybrid), beside
"final_norm", "embed" and, untied, "lm_head"; the audio family has
"frontend": {"proj": [AUDIO_FEAT_DIM, D]} and "lm_head" in place of
"embed"; the vlm family has "frontend": {"proj": [VISION_EMB_DIM, D]}
beside "embed" (tied: no "lm_head").  Where JAX
scans over that axis, the port loops over it in Python.

The decode cache is {"pos": int, "blocks": {"sub{j}": ...}} with
attention's k/v [n_periods, B, W, KV, hd] or the SSM's state
[n_periods, B, H, P, N] (fp32) and conv window [n_periods, B, K − 1, ch];
`pos` is a Python int (positions already processed), so the loop needs
no device read.  `decode_step` writes the
cache in place and returns it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts,
                                     noop_context_fn)

from .. import resolve_device
from . import blocks, layers, ssm as ssm_lib
from .config import ModelConfig


def period_structure(cfg: ModelConfig):
    plen = cfg.attn_period if cfg.family == "hybrid" else 1
    if cfg.num_layers % plen:
        raise ValueError(f"{cfg.num_layers} layers are not whole periods of "
                         f"{plen}")
    kinds = tuple(cfg.layer_kind(j) for j in range(plen))
    mlp_kinds = tuple(cfg.mlp_kind(j) for j in range(plen))
    return cfg.num_layers // plen, plen, kinds, mlp_kinds


AUDIO_FEAT_DIM = 512     # stubbed conv-feature-extractor output (w2v2/HuBERT)
VISION_EMB_DIM = 1024    # stubbed InternViT patch-embedding output


def map_params(fn, tree):
    """The same structure of nested dicts and lists with `fn` applied to
    every leaf."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


def leaves(tree):
    """Every leaf of nested dicts and lists, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def period_params(params, i: int):
    """The blocks of period i: views into the stacked params."""
    return map_params(lambda t: t[i], params["periods"])


# ----------------------------------------------------------------------------
# init


def init(gen, cfg: ModelConfig, device=None):
    """Random parameters in the JAX layout (Kaiming-normal matrices, unit
    norms, zero biases) in `cfg.dtype`, drawn from the torch.Generator
    `gen` on its own device and placed on `device` (CUDA by default, see
    `resolve_device`; a generator on that device draws in place).  On
    device="meta" the shapes are made and nothing is drawn.

    The stacked leaves are allocated once and filled period by period, in
    the order the periods are drawn, so the peak holds one period beside
    the model (qwen2-moe-a2.7b's 28 GB in bf16 would double if the
    periods were made apart and then stacked).  A stack of one period (a
    hybrid of attn_period layers, 48 GiB for one period of
    jamba-1.5-large-398b at 8 experts in bf16) is `unsqueeze(0)` views of
    the drawn tensors, with no copy, so it is held once; the draws and
    their order are the same either way."""
    dtype = layers.torch_dtype(cfg.dtype)
    device = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    n_periods, plen, kinds, mlp_kinds = period_structure(cfg)

    def period():
        return {f"sub{j}": blocks.init_block(gen, cfg, kinds[j], mlp_kinds[j],
                                             dtype, device)
                for j in range(plen)}
    first = period()
    if n_periods == 1:           # views of the one drawn period: no copy
        stacked = map_params(lambda t: t.unsqueeze(0), first)
    else:
        stacked = map_params(lambda t: t.new_empty((n_periods,) + t.shape),
                             first)
        for i in range(n_periods):
            made = first if i == 0 else period()
            for dst, src in zip(leaves(stacked), leaves(made)):
                dst[i].copy_(src)
            del made
    del first
    p = {"periods": stacked}
    p["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    audio = cfg.family == "audio"
    if not audio:
        p["embed"] = layers.kaiming(gen, (cfg.vocab_size, cfg.d_model), dtype,
                                    fan_in=cfg.d_model, device=device)
    if not cfg.tie_embeddings or audio:
        p["lm_head"] = layers.kaiming(gen, (cfg.d_model, cfg.vocab_size),
                                      dtype, device=device)
    feat = {"audio": AUDIO_FEAT_DIM, "vision": VISION_EMB_DIM}.get(
        cfg.frontend)
    if feat is not None:
        p["frontend"] = {"proj": layers.kaiming(
            gen, (feat, cfg.d_model), dtype, device=device)}
    return p


def param_count(params) -> int:
    return sum(t.numel() for t in leaves(params))


# ----------------------------------------------------------------------------
# embedding


def embed_inputs(params, batch, cfg: ModelConfig):
    """Text batch {"tokens": [B, S]}, audio batch {"features": [B, S,
    AUDIO_FEAT_DIM], "labels": [B, S]} or vlm batch {"tokens": [B,
    S_text], "vision": [B, N_VIS, VISION_EMB_DIM]} -> (x [B,S,D], labels,
    loss_mask fp32).  The vlm batch's S is N_VIS + S_text: the projected
    patches, then the token embeddings; its labels are 0 over the patches
    and its mask 0 there, so only text positions are trained."""
    if cfg.family == "audio":
        labels = batch["labels"]
        x = torch.matmul(batch["features"], params["frontend"]["proj"])
        return x, labels, torch.ones(labels.shape, dtype=torch.float32,
                                     device=labels.device)
    if cfg.family == "vlm":
        tok = batch["tokens"]
        vis = torch.matmul(batch["vision"].to(params["embed"].dtype),
                           params["frontend"]["proj"])
        x = torch.cat([vis, params["embed"][tok]], dim=1)
        pad = tok.new_zeros(vis.shape[:2])
        labels = torch.cat([pad, tok], dim=1).to(torch.int32)
        mask = torch.cat([pad, torch.ones_like(tok)], dim=1).float()
        return x, labels, mask
    tok = batch["tokens"]
    x = params["embed"][tok]
    return x, tok, torch.ones(tok.shape, dtype=torch.float32,
                              device=tok.device)


def unembed(params, x, cfg: ModelConfig):
    if "lm_head" in params:
        return torch.matmul(x, params["lm_head"])
    return torch.matmul(x, params["embed"].t())


# ----------------------------------------------------------------------------
# forward


REMAT_POLICIES = ("full", "dots")

# the products without batch dimensions that a period reaches
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def keep_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of remat_policy "dots", JAX's
    `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`: keep the
    output of every product without batch dimensions that autograd
    records (`aten.mm`, `aten.addmm`: the projections, the dense MLPs,
    the router), and recompute the rest, such as the batched `aten.bmm`
    of the experts and of the plain attention.  Autograd records nothing
    inside a `torch.autograd.Function`'s forward, so the kernel wrappers
    (B4, B5) are recomputed whole, their plain versions' products
    included, as JAX recomputes a `pallas_call`."""
    if op in _DOTS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(keep_dots)


def forward(params, batch, cfg: ModelConfig, tap=None):
    """Returns (logits [B,S,V], aux_loss scalar).  `tap`: a
    `models.moe.Tap` every MoE layer reports to.

    With `cfg.remat` and autograd on, each period runs under the
    non-reentrant `torch.utils.checkpoint`, as the JAX package wraps each
    period in `jax.checkpoint`.  `cfg.remat_policy` "full" keeps nothing
    inside a period for the backward, which recomputes it whole; "dots"
    keeps the output of every matmul without batch dimensions
    (`keep_dots`) and recomputes the rest.  Another policy raises
    ValueError."""
    n_periods, plen, kinds, mlp_kinds = period_structure(cfg)
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: "
                         f"expected one of {REMAT_POLICIES}")
    x, _, _ = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def period(x, aux, pp):
        for j in range(plen):
            x, a = blocks.run_block(pp[f"sub{j}"], x, cfg, kinds[j],
                                    mlp_kinds[j], positions, tap)
            aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    contexts = _dots_contexts if cfg.remat_policy == "dots" \
        else noop_context_fn
    for i in range(n_periods):
        pp = period_params(params, i)
        if remat:
            x, aux = checkpoint(period, x, aux, pp, use_reentrant=False,
                                context_fn=contexts)
        else:
            x, aux = period(x, aux, pp)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig, tap=None):
    """Scalar training loss (CE + router aux).  Returns (loss, metrics):
    the next-token cross entropy when `cfg.causal`, from an fp32
    log-softmax, as a masked mean, plus router_aux_coef · aux."""
    logits, aux = forward(params, batch, cfg, tap)
    _, labels, mask = embed_inputs(params, batch, cfg)
    if cfg.causal:
        logits, labels, mask = logits[:, :-1], labels[:, 1:], mask[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------------------
# serving: prefill + decode


def decode_window(cfg: ModelConfig, context_len: int) -> int:
    return min(context_len, cfg.sliding_window or context_len)


def init_cache(cfg: ModelConfig, batch: int, context_len: int, device=None):
    """Zero cache for `context_len` tokens (a ring of sliding_window slots
    when that is smaller); `pos` counts tokens already processed."""
    dtype = layers.torch_dtype(cfg.dtype)
    n_periods, plen, kinds, _ = period_structure(cfg)
    W = decode_window(cfg, context_len)
    return {"pos": 0, "blocks": {
        f"sub{j}": map_params(
            lambda t: t.expand((n_periods,) + t.shape).clone(),
            blocks.init_block_cache(batch, cfg, kinds[j], W, dtype, device))
        for j in range(plen)}}


def decode_step(params, tokens, cache, cfg: ModelConfig, tap=None):
    """One decode step. tokens [B,1] (text-only decode).

    Returns (logits [B,1,V], cache), the cache updated in place with
    pos + 1.  Raises ValueError for an encoder-only config."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only (supports_decode is "
                         f"False): it has no decode step")
    n_periods, plen, kinds, mlp_kinds = period_structure(cfg)
    x = params["embed"][tokens]
    pos = cache["pos"]
    for i in range(n_periods):
        pp = period_params(params, i)
        for j in range(plen):
            c = {k: t[i] for k, t in cache["blocks"][f"sub{j}"].items()}
            x, _ = blocks.run_block_decode(pp[f"sub{j}"], x, c, pos, cfg,
                                           kinds[j], mlp_kinds[j], tap)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return unembed(params, x, cfg), cache


def prefill(params, batch, cfg: ModelConfig, context_len: Optional[int] = None,
            last_logits_only: bool = False, tap=None):
    """Run the full prompt (a text, an audio or a vlm batch: the vlm's
    patches and then its tokens, at positions 0 .. N_VIS + S_text − 1),
    building the decode cache.

    Returns (logits [B,S,V], or [B,1,V] with last_logits_only, the serving
    path that never makes the full-sequence logits; and the cache).  The
    last min(W, S) keys and values go to ring slots pos % W: a cold cache
    (S < W) is padded, a full one rolled by S % W."""
    n_periods, plen, kinds, mlp_kinds = period_structure(cfg)
    x, _, _ = embed_inputs(params, batch, cfg)
    B, S, _ = x.shape
    W = decode_window(cfg, context_len or S)
    cache = init_cache(cfg, B, context_len or S, device=x.device)
    positions = torch.arange(S, device=x.device)
    take = min(W, S)
    for i in range(n_periods):
        pp = period_params(params, i)
        for j in range(plen):
            blocks.check_kinds(kinds[j], mlp_kinds[j])
            p_blk = pp[f"sub{j}"]
            c_blk = cache["blocks"][f"sub{j}"]
            h = layers.rms_norm(x, p_blk["ln1"], cfg.norm_eps)
            if kinds[j] == "ssm":
                h, c = ssm_lib.ssm_prefill(p_blk["ssm"], h, cfg)
                for name, t in c.items():
                    c_blk[name][i].copy_(t)
            else:
                h, k, v = layers.run_attention_with_kv(p_blk["attn"], h, cfg,
                                                       positions)
                for name, t in (("k", k), ("v", v)):
                    ring = c_blk[name][i]
                    if take < W:     # cold cache: slots S..W-1 stay empty
                        ring[:, :take] = t[:, -take:]
                    else:            # rotate so that slot = pos % W
                        ring.copy_(torch.roll(t[:, -take:], S % W, dims=1))
            x = x + h
            x, _ = blocks.mlp_sublayer(p_blk, x, cfg, mlp_kinds[j], tap)
    if last_logits_only:
        x = x[:, -1:]
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["pos"] = S
    return unembed(params, x, cfg), cache
