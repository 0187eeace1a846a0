"""The JAX package's checkpoint store, read and written by the port.

`repro.checkpoint.store` keeps a training state as path-flattened numpy
arrays plus JSON metadata:

    <dir>/step_<n>/arrays.npz      keys like "gen/0/w", "gen/0/b", ...
    <dir>/step_<n>/meta.json       {"step", "keys", "dtypes", ["user"]}

bf16 leaves are stored as their uint16 bit pattern, with "bfloat16" in
`dtypes`; `read_step` widens them to fp32 by a 16-bit shift, which is
exact (no `ml_dtypes` needed).  Only numpy and json are used.

The writer (`save_checkpoint`, `latest_step`, `restore_latest`,
`restore_checkpoint` for one given step) keeps
that layout for the port's GAN training state, so the JAX package's
`restore_latest` reads a port checkpoint into its own state template,
and its solve service serves the generator in it.  The keys are the JAX
state's ("gen/0/w", "disc_opt/mu/2/b", "gen_opt/step", "sync/mailbox/0/w",
"sync/outer_mailbox", "epoch"; a conv generator's "gen/convs/0/w", ...,
"gen/proj/b", conv weights HWIO), with the same shapes.  The one leaf that
differs is "rng": the port stores its `torch.Generator`'s state there
(a uint8 vector; the JAX state holds its per-rank keys under that name),
so a resume continues the run bitwise.  `gan_state_from_numpy` carries
a JAX training state, as path-flattened numpy arrays, into the port.

The LLM trainer's state ({"params", "opt": {"mu", "nu", "step"},
"step"}, and "mailbox" under `sync_mode="rma_arar_grouped"`) crosses
the same way, both ways, with no conversion: its keys are the JAX
state's ("params/periods/sub0/attn/wq", "opt/mu/embed", "opt/step",
"step", "mailbox/final_norm", ...), bf16 parameters stored as their bits
with "bfloat16" in `dtypes`, fp32 moments and mailbox as fp32, the two
steps as int32 0-d arrays.  The JAX package's `restore_checkpoint` reads
`launch/train.py --ckpt-dir`'s checkpoint into
`repro.training.trainer.init_train_state`'s template, and
`restore_checkpoint` here reads a JAX trainer's into
`training.trainer.init_train_state`'s, each leaf bit for bit.

`lm_params_from_numpy` carries an LLM's parameter pytree (the JAX
`models.model.init` layout, as numpy arrays) into the port.

`load_generator_stack` restores the MLP generator only, as the JAX
service's checkpoint route does (it restores into an MLP template).  The
conv generator's path-flattened arrays ("proj/w", "convs/0/w", ...) cross
through `conv_generator_from_numpy` and are served with
`register_problem(gen_stack=...)`.
"""
from __future__ import annotations

import json
import os
import re
import warnings
import zipfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.gan import Generator
from ..core.tree import tree_from_paths, tree_paths, tree_unflatten
from ..models.convgen import ConvGenerator

_SEP = "/"

# what a process killed mid-save can leave behind: truncated or garbage
# zip members, a half-written meta.json, missing files.  A structural
# mismatch (no generator, wrong shapes) is not in this set and raises.
# `restore_latest` and the proc runtime's resume negotiation skip a step
# that raises one of these.
CORRUPT_ERRORS = (OSError, EOFError, zlib.error, zipfile.BadZipFile,
            json.JSONDecodeError)


def list_steps(directory: str) -> List[int]:
    """All `step_N` numbers under `directory`, ascending (empty if none)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def widen_bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> the same values as fp32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_step(directory: str, step: int) -> Dict[str, np.ndarray]:
    """All arrays of one step, bf16 leaves widened to fp32."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {}
        for key in data.files:
            raw = data[key]
            if meta["dtypes"].get(key) == "bfloat16":
                raw = widen_bf16(raw)
            arrays[key] = raw
    return arrays


def generator_from_numpy(flat: Dict[str, np.ndarray], device=None
                         ) -> Generator:
    """Path-flattened generator arrays {"0/w": [R, in, out], "0/b": [R,
    out], ...} -> the port's stacked generator, fp32 on `device`."""
    dev = resolve_device(device)
    n_layers = len({k.split(_SEP)[0] for k in flat})
    want = {f"{i}{_SEP}{leaf}" for i in range(n_layers) for leaf in "wb"}
    if set(flat) != want:
        raise ValueError(f"generator leaves must be {sorted(want)}, got "
                         f"{sorted(flat)}")
    layers = []
    for i in range(n_layers):
        w, b = (np.asarray(flat[f"{i}{_SEP}{leaf}"]) for leaf in "wb")
        if w.ndim != 3 or b.shape != (w.shape[0], w.shape[2]):
            raise ValueError(
                f"layer {i}: expected a stacked w [R, in, out] and b [R, "
                f"out], got {w.shape} and {b.shape}")
        if layers and layers[-1]["w"].shape[2] != w.shape[1]:
            raise ValueError(f"layer {i}: input width {w.shape[1]} does not "
                             f"match the previous output "
                             f"{layers[-1]['w'].shape[2]}")
        layers.append({"w": torch.from_numpy(w.astype(np.float32)).to(dev),
                       "b": torch.from_numpy(b.astype(np.float32)).to(dev)})
    return layers


def conv_generator_from_numpy(flat: Dict[str, np.ndarray], device=None
                              ) -> ConvGenerator:
    """Path-flattened conv generator arrays {"proj/w": [R, noise, h0·w0·c0],
    "proj/b", "convs/<i>/w": [R, 3, 3, cin, cout], "convs/<i>/b": [R,
    cout], ...} (the JAX `models.convgen` stack) -> the port's stacked conv
    generator, fp32 on `device`.  Raises ValueError on missing or extra
    keys and on shapes that do not chain into one generator."""
    dev = resolve_device(device)
    n_convs = len({k.split(_SEP)[1] for k in flat
                   if k.startswith(f"convs{_SEP}")})
    want = {f"proj{_SEP}w", f"proj{_SEP}b"} | {
        f"convs{_SEP}{i}{_SEP}{leaf}" for i in range(n_convs)
        for leaf in "wb"}
    if n_convs == 0 or set(flat) != want:
        raise ValueError(f"conv generator leaves must be {sorted(want)} "
                         f"with at least one conv, got {sorted(flat)}")
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    pw, pb = arrays[f"proj{_SEP}w"], arrays[f"proj{_SEP}b"]
    if pw.ndim != 3 or pb.shape != (pw.shape[0], pw.shape[2]):
        raise ValueError(f"proj: expected a stacked w [R, noise, out] and b "
                         f"[R, out], got {pw.shape} and {pb.shape}")
    R, width = pw.shape[0], None
    for i in range(n_convs):
        w, b = (arrays[f"convs{_SEP}{i}{_SEP}{leaf}"] for leaf in "wb")
        if w.ndim != 5 or w.shape[:3] != (R, 3, 3) \
                or b.shape != (R, w.shape[4]):
            raise ValueError(
                f"convs/{i}: expected a stacked HWIO w [{R}, 3, 3, cin, cout] "
                f"and b [{R}, cout], got {w.shape} and {b.shape}")
        if i == 0 and pw.shape[2] % w.shape[3]:
            raise ValueError(f"convs/0: {w.shape[3]} input channels do not "
                             f"divide the projection's {pw.shape[2]} outputs")
        if width is not None and w.shape[3] != width:
            raise ValueError(f"convs/{i}: {w.shape[3]} input channels, but "
                             f"the previous conv has {width} outputs")
        width = w.shape[4]
    out = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
           for k, v in arrays.items()}
    return {"proj": {leaf: out[f"proj{_SEP}{leaf}"] for leaf in "wb"},
            "convs": [{leaf: out[f"convs{_SEP}{i}{_SEP}{leaf}"]
                       for leaf in "wb"} for i in range(n_convs)]}


def _to_tensor(a, dtype, dev):
    """A numpy leaf (fp32, or bf16 as ml_dtypes) -> a tensor of `dtype`
    (None: the leaf's own) on `dev`."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes, read as its bits
        return torch.from_numpy(widen_bf16(a.view(np.uint16))).to(
            dev, dtype or torch.bfloat16)
    t = torch.from_numpy(np.array(a))     # a writable copy
    return t.to(dev, dtype or t.dtype)


def lm_params_from_numpy(tree, device=None, dtype=None) -> dict:
    """An LLM's parameters in the JAX `models.model.init` layout, as a
    nested dict of numpy arrays ({"periods": {"sub0": {"attn": {"wq":
    ...}}}, "final_norm", "embed", ["lm_head"]}, the blocks stacked with a
    leading n_periods axis; an audio encoder has "frontend": {"proj"} and
    "lm_head" in place of "embed", a VLM "frontend": {"proj"} beside
    "embed"; "proj" is [features, d_model]) -> the port's params on
    `device`, same keys.

    The blocks may be attention blocks ("attn", "ln1", "ln2", and "mlp"
    or a MoE's "moe": `router` [D, E], fp32 in a bf16 model; `we1`, `we3`
    [E, D, F], `we2` [E, F, D] and the shared experts' "shared" MLP),
    Mamba-2 blocks ("ssm", "ln1"), whose `A_log`, `D` and `dt_bias` are
    fp32 in a bf16 model, or, in a hybrid's period ("sub0" ..
    "sub{attn_period - 1}"), Mamba-2 blocks with "ln2" and "mlp" or
    "moe" beside its attention block.  `dtype` ("float32", "bfloat16" or
    a torch dtype) casts every leaf; None keeps each leaf's own (bf16
    stays bf16, fp32 stays fp32).  Raises ValueError on a tree that is not
    such a model, a block of other keys among them."""
    from ..models.layers import torch_dtype
    from ..models.model import leaves, map_params
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)
    keys = set(tree)
    audio = "frontend" in keys and "embed" not in keys
    inputs = {"frontend", "lm_head"} if audio else {"embed"}
    if not {"periods", "final_norm"} | inputs <= keys \
            or not isinstance(tree["periods"], dict):
        raise ValueError(f"not an LLM parameter tree: expected 'periods', "
                         f"'final_norm' and 'embed', or an audio encoder's "
                         f"'frontend' and 'lm_head', got {sorted(keys)}")
    extra = keys - {"periods", "final_norm", "lm_head", "embed", "frontend"}
    front = tree.get("frontend")
    if front is not None and not (
            isinstance(front, dict) and set(front) == {"proj"}
            and np.shape(front["proj"])[1:] == np.shape(tree["final_norm"])):
        extra.add("frontend")
    if extra:
        raise ValueError(f"unexpected leaves {sorted(extra)} (the port runs "
                         f"text decoders, the hybrid, whose periods hold "
                         f"Mamba-2 blocks with 'ln2' and 'mlp' or 'moe' "
                         f"beside an attention block, the audio encoder "
                         f"and the VLM, whose frontend is {{'proj': "
                         f"[features, d_model]}})")
    for name, blk in tree["periods"].items():
        got = set(blk) if isinstance(blk, dict) else set()
        mixer, mlp = got & {"attn", "ssm"}, got & {"mlp", "moe"}
        if len(mixer) != 1 or len(mlp) > 1 \
                or got != {"ln1"} | mixer | ({"ln2"} | mlp if mlp else set()):
            raise ValueError(
                f"periods/{name} holds {sorted(got)}: a block is 'ln1' and "
                f"one mixer, 'attn' or a Mamba-2 'ssm', then, where it has "
                f"an MLP, 'ln2' and 'mlp' or 'moe' (a hybrid's period holds "
                f"Mamba-2 blocks with 'ln2' and 'mlp' or 'moe' beside its "
                f"attention block)")
    depth = {np.shape(a)[0] for a in leaves(tree["periods"])}
    if len(depth) != 1:
        raise ValueError(f"the stacked blocks disagree on n_periods: "
                         f"{sorted(depth)}")
    return map_params(lambda a: _to_tensor(a, dt, dev), tree)


def load_generator_stack(directory: str, device=None
                         ) -> Tuple[Optional[Generator], Optional[int]]:
    """The newest loadable step's generator stack (the leaves under
    "gen/"), as `(stack, step)`, or `(None, None)` when the directory holds
    no loadable step.  A step that fails to read (a process killed
    mid-save) is skipped with a warning and the next-newest is tried, as
    `repro.checkpoint.store.restore_latest` does; a step without a
    generator, or with one of the wrong structure (a conv generator among
    them), raises."""
    for step in reversed(list_steps(directory)):
        try:
            arrays = read_step(directory, step)
        except CORRUPT_ERRORS as e:
            warnings.warn(f"checkpoint step_{step} in {directory} failed to "
                          f"load ({type(e).__name__}: {e}); falling back to "
                          "the previous step")
            continue
        prefix = f"gen{_SEP}"
        gen = {k[len(prefix):]: v for k, v in arrays.items()
               if k.startswith(prefix)}
        if not gen:
            raise KeyError(f"checkpoint step_{step} in {directory} holds no "
                           f"generator ('gen/...' keys)")
        if f"proj{_SEP}w" in gen:
            raise ValueError(
                f"checkpoint step_{step} in {directory} holds a conv "
                f"generator; the checkpoint route restores the MLP only, as "
                f"the JAX service's does: carry it with "
                f"conv_generator_from_numpy and register it with gen_stack=")
        return generator_from_numpy(gen, device), step
    return None, None


# ----------------------------------------------------------------------------
# the writer


def _to_numpy(t) -> Tuple[np.ndarray, str]:
    """(array as stored, dtype name): bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(directory: str, step: int, tree,
                    metadata: Optional[dict] = None) -> str:
    """Write `tree` (nested dicts and lists of tensors on any device: a
    GAN or an LLM training state) as `<directory>/step_<step:08d>/` in
    the JAX store's layout."""
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    stored, dtypes = {}, {}
    for key, leaf in tree_paths(tree):
        stored[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(path, "arrays.npz"), **stored)
    meta = {"step": step, "keys": sorted(stored), "dtypes": dtypes}
    if metadata:
        meta["user"] = metadata
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, like_tree):
    """Step `step` under `directory` into `like_tree`'s structure, each
    leaf with the like leaf's dtype and device (`like_tree`'s keys only:
    a step may hold more).  A missing key or a shape that differs from the
    like leaf's raises (the caller's tree no longer matches); a step a
    killed process left half-written raises one of `CORRUPT_ERRORS`."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        paths = list(tree_paths(like_tree))
        missing = sorted({k for k, _ in paths} - set(data.files))
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]} ...")
        for key, like in paths:
            raw = data[key]
            if meta["dtypes"].get(key) == "bfloat16":
                t = torch.from_numpy(raw.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(raw))
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{tuple(t.shape)}, the state "
                                 f"{tuple(like.shape)}")
            out.append(t.to(like.device, like.dtype))
    return tree_unflatten(like_tree, out)


def restore_latest(directory: str, like_tree):
    """The newest loadable `step_N` under `directory` restored into
    `like_tree`'s structure: `(tree, step)`, or `(None, None)` when there
    is none.  A step that fails to read (a process killed mid-save) is
    skipped with a warning and the next-newest tried; a structural
    mismatch raises."""
    for step in reversed(list_steps(directory)):
        try:
            return restore_checkpoint(directory, step, like_tree), step
        except CORRUPT_ERRORS as e:
            warnings.warn(f"checkpoint step_{step} in {directory} failed to "
                          f"load ({type(e).__name__}: {e}); falling back to "
                          "the previous step")
    return None, None


GAN_STATE_KEYS = ("gen", "disc", "gen_opt", "disc_opt", "sync", "epoch")


def gan_state_from_numpy(flat: Dict[str, np.ndarray], device=None) -> dict:
    """A JAX stacked training state (`repro.core.workflow.init_state` /
    `train_vmap`'s), as path-flattened numpy arrays ("gen/0/w", ...,
    "sync/outer_mailbox", "epoch"; "gen/convs/0/w", "gen/proj/b", ... for
    the conv generator of an imaging problem, conv weights HWIO), -> the
    port's state on `device`, with the same leaves and dtypes.  The JAX
    state's "rng" (its per-rank keys) has no counterpart in the port and
    is dropped; any other unknown top-level key raises."""
    dev = resolve_device(device)
    tops = {k.split(_SEP)[0] for k in flat} - {"rng"}
    if tops != set(GAN_STATE_KEYS):
        raise ValueError(f"a GAN training state has the top-level keys "
                         f"{sorted(GAN_STATE_KEYS)} (and 'rng'), got "
                         f"{sorted(tops)}")
    tree = tree_from_paths({k: v for k, v in flat.items()
                            if k.split(_SEP)[0] != "rng"})
    if not isinstance(tree["disc"], list):
        raise ValueError(f"'disc' must be an MLP (a list of layers); got "
                         f"keys {sorted(tree['disc'])}")
    gen = tree["gen"]
    if not isinstance(gen, list) and set(gen) != {"proj", "convs"}:
        raise ValueError(f"'gen' must be an MLP (a list of layers) or a "
                         f"conv generator ('proj', 'convs'); got keys "
                         f"{sorted(gen)}")
    from ..models.model import map_params
    return map_params(lambda a: _to_tensor(a, None, dev), tree)
