"""The LLM trainer's checkpoint, port against the JAX package, both ways,
on the CPU.

The port's `checkpoint.store.save_checkpoint` writes the LLM train state
({"params", "opt": {"mu", "nu", "step"}, "step"}, and "mailbox" under
`rma_arar_grouped`) in the JAX store's layout, and its
`restore_checkpoint` reads one the JAX package wrote:

  the CLI       `python -m repro_torch.launch.train --ckpt-dir D` (the
                mamba2-130m smoke config, bf16) prints where it wrote and
                writes one `step_00000002`; the JAX package's
                `restore_checkpoint` reads it into `repro.training.
                trainer.init_train_state`'s template with the template's
                dtypes and shapes, every leaf bit for bit the port's final
                state (bf16 as its bits)
  JAX -> port   a JAX `save_checkpoint` of a JAX train state after one
                step (granite-moe-3b-a800m's smoke config under
                `rma_arar_grouped`, so a mailbox is in it; bf16 and fp32)
                restores into the port's template bit for bit
  one more step from a restored fp32 state, one way and the other: the
                loss, the gradient norm, the new moments at rtol 1e-4 /
                atol 1e-5, the steps exactly, and the new parameters at
                atol lr / 4 (where |g| is near Adam's eps the fp32
                rounding of g moves an entry by up to lr), 99.9% of them
                within 1e-6
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

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.data import make_batch as jax_make_batch
from repro.training import trainer as JT

from repro_torch.checkpoint.store import restore_checkpoint, save_checkpoint
from repro_torch.launch import train as train_cli
from repro_torch.models.config import ModelConfig
from repro_torch.training import trainer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = dict(rtol=1e-4, atol=1e-5)
LR, WARMUP = 1e-3, 2
CLI = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--steps",
       "2", "--batch", "2", "--seq", "24"]


def _bits(x):
    """A leaf of either package as numpy: bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat_jax(tree):
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_bitwise(port_tree, jax_tree):
    p, j = _flat_port(port_tree), _flat_jax(jax_tree)
    assert set(p) == set(j)
    for key in j:
        a, b = _bits(p[key]), _bits(j[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_cli_checkpoint_restores_into_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI,
         "--ckpt-dir", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"checkpoint written to {tmp_path}" in out.stdout
    assert os.listdir(tmp_path) == ["step_00000002"]
    state = train_cli.main(CLI)            # the same run, in this process
    jcfg = jax_get_config("mamba2-130m", smoke=True)
    template = JT.init_train_state(jax.random.PRNGKey(0), jcfg,
                                   JT.TrainConfig())
    restored = jax_restore(str(tmp_path), 2, template)
    for key, leaf in _flat_jax(template).items():
        got = _flat_jax(restored)[key]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, key
    assert int(restored["step"]) == int(restored["opt"]["step"]) == 2
    _assert_bitwise(state, restored)


def _jax_state(dtype):
    """A JAX granite smoke state under rma_arar_grouped, its first batch,
    its step function and the state after that step."""
    jcfg = jax_get_config("granite-moe-3b-a800m", smoke=True).replace(
        dtype=dtype)
    jt = JT.TrainConfig(lr=LR, warmup=WARMUP, total_steps=10,
                        sync_mode="rma_arar_grouped")
    state = JT.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    step, _ = JT.make_train_step(jcfg, jt, donate=False)
    batch = jax_make_batch(jcfg, 2, 24, seed=1)
    return jcfg, jt, (state, batch), step, step(state, batch)[0]


def _port_template(jcfg, jt):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tt = T.TrainConfig(**dataclasses.asdict(jt))
    return cfg, tt, T.init_train_state(torch.Generator(), cfg, tt, "cpu")


def _tokens(batch):
    return {"tokens": torch.from_numpy(np.array(batch["tokens"]))}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_checkpoint_restores_into_the_port(dtype, tmp_path):
    jcfg, jt, _, _, jstate = _jax_state(dtype)
    assert "mailbox" in jstate and int(jstate["step"]) == 1
    jax_save(str(tmp_path), 1, jstate)
    _, _, like = _port_template(jcfg, jt)
    _assert_bitwise(restore_checkpoint(str(tmp_path), 1, like), jstate)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_step_from_a_restored_state_agrees(writer, tmp_path):
    """`writer` takes the first step and writes the checkpoint, the other
    package restores it, and both take the second step from it on one
    batch."""
    jcfg, jt, (jstate, first), jstep, jstate1 = _jax_state("float32")
    cfg, tt, like = _port_template(jcfg, jt)
    pstep, _ = T.make_train_step(cfg, tt, donate=False)
    if writer == "jax":
        jax_save(str(tmp_path), 1, jstate1)
        state = restore_checkpoint(str(tmp_path), 1, like)
    else:                # the port steps from JAX's initial state
        jax_save(str(tmp_path / "init"), 0, jstate)
        state, _ = pstep(restore_checkpoint(str(tmp_path / "init"), 0, like),
                         _tokens(first))
        save_checkpoint(str(tmp_path), 1, state)
        jstate1 = jax_restore(str(tmp_path), 1, jstate1)
    _assert_bitwise(state, jstate1)
    batch = jax_make_batch(jcfg, 2, 24, seed=7)
    jnew, jmet = jstep(jstate1, batch)
    new, met = pstep(state, _tokens(batch))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["gnorm"]), float(jmet["gnorm"]),
                               rtol=1e-5)
    got, want = _flat_port(new), _flat_jax(jnew)
    assert set(got) == set(want)
    far = total = 0
    for key, w in want.items():
        g, w = got[key].numpy(), np.asarray(w)
        if key.startswith("params/"):
            np.testing.assert_allclose(g, w, rtol=0, atol=LR / 4,
                                       err_msg=key)
            far += int((np.abs(g - w) > 1e-6).sum())
            total += w.size
        elif g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, err_msg=key, **FP32)
    assert int(new["step"]) == int(new["opt"]["step"]) == 2
    assert far <= 1e-3 * total
