"""The port's LM training path against the JAX package's, on the reduced
``qwen2.5-3b`` (2 layers, ``d_model`` 64) with the JAX package's
``LM.init`` weights carried across by ``params_from_jax``, and the same
numpy batches through both.

* ``LM.loss`` and its gradients, float32, remat on and off: the loss
  within 1e-5 relative, every gradient within ``rtol=1e-4, atol=1e-5``.
  In bf16 the serving tests' pattern (``tests/test_torch_lm.py``): both
  bf16 models against the JAX LM in float32 on the same weights.
* ``make_train_step``: three AdamW steps, ``microbatch`` 1 and 2, losses
  and parameters within 1e-4 after the third.
* Checkpoints in the JAX package's format: round trip, GC and ``latest``,
  bf16 blobs, and a JAX-written checkpoint read by the port.
* The launcher on ``--device cpu``: six steps straight equal three steps
  and three more after ``--resume``, bit for bit; no ``--device`` raises
  here (no card).
"""

import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.kernels import ops
from repro_torch.launch import train as launcher
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _cfgs(dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jconfigs.get_reduced(ARCH).replace(**kw),
            configs.get_reduced(ARCH).replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(dtype):
    jcfg, _ = _cfgs(dtype)
    return jax_build_model(jcfg).init(jax.random.PRNGKey(0))


def _port_model(cfg, params):
    lm = build_model(cfg, device="cpu", trainable=True)
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    return lm


def _batch(seed=0, b=2, s=16, vocab=384):
    return JCorpus(JDataConfig(vocab=vocab, seq_len=s, global_batch=b,
                               seed=seed)).batch(3)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_loss_and_grads(lm, batch):
    loss, metrics = lm.loss(_torch_batch(batch))
    names, params = zip(*lm.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), metrics, dict(zip(names, grads))


# ---------------------------------------------------------------- loss ----

@pytest.mark.parametrize("remat", (True, False))
def test_loss_and_grads_match_jax_float32(remat):
    jcfg, cfg = _cfgs(remat=remat)
    params = _jax_params("float32")
    batch = _batch()
    jm = jax_build_model(jcfg)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    lm = _port_model(cfg, params)
    ops.reset_counts()
    loss, metrics, grads = _port_loss_and_grads(lm, batch)
    # each layer's attention once in the forward, once more in its remat
    assert ops.PLAIN_CALLS["flash_attention"] == cfg.n_layers * (1 + remat)
    assert ops.BACKWARD_CALLS["flash_attention"] == cfg.n_layers
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("ce", "aux", "ppl_proxy"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == want[name].dtype, name
        np.testing.assert_allclose(_np(g), _np(want[name]), **GRAD_TOL,
                                   err_msg=name)


def test_remat_changes_no_gradient():
    """The same model with and without ``torch.utils.checkpoint`` per
    layer: the loss and every gradient bit for bit."""
    _, cfg = _cfgs()
    params = _jax_params("float32")
    batch = _batch(1)
    runs = [_port_loss_and_grads(_port_model(cfg.replace(remat=r), params),
                                 batch) for r in (True, False)]
    assert float(runs[0][0]) == float(runs[1][0])
    for name, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][name]), name


def test_serving_entry_points_take_no_gradient():
    _, cfg = _cfgs()
    lm = _port_model(cfg, _jax_params("float32"))
    toks = _torch_batch(_batch())["tokens"]
    assert not lm.forward({"tokens": toks}).requires_grad
    assert not lm.prefill({"tokens": toks})[0].requires_grad
    loss, _ = lm.loss(_torch_batch(_batch()))
    assert loss.requires_grad


@functools.lru_cache(maxsize=None)
def _bf16_readings(seed):
    """(port bf16, JAX bf16, JAX float32): loss and gradients by name on the
    bf16 weights (the float32 model on them upcast exactly)."""
    batch = {k: jnp.asarray(v) for k, v in _batch(seed).items()}
    out = []
    for dtype, params in (("bfloat16", _jax_params("bfloat16")),
                          ("float32", jax.tree.map(
                              lambda a: a.astype(jnp.float32),
                              _jax_params("bfloat16")))):
        jcfg, cfg = _cfgs(dtype)
        (loss, _), g = jax.value_and_grad(jax_build_model(jcfg).loss,
                                          has_aux=True)(params, batch)
        out.append((float(loss), {n: _np(t) for n, t in params_from_jax(
            jax.tree.map(np.asarray, g), cfg).items()}))
    _, cfg = _cfgs("bfloat16")
    loss, _, grads = _port_loss_and_grads(
        _port_model(cfg, _jax_params("bfloat16")), _batch(seed))
    port = (float(loss), {n: _np(g) for n, g in grads.items()})
    return port, out[0], out[1]


@pytest.mark.parametrize("seed", range(4))
def test_bf16_loss_and_grads_track_float32_jax(seed):
    """The bf16 port and the bf16 JAX LM against the JAX LM in float32 on
    the same weights: the loss within 5e-2 (the serving tests' tolerance),
    and the gradients, over all parameters together, within 1.25 times
    the JAX bf16 model's own mean abs error (0.81-1.18 times on this tree;
    the two frameworks round bf16 products and sums in different places,
    and the port's attention is the flash kernel's function).  Prints the
    readings (``pytest -s``)."""
    (loss, grads), (jloss, jgrads), (tloss, truth) = _bf16_readings(seed)
    np.testing.assert_allclose(loss, tloss, rtol=5e-2)
    err = {n: np.abs(grads[n] - truth[n]).mean() for n in truth}
    jerr = {n: np.abs(jgrads[n] - truth[n]).mean() for n in truth}
    port_mean, jax_mean = np.mean(list(err.values())), np.mean(
        list(jerr.values()))
    print(f"seed {seed}: loss port {loss:.5f}, JAX bf16 {jloss:.5f}, "
          f"float32 {tloss:.5f}; gradient mean abs error against float32: "
          f"port {port_mean:.3e}, JAX bf16 {jax_mean:.3e} "
          f"({port_mean / jax_mean:.3f}x)")
    assert port_mean <= 1.25 * jax_mean


# ---------------------------------------------------------- train step ----

def _jax_train(jcfg, opt_cfg, batches):
    jm = jax_build_model(jcfg)
    opt = jadamw.make_optimizer(opt_cfg)
    params = _jax_params("float32")
    state = {"params": params, "opt": opt.init(params)}
    fn = jax.jit(jstep.make_train_step(jm, opt))
    losses = []
    for b in batches:
        state, metrics = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return losses, state


@pytest.mark.parametrize("microbatch", (1, 2))
def test_train_step_matches_jax(microbatch):
    """Three AdamW steps (warmup, then the cosine) on batches of 4 x 16:
    the losses within 1e-4 relative, every parameter within 1e-4 after
    the third step, float32.  Adam's ``eps`` is 1e-6: at 1e-8, Adam turns
    a gradient of 1e-7 into a full step of its sign, and some of the key
    bias's gradients are that small (RoPE leaves those directions almost
    free of the loss), where the two frameworks agree only to about 1 %
    (``test_loss_and_grads_match_jax_float32``'s ``atol``)."""
    jcfg, cfg = _cfgs(microbatch=microbatch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3, eps=1e-6)
    batches = [JCorpus(JDataConfig(vocab=cfg.vocab, seq_len=16,
                                   global_batch=4, seed=2)).batch(i)
               for i in range(3)]
    jlosses, jstate = _jax_train(jcfg, jadamw.OptConfig(**kw), batches)
    lm = build_model(cfg, device="cpu", trainable=True)
    opt = adamw.make_optimizer(adamw.OptConfig(**kw))
    state = tstep.init_train_state(lm, opt, torch.Generator().manual_seed(0))
    lm.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, _jax_params("float32")), cfg))
    fn = tstep.make_train_step(lm, opt)
    losses = []
    for b in batches:
        state, metrics = fn(state, _torch_batch(b))
        losses.append(float(metrics["loss"]))
        assert set(metrics) >= {"loss", "ce", "aux", "ppl_proxy", "lr",
                                "grad_norm"}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg)
    assert state["params"]["embed"] is lm.embed
    for name, p in state["params"].items():
        np.testing.assert_allclose(_np(p), _np(want[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert int(state["opt"]["step"]) == 3


def test_microbatches_accumulate_in_float32():
    """bf16 weights, two microbatches: the optimizer gets the mean of the
    two float32 gradients, not a sum rounded to bf16 (``p.grad`` is never
    written)."""
    _, cfg = _cfgs("bfloat16", microbatch=2)
    lm = _port_model(cfg, _jax_params("bfloat16"))
    batch = _torch_batch(_batch(b=4))
    seen = {}

    class Spy:
        def update(self, params, grads, state):
            seen.update(grads)
            return params, state, {}

    fn = tstep.make_train_step(lm, Spy())
    _, metrics = fn({"params": dict(lm.named_parameters()), "opt": {}},
                    batch)
    halves = [_port_loss_and_grads(lm, {k: v[i:i + 2].numpy()
                                        for k, v in batch.items()})
              for i in (0, 2)]
    for name, g in seen.items():
        assert g.dtype == torch.float32, name
        want = (halves[0][2][name].float() + halves[1][2][name].float()) / 2
        assert torch.equal(g, want), name
    assert all(p.grad is None for p in lm.parameters())
    assert float(metrics["loss"]) == pytest.approx(
        (float(halves[0][0]) + float(halves[1][0])) / 2, rel=1e-6)
    assert float(metrics["ce"]) == float(halves[1][1]["ce"])


def test_train_state_needs_a_trainable_model():
    _, cfg = _cfgs()
    opt = adamw.make_optimizer(adamw.OptConfig())
    with pytest.raises(ValueError, match="trainable"):
        tstep.init_train_state(build_model(cfg, device="cpu"), opt,
                               torch.Generator().manual_seed(0))


def test_serve_steps_are_the_models():
    _, cfg = _cfgs()
    lm = _port_model(cfg, _jax_params("float32"))
    toks = _torch_batch(_batch())["tokens"]
    last, cache = tstep.make_prefill_step(lm)({"tokens": toks[:, :-1]},
                                              lm.init_cache(2, 16))
    logits, _ = tstep.make_decode_step(lm)(cache, {"token": toks[:, -1:],
                                                   "pos": 15})
    full = lm.forward({"tokens": toks})
    np.testing.assert_allclose(_np(logits), _np(full[:, -1]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(last), _np(full[:, -2]), rtol=1e-4,
                               atol=1e-4)
    batch = _torch_batch(_batch())
    assert float(tstep.make_loss_step(lm)(batch).detach()) == float(
        lm.loss(batch)[0].detach())
    # a mesh the model's weights are not sharded over (LM.shard_)
    with pytest.raises(ValueError, match="shard the model"):
        tstep.make_decode_step(lm, mesh=object())


# ---------------------------------------------------------- checkpoint ----

def _small_state():
    gen = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((8, 16), generator=gen),
                       "norm1": torch.ones(16),
                       "nested": {"embed": torch.randn(
                           (32, 8), generator=gen).bfloat16()}},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": [torch.zeros(3), torch.arange(4.0)]}}


def _leaves(tree):
    return [leaf for _, leaf in store._paths(tree)]


def test_checkpoint_roundtrip_with_bf16_blobs(tmp_path):
    state = _small_state()
    store.save_checkpoint(tmp_path, 7, state)
    assert store.latest_step(tmp_path) == 7
    d = tmp_path / "step_00000007"
    manifest = json.loads((d / "manifest.json").read_text())
    emb = manifest["arrays"]["['params']['nested']['embed']"]
    assert emb["bf16"] and emb["dtype"] == "bfloat16"
    with np.load(d / "host0.npz") as z:
        assert z[emb["blob"]].dtype == np.uint16
    back = store.restore_checkpoint(tmp_path, 7, state, device="cpu")
    for a, b in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back["opt"]["m"], list)
    with pytest.raises(KeyError, match="missing"):
        store.restore_checkpoint(tmp_path, 7, {"other": state["params"]},
                                 device="cpu")
    blob = bytearray((d / "host0.npz").read_bytes())
    at = blob.index(state["params"]["w"].numpy().tobytes())
    blob[at + 5] ^= 1                     # one bit of the stored weights
    (d / "host0.npz").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        store.restore_checkpoint(tmp_path, 7, state, device="cpu")


def test_checkpoint_gc_and_latest(tmp_path):
    state = _small_state()
    for s in (1, 2, 3, 4, 5):
        store.save_checkpoint(tmp_path, s, state, keep_last=2)
    assert store.latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000004", "step_00000005"]
    shutil.rmtree(tmp_path / "step_00000005")     # the pointer runs ahead
    assert store.latest_step(tmp_path) == 4
    assert store.latest_step(tmp_path / "none") is None


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The JAX package reads the port's checkpoint of the same structure,
    and the port reads the JAX package's, bf16 included."""
    state = _small_state()
    store.save_checkpoint(tmp_path / "port", 3, state)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        tuple(x.shape), jnp.bfloat16 if x.dtype == torch.bfloat16 else
        jnp.dtype(str(x.dtype).removeprefix("torch."))), state)
    back = jstore.restore_checkpoint(tmp_path / "port", 3, like)
    for a, b in zip(_leaves(state), jax.tree.leaves(back)):
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))
    jstore.save_checkpoint(tmp_path / "jax", 4, back)
    again = store.restore_checkpoint(tmp_path / "jax", 4, state,
                                     device="cpu")
    for a, b in zip(_leaves(state), _leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_jax_lm_checkpoint_gives_the_jax_logits(tmp_path):
    """LM parameters saved by the JAX package's ``save_checkpoint``, read
    by the port's store into their own structure and mapped through
    ``params_from_jax``: the port's logits equal the JAX LM's within the
    serving tests' float32 1e-4."""
    jcfg, cfg = _cfgs()
    params = _jax_params("float32")
    jstore.save_checkpoint(tmp_path, 1, params)
    back = store.restore_checkpoint(tmp_path, 1, jax.tree.map(np.asarray,
                                                              params),
                                    device="cpu")
    lm = build_model(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(back, cfg))
    toks = _batch()["tokens"]
    want = jax_build_model(jcfg).forward(params, {"tokens": jnp.asarray(
        toks)})[0]
    np.testing.assert_allclose(_np(lm.forward({"tokens": torch.from_numpy(
        toks)})), _np(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ launcher ----

def _argv(ckpt, steps, *extra):
    return ["--arch", ARCH, "--reduced", "--steps", str(steps), "--batch",
            "4", "--seq", "16", "--microbatch", "2", "--device", "cpu",
            "--ckpt-dir", str(ckpt), "--log-every", "1", *extra]


def test_launcher_resume_is_bit_for_bit(tmp_path):
    """Six steps straight (checkpoints at 3 and 6), then the run "killed"
    after step 3 (step 6's checkpoint removed) and re-run with
    ``--resume``: the last three losses and the final state equal the
    straight run's bit for bit."""
    ckpt = tmp_path / "ckpt"
    straight = launcher.train(launcher.parse_args(_argv(ckpt, 6,
                                                        "--ckpt-every", "3")))
    assert len(straight.losses) == 6 and all(np.isfinite(straight.losses))
    assert sum(straight.losses[-3:]) / 3 < straight.losses[0]
    (tmp_path / "straight").mkdir()
    shutil.move(ckpt / "step_00000006", tmp_path / "straight")
    assert store.latest_step(ckpt) == 3
    resumed = launcher.train(launcher.parse_args(_argv(
        ckpt, 6, "--ckpt-every", "3", "--resume")))
    assert resumed.losses == straight.losses[3:]
    saved = store.restore_checkpoint(tmp_path / "straight", 6,
                                     straight.state, device="cpu")
    for a, b, c in zip(_leaves(straight.state), _leaves(resumed.state),
                       _leaves(saved)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_launcher_run_returns_the_losses_and_refuses_what_is_not_ported():
    losses = launcher.run(_argv("", 2, "--optimizer", "adafactor",
                                "--compress"))
    assert len(losses) == 2 and all(np.isfinite(losses))
    # a model axis needs ranks to split over (tests/test_torch_train_mesh.py
    # runs it on 2 and 4)
    with pytest.raises(ValueError, match="group of ranks"):
        launcher.run(_argv("", 1, "--model-axis", "2"))
    # the stub frontends: Whisper's frames, Qwen2-VL's embeddings and
    # M-RoPE ids
    for arch in ("whisper-base", "qwen2-vl-72b"):
        losses = launcher.run(["--arch", arch, "--reduced", "--steps", "2",
                               "--batch", "4", "--seq", "16", "--device",
                               "cpu"])
        assert len(losses) == 2 and all(np.isfinite(losses)), arch


@pytest.mark.parametrize("arch", ("whisper-base", "qwen2-vl-72b"))
def test_stub_frontend_batches_and_microbatches(arch):
    """``make_model_batch``'s stub inputs have the reference's layout
    (``src/repro/launch/train.py:113-133``) and are the same every step;
    a step over 2 microbatches (M-RoPE's ``positions`` cut along their
    batch axis) gives the loss of one over the whole batch, float32."""
    cfg = configs.get_reduced(arch)
    host = launcher.SyntheticCorpus(launcher.DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)).batch(0)
    batch = launcher.make_model_batch(cfg, host, torch.device("cpu"))
    again = launcher.make_model_batch(cfg, host, torch.device("cpu"))
    want = ({"frames": ((4, cfg.enc_frames, cfg.d_model), torch.bfloat16),
             "tokens": ((4, 16), torch.int32)} if cfg.enc_dec else
            {"embeds": ((4, 16, cfg.d_model), torch.bfloat16),
             "positions": ((3, 4, 16), torch.int32)})
    want["labels"] = ((4, 16), torch.int32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == want
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    if "positions" in batch:
        assert torch.equal(batch["positions"][2, 3], torch.arange(16,
                                                         dtype=torch.int32))
    first = [launcher.run(["--arch", arch, "--reduced", "--steps", "1",
                           "--batch", "4", "--seq", "16", "--dtype",
                           "float32", "--device", "cpu", "--microbatch",
                           m])[0] for m in ("1", "2")]
    assert first[1] == pytest.approx(first[0], rel=1e-6)


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launcher.run(["--arch", ARCH, "--reduced", "--steps", "1"])


def test_train_example_runs_on_the_host(tmp_path):
    # one intra-op thread: the tiny model runs faster so even alone, and
    # a pool of spinning threads stalls when the other test processes
    # hold the cores
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_100m_torch.py"),
         "--tiny", "--device", "cpu", "--steps", "12", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert "loss decreased" in out.stdout
