"""The port's encdec family (whisper: repro_torch.models.whisper, the encdec
branches of launch/steps.py and launch/train.py, ``layers.gelu_mlp``)
against the reference package's, on the CPU.

Weights are the reference's ``whisper.init_params`` carried over bit for
bit with ``whisper_from_jax``; frames, tokens and activations come from
numpy.  Tolerances:

- float32 blocks and models: atol 1e-4 on outputs, logits and caches (the
  sinusoids 1e-5, of magnitude 1);
- float32 loss: rtol 1e-5; gradients every leaf within 1e-4 x its largest
  |g| of ``jax.grad``'s; a train step's moments within 1e-4 of their
  largest magnitude, its parameters within 1 % of one step's size (lr)
  where the gradient is resolved at that tolerance, else within 2 lr;
- ``gelu_mlp``'s tanh GELU within 1e-5, where torch's default erf form is
  ~7e-4 off.
"""
import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeSpec as RShapeSpec  # noqa: E402
from repro.configs import get_reduced as rget_reduced  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import layers as rl  # noqa: E402
from repro.models import whisper as rw  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import whisper as tw  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import to_numpy, whisper_from_jax  # noqa: E402
from repro_torch.optim import OptConfig, adamw  # noqa: E402

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
ARCH = "whisper-base"
B, S, STEPS = 2, 5, 3


def _port_cfg(rcfg):
    return ModelConfig(**dataclasses.asdict(rcfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0,
                               err_msg=what)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def _specs(tree) -> dict:
    """A reference ShapeDtypeStruct tree as {path: (shape, "torch.<dtype>")}."""
    return {k: (v.shape, f"torch.{v.dtype.name}") for k, v in _flat(tree).items()}


@pytest.fixture(scope="module")
def wh():
    """The float32 reduced config, the reference's weights as numpy, the
    port's model holding them, frames, prompt tokens and the reference's
    encoder states."""
    rcfg = rget_reduced(ARCH).replace(**F32)
    cfg = _port_cfg(rcfg)
    params = jax.tree.map(np.asarray, rw.init_params(rcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    enc = np.asarray(jax.jit(functools.partial(rw.encode, cfg=rcfg))(params, frames))
    return rcfg, cfg, params, whisper_from_jax(cfg, params, device="cpu"), \
        frames, tokens, enc


# ---------------------------------------------------------------------------
# layers and pieces
# ---------------------------------------------------------------------------

def test_gelu_mlp_is_the_tanh_form():
    """The reference's jax.nn.gelu is the tanh approximation: the port
    within 1e-5, where the erf form (torch's default) is not within 1e-4."""
    rng = np.random.default_rng(0)
    d, ff = 64, 128
    p = {"w_up": (2 * rng.normal(size=(d, ff)) / np.sqrt(d)).astype(np.float32),
         "w_down": (rng.normal(size=(ff, d)) / np.sqrt(ff)).astype(np.float32)}
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    want = np.asarray(rl.gelu_mlp(p, x))
    tp = tlm.tree_map(_t, p)
    _close(tl.gelu_mlp(tp, _t(x)), want, 1e-5)
    erf = torch.nn.functional.gelu(_t(x) @ tp["w_up"]) @ tp["w_down"]
    assert float(np.abs(erf.numpy() - want).max()) > 1e-4


@pytest.mark.parametrize("offset", [0, 1, 7, 447])
def test_sinusoid_matches_reference(offset):
    """Interleaved sin (even columns) and cos (odd), positions from
    ``offset``: row 0 at offset k is row k at offset 0."""
    got = tw._sinusoid(9, 64, offset=offset)
    _close(got, rw._sinusoid(9, 64, offset=offset), 1e-5)
    _close(tw._sinusoid(1, 64)[0], np.tile([0.0, 1.0], 32), 0.0)   # sin 0, cos 0
    _close(tw._sinusoid(1, 64, offset=offset)[0], tw._sinusoid(offset + 1, 64)[-1], 1e-5)


def test_param_shapes_and_counts_are_the_references():
    from repro.configs import get_config as rget_config
    for rcfg in (rget_reduced(ARCH), rget_config(ARCH)):
        cfg = _port_cfg(rcfg)
        assert _flat(tw.param_shapes(cfg)) == _flat(rw.param_shapes(rcfg))
    full = _flat(tw.param_shapes(get_config(ARCH)))
    assert sum(int(np.prod(s)) for s in full.values()) == 70_873_600


def test_specs_are_the_references():
    rcfg = rget_reduced(ARCH)
    cfg = _port_cfg(rcfg)
    for kind in ("train", "prefill", "decode"):
        got = tsteps.input_specs(cfg, ShapeSpec("t", kind, 16, 4))
        want = rsteps.input_specs(rcfg, RShapeSpec("t", kind, 16, 4))
        assert list(got) == list(want)
        assert {k: (s, str(d)) for k, (s, d) in got.items()} == \
            {k: (v.shape, f"torch.{v.dtype.name}") for k, v in want.items()}
    got = tsteps.cache_specs(cfg, ShapeSpec("t", "decode", 16, 4))
    assert {k: (s, str(d)) for k, (s, d) in _flat(got).items()} == \
        _specs(rsteps.cache_specs(rcfg, RShapeSpec("t", "decode", 16, 4)))
    got = tsteps.model_param_specs(cfg)
    assert {k: (s, str(d)) for k, (s, d) in _flat(got).items()} == \
        _specs(rsteps.model_param_specs(rcfg))
    caches = tw.init_cache(cfg, 4, 16, device="cpu")
    assert caches.pop("host_index") == 0
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(caches).items()} == \
        _specs(rw.init_cache_specs(rcfg, 4, 16))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_whisper_from_jax_is_bit_exact(dtype):
    rcfg = rget_reduced(ARCH).replace(param_dtype=dtype, compute_dtype=dtype)
    params = jax.tree.map(np.asarray, rw.init_params(rcfg, jax.random.PRNGKey(1)))
    model = whisper_from_jax(_port_cfg(rcfg), params, device="cpu")
    assert isinstance(model, tw.Whisper)
    got, want = _flat(to_numpy(model.tree())), _flat(params)
    assert sorted(got) == sorted(want) and "dec_layers/xattn/wq" in got
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.view(got[k].dtype), err_msg=k)


def test_whisper_from_jax_rejects_wrong_trees():
    rcfg = rget_reduced(ARCH)
    params = jax.tree.map(np.asarray, rw.init_params(rcfg, jax.random.PRNGKey(1)))
    bad = dict(params, enc_in_proj=params["enc_in_proj"][:-1])
    with pytest.raises(ValueError, match="enc_in_proj"):
        whisper_from_jax(_port_cfg(rcfg), bad, device="cpu")
    bad = {k: v for k, v in params.items() if k != "enc_final_ln"}
    with pytest.raises(ValueError, match="keys"):
        whisper_from_jax(_port_cfg(rcfg), bad, device="cpu")


def test_init_params_follows_the_reference_rule():
    """Ones where the reference puts ones (1-D, (n_layers, d) scales);
    N(0, 1) / sqrt(shape[-2]) elsewhere."""
    cfg = _port_cfg(rget_reduced(ARCH))
    tree = tw.init_params(cfg, seed=0, device="cpu").tree()
    assert _flat({k: tuple(v.shape) for k, v in _flat(tree).items()}) == \
        _flat(tw.param_shapes(cfg))
    for k, v in _flat(tree).items():
        v = v.float()
        if v.ndim == 1 or tuple(v.shape) == (cfg.n_layers, cfg.d_model):
            assert bool((v == 1).all()), k
        else:
            std = float(v.std()) * np.sqrt(v.shape[-2])
            assert 0.8 < std < 1.2, (k, std)


# ---------------------------------------------------------------------------
# encoder, decoder, serving
# ---------------------------------------------------------------------------

def test_encode_matches_reference(wh):
    _, cfg, _, model, frames, _, enc = wh
    _close(tw.encode(model, _t(frames), cfg), enc, 1e-4)


def test_teacher_forced_decode_matches_reference(wh):
    rcfg, cfg, params, model, _, tokens, enc = wh
    want, _ = jax.jit(functools.partial(rw.decode_forward, cfg=rcfg))(
        params, tokens, enc)
    got, caches = tw.decode_forward(model, _t(tokens), _t(enc), cfg)
    assert caches is None
    _close(got, want, 1e-4)


def test_prefill_and_decode_match_reference(wh):
    """The reference's prefill and decode_step through the steps: logits,
    the self cache, the cross K/V written once, the index."""
    rcfg, cfg, params, model, frames, tokens, _ = wh
    rng = np.random.default_rng(4)
    steps = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]
    prefill = jax.jit(rsteps.make_prefill_step(rcfg, S + STEPS))
    decode = jax.jit(rsteps.make_decode_step(rcfg))
    logits, caches = prefill(params, {"frames": frames, "tokens": tokens})
    want, want_caches = [logits], [caches]
    for t in steps:
        logits, caches = decode(params, t, caches)
        want.append(logits)
        want_caches.append(caches)

    logits, caches = tsteps.make_prefill_step(cfg, S + STEPS)(
        model, {"frames": _t(frames), "tokens": _t(tokens)})
    xk = caches["xk"]

    def snap(c):
        return {k: v.clone() for k, v in _flat({k: c[k] for k in c
                                                if k != "host_index"}).items()}
    got, got_caches = [logits], [snap(caches)]
    for t in steps:
        logits, caches = tsteps.make_decode_step(cfg)(model, _t(t), caches)
        got.append(logits)
        got_caches.append(snap(caches))
    assert caches["xk"] is xk and caches["host_index"] == S + STEPS
    _close(torch.stack(got, 1), np.stack([np.asarray(w) for w in want], 1), 1e-4)
    for i, (g, w) in enumerate(zip(got_caches, want_caches)):
        w = _flat(w)
        assert sorted(g) == sorted(w)
        np.testing.assert_array_equal(g["self/index"].numpy(), np.asarray(w["self/index"]))
        for k in ("self/k", "self/v", "xk", "xv"):
            _close(g[k], w[k], 1e-4, f"{k} after step {i}")


def test_cross_attention_decode_matches_attention_scores(wh):
    """One decode step's cross-attention: the plain decode_attention over
    a layer's cross K/V at length F against the reference's non-causal
    attention_scores route over the same K/V."""
    rcfg, cfg, _, _, _, _, enc = wh
    rng = np.random.default_rng(7)
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rng.normal(size=(B, 1, hkv, h // hkv, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, cfg.enc_frames, hkv, hd)).astype(np.float32)
            for _ in range(2))
    want = rl.attention_scores(q, k, v, causal=False)
    length = torch.full((B,), cfg.enc_frames, dtype=torch.int32)
    got = treg.resolve("cpu").decode_attention(_t(q[:, 0]), _t(k), _t(v), length)
    _close(got[:, None], want, 1e-5)


def test_decode_attention_launches_per_step(wh, monkeypatch):
    """A decode step asks the registry's decode_attention twice a decoder
    layer (self below index + 1, cross at F; one length tensor of each a
    step); the prefill never."""
    _, cfg, _, model, frames, tokens, _ = wh
    kernels = treg.resolve("cpu")
    calls = []
    plain = kernels.decode_attention

    def counted(q, k, v, length):
        calls.append((k.shape[1], int(length[0]), id(length)))
        return plain(q, k, v, length)

    monkeypatch.setitem(kernels._fns, "decode_attention", counted)
    _, caches = tsteps.make_prefill_step(cfg, S + 2)(
        model, {"frames": _t(frames), "tokens": _t(tokens)})
    assert calls == []
    for i in range(2):
        tsteps.make_decode_step(cfg)(model, torch.ones((B, 1), dtype=torch.int32),
                                     caches)
        step = calls[2 * cfg.n_layers * i:]
        assert [c[:2] for c in step] == \
            [(S + 2, S + 1 + i), (cfg.enc_frames, cfg.enc_frames)] * cfg.n_layers
        assert len({c[2] for c in step[0::2]}) == len({c[2] for c in step[1::2]}) == 1
    assert len(calls) == 2 * 2 * cfg.n_layers


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(wh):
    _, cfg, _, _, frames, tokens, _ = wh
    labels = np.random.default_rng(8).integers(0, cfg.vocab, tokens.shape).astype(np.int32)
    labels[-1, :2] = -1
    return {"frames": frames, "tokens": tokens, "labels": labels}


@pytest.mark.parametrize("remat", ["block", "none"])
def test_loss_and_gradients_match_reference(wh, remat):
    """Through the encoder and both attentions of every decoder layer, with
    and without recomputing each layer in the backward pass."""
    rcfg, _, params, model, _, _, _ = wh
    rcfg = rcfg.replace(remat=remat)
    batch = _batch(wh)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: rw.loss_fn(p, batch, rcfg)))(params)
    loss, got = tsteps.value_and_grad(tsteps.make_loss_fn(_port_cfg(rcfg)),
                                      model.tree(),
                                      {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    assert float(np.abs(want["enc_in_proj"]).max()) > 0


def test_train_step_matches_reference(wh):
    """make_train_step at n_micro = 2 over the frames, tokens and labels."""
    rcfg, cfg, params, _, _, _, _ = wh
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    batch = _batch(wh)
    rstate = {"params": params, "opt": radamw.init_state(params, ROptConfig(**kw))}
    rstep = jax.jit(rsteps.make_train_step(rcfg, ROptConfig(**kw), n_micro=2))
    rstate, rloss = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    model = whisper_from_jax(cfg, params, device="cpu")
    ocfg = OptConfig(**kw)
    tstate = {"params": model.tree(), "opt": adamw.init_state(model.tree(), ocfg)}
    tstate, tloss = tsteps.make_train_step(cfg, ocfg, n_micro=2)(
        tstate, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-5)
    want, got = _flat(jax.tree.map(np.asarray, rstate)), _flat(tstate)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.astype(np.float32)
        if not k.startswith("params"):
            np.testing.assert_allclose(_np(got[k]), w, rtol=1e-5,
                                       atol=1e-4 * float(np.abs(w).max()), err_msg=k)
            continue
        # as tests/test_torch_vlm.py: AdamW's first step is ~lr x the sign of
        # the gradient, undetermined where the gradient is within tolerance
        m = want["opt/m/" + k[len("params/"):]]
        resolved = np.abs(m) > 1e-4 * float(np.abs(m).max())
        diff = np.abs(_np(got[k]) - w)
        assert float(diff.max()) <= 2 * kw["lr"], k
        assert float((diff - 1e-5 * np.abs(w))[resolved].max(initial=0)) <= \
            1e-2 * kw["lr"], k


def test_train_main_exits_for_the_family():
    """The reference's launcher exits for encdec: a whisper-specific driver
    trains it."""
    with pytest.raises(SystemExit, match="whisper-specific driver"):
        ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with tempfile.TemporaryDirectory() as d, \
            pytest.raises(SystemExit, match="whisper-specific driver"):
        ttrain.run(_port_cfg(rget_reduced(ARCH)), OptConfig(), {}, steps=1,
                   batch=1, seq=4, ckpt_dir=d, device="cpu")


def test_lm_functions_refuse_the_family():
    """models/lm.py's decoder-only functions point at models/whisper.py."""
    cfg = _port_cfg(rget_reduced(ARCH))
    tlm.require_ported(cfg)
    for call in (lambda: tlm.param_shapes(cfg), lambda: tlm.init_cache(cfg, 1, 4, "cpu")):
        with pytest.raises(ValueError, match="whisper"):
            call()
