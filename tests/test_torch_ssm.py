"""The port's ssm and hybrid families (repro_torch.models.ssm, the ssm and
hybrid branches of models/lm.py, launch/steps.py and launch/train.py)
against the reference package's, on the CPU.

Weights are the reference's ``init_params`` carried over bit for bit with
``params_from_jax``, or numpy draws; tokens and activations come from
numpy.  The port chunks every scan at ``cfg.ssm_chunk`` (a loop over the
steps of a chunk for Mamba1, the SSD decay matrix for Mamba2), the
reference scans a prompt that comes with a state as one chunk with
``lax.associative_scan``: the same recurrence, summed in another order.
Tolerances:

- float32 blocks and models: atol 1e-4 on outputs, logits and caches
  (conv tails and states h), values of magnitude ~1;
- float32 loss: rtol 1e-5; gradients every leaf within 1e-4 x its largest
  |g| of ``jax.grad``'s; a train step as tests/test_torch_moe.py's
  (parameters within 1 % of one step's size);
- bfloat16 blocks: 8 bf16 ulps of the output's largest magnitude (the
  reference rounds silu and softplus's inputs to bf16 at other points, and
  the projections feed a float32 scan whose small differences are rounded
  to bf16 again before the gate and the output projection);
- remat against no remat: bitwise; the conv orientation: exact.
"""
import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as rget_reduced  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import OptConfig, adamw  # noqa: E402

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
ARCHS = ("falcon-mamba-7b", "zamba2-7b")
# REDUCED zamba2 has 4 layers at period 2: two groups, no tail; 5 layers
# add a tail of one Mamba2 layer and a third shared application
VARIANTS = {"falcon": ("falcon-mamba-7b", {}),
            "zamba2": ("zamba2-7b", {}),
            "zamba2_tail": ("zamba2-7b", {"n_layers": 5, "shared_attn_period": 2})}
BF16_ULPS = 8


def _port_cfg(rcfg):
    return ModelConfig(**dataclasses.asdict(rcfg))


def _rcfg(variant, **kw):
    arch, over = VARIANTS[variant]
    return rget_reduced(arch).replace(**over, **kw)


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
    if isinstance(tree, tuple) and not all(isinstance(v, int) for v in tree):
        # an ssm cache's (conv tail, h), not a shape
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    return {"/".join(path): tree}


def _jax_params(rcfg, seed):
    return jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _mamba_case(rcfg, seed, b=2, s=16):
    """One Mamba block's parameters (numpy draws: matrices N(0, 1) /
    sqrt(fan-in), the 1-D parameters around their init of 1, A_log around
    0) and an input, as numpy float32."""
    rng = np.random.default_rng(seed)
    shapes = (rssm.mamba1_param_shapes if rcfg.mamba_version == 1
              else rssm.mamba2_param_shapes)(rcfg)

    def draw(name, shape):
        if name == "A_log":
            return rng.normal(0, 0.5, shape).astype(np.float32)
        if len(shape) == 1:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)
    p = {k: draw(k, v) for k, v in shapes.items()}
    x = rng.normal(size=(b, s, rcfg.d_model)).astype(np.float32)
    return p, x


def _forwards(rcfg):
    if rcfg.mamba_version == 1:
        return rssm.mamba1_forward, tssm.mamba1_forward
    return rssm.mamba2_forward, tssm.mamba2_forward


BLOCKS = {"mamba1": "falcon", "mamba2": "zamba2"}


@pytest.mark.parametrize("j", range(4))
def test_causal_conv_orientation(j):
    """A one-hot conv_w[:, j] takes the sample j steps back (j = 0: the
    current one), as the reference's _causal_conv(x, conv_w.T, ...)."""
    k, din = 4, 6
    x = np.random.default_rng(j).normal(size=(2, 9, din)).astype(np.float32)
    w = np.zeros((din, k), np.float32)
    w[:, j] = 1.0
    b = np.zeros(din, np.float32)
    got = tssm._causal_conv(_t(x), _t(w), _t(b), k).numpy()
    want = np.asarray(rssm._causal_conv(jnp.asarray(x), jnp.asarray(w).T,
                                        jnp.asarray(b), k))
    shifted = np.zeros_like(x)
    shifted[:, j:] = x[:, :x.shape[1] - j]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, shifted)


@pytest.mark.parametrize("s", [16, 13, 5, 1], ids=lambda s: f"S{s}")
@pytest.mark.parametrize("block", list(BLOCKS))
def test_mamba_forward_without_state(block, s):
    """No state: S a multiple of the chunk (8), S = 13 (the reference pads
    the last chunk), S below the chunk, and S = 1."""
    rcfg = _rcfg(BLOCKS[block], **F32)
    p, x = _mamba_case(rcfg, s, s=s)
    rfwd, tfwd = _forwards(rcfg)
    want, _ = jax.jit(functools.partial(rfwd, cfg=rcfg))(p, x)
    got, state = tfwd(tlm.tree_map(_t, p), _t(x), _port_cfg(rcfg))
    assert state is None
    _close(got, want, 1e-4, f"{block} S={s}")


@pytest.mark.parametrize("prompt", [20, 11, 3], ids=lambda s: f"prompt{s}")
@pytest.mark.parametrize("block", list(BLOCKS))
def test_mamba_chunked_prefill_then_decode(block, prompt):
    """A prefill with a (zero) state, which the reference scans as one chunk
    and the port in chunks of 8 (three at 20 tokens), then 3 single-token
    steps: outputs, conv tails and states h after every call."""
    rcfg = _rcfg(BLOCKS[block], **F32)
    cfg = _port_cfg(rcfg)
    p, x = _mamba_case(rcfg, 7 + prompt, s=prompt + 3)
    rfwd, tfwd = _forwards(rcfg)
    conv_s, h_s = rssm.ssm_state_shapes(rcfg, x.shape[0])
    rstate = (jnp.zeros(conv_s, jnp.float32), jnp.zeros(h_s, jnp.float32))
    tstate = (torch.zeros(conv_s), torch.zeros(h_s))
    tp = tlm.tree_map(_t, p)
    rcall = jax.jit(functools.partial(rfwd, cfg=rcfg))
    cuts = [(0, prompt)] + [(t, t + 1) for t in range(prompt, prompt + 3)]
    for t0, t1 in cuts:
        want, rstate = rcall(p, x[:, t0:t1], state=rstate)
        got, tstate = tfwd(tp, _t(x[:, t0:t1]), cfg, state=tstate)
        what = f"{block} tokens {t0}:{t1}"
        _close(got, want, 1e-4, what)
        _close(tstate[0], rstate[0], 1e-4, what + " conv tail")
        _close(tstate[1], rstate[1], 1e-4, what + " h")
        assert tstate[1].dtype == torch.float32


@pytest.mark.parametrize("block", list(BLOCKS))
def test_mamba_prefill_chunks_match_single_chunk(block):
    """The port's prefill at chunk 8 against its own at one chunk and the
    reference's single chunk, 40 tokens: the same recurrence."""
    rcfg = _rcfg(BLOCKS[block], **F32)
    p, x = _mamba_case(rcfg, 3, s=40)
    rfwd, tfwd = _forwards(rcfg)
    conv_s, h_s = rssm.ssm_state_shapes(rcfg, x.shape[0])
    want, (rtail, rh) = jax.jit(functools.partial(rfwd, cfg=rcfg))(
        p, x, state=(jnp.zeros(conv_s), jnp.zeros(h_s)))
    tp = tlm.tree_map(_t, p)
    for chunk in (8, 40):
        cfg = _port_cfg(rcfg).replace(ssm_chunk=chunk)
        got, (tail, h) = tfwd(tp, _t(x), cfg, state=(torch.zeros(conv_s),
                                                     torch.zeros(h_s)))
        _close(got, want, 1e-4, f"chunk {chunk}")
        _close(tail, rtail, 0.0, f"chunk {chunk} conv tail")
        _close(h, rh, 1e-4, f"chunk {chunk} h")


@pytest.mark.parametrize("block", list(BLOCKS))
def test_mamba_forward_bf16(block):
    """bfloat16 parameters and activations: within BF16_ULPS bf16 ulps of
    the output's largest magnitude."""
    rcfg = _rcfg(BLOCKS[block])
    p, x = _mamba_case(rcfg, 5, s=13)
    rfwd, tfwd = _forwards(rcfg)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want, _ = jax.jit(functools.partial(rfwd, cfg=rcfg))(jax.tree.map(bf, p), bf(x))

    def to_bf16(a):
        return _t(a).to(torch.bfloat16)
    got, _ = tfwd(tlm.tree_map(to_bf16, p), to_bf16(x), _port_cfg(rcfg))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    _close(got, want, BF16_ULPS * 2.0**-8 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# models: shapes, caches, forward, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_shapes_and_counts_are_the_references(variant):
    for rcfg in (_rcfg(variant), rget_reduced(VARIANTS[variant][0]).replace(
            n_layers=7, shared_attn_period=3)):
        cfg = _port_cfg(rcfg)
        want = _flat(rlm.param_shapes(rcfg))
        assert _flat(tlm.param_shapes(cfg)) == want
        assert cfg.param_count() == rcfg.param_count()
    from repro.configs import get_config as rget_config
    from repro_torch.configs import get_config
    arch = VARIANTS[variant][0]
    full = _flat(tlm.param_shapes(get_config(arch)))
    assert full == _flat(rlm.param_shapes(rget_config(arch)))
    n = sum(int(np.prod(s)) for s in full.values())
    assert n == {"falcon-mamba-7b": 7_272_665_088, "zamba2-7b": 6_820_742_880}[arch]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cache_specs_are_the_references(variant):
    rcfg = _rcfg(variant)
    want = {k: (tuple(s.shape), str(s.dtype))
            for k, s in _flat(rlm.init_cache_specs(rcfg, 3, 12)).items()}
    got = tlm.init_cache(_port_cfg(rcfg), 3, 12, device="cpu")
    assert got.pop("host_index") == 0
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(got).items()}
    assert got == want


B, S, STEPS = 2, 11, 3


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_decode_and_forward_match_reference(variant):
    rcfg = _rcfg(variant, **F32)
    cfg = _port_cfg(rcfg)
    params = _jax_params(rcfg, 7)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]

    prefill = jax.jit(rsteps.make_prefill_step(rcfg, S + STEPS))
    decode = jax.jit(rsteps.make_decode_step(rcfg))
    logits, caches = prefill(params, {"tokens": jnp.asarray(tokens)})
    want, want_caches = [logits], [caches]
    for t in steps:
        logits, caches = decode(params, jnp.asarray(t), caches)
        want.append(logits)
        want_caches.append(caches)
    want_full, _, _ = jax.jit(functools.partial(rlm.forward, cfg=rcfg))(
        params, jnp.asarray(tokens))

    model = params_from_jax(cfg, params, device="cpu")
    logits, caches = tsteps.make_prefill_step(cfg, S + STEPS)(model, {"tokens": _t(tokens)})

    def snap(c):
        return {k: v.clone() for k, v in _flat({k: c[k] for k in c
                                                if k != "host_index"}).items()}
    got, got_caches = [logits], [snap(caches)]
    for t in steps:
        logits, caches = tsteps.make_decode_step(cfg)(model, _t(t), caches)
        got.append(logits)
        got_caches.append(snap(caches))
    got_full, _, _ = tlm.forward(model, _t(tokens), cfg)

    _close(got_full, want_full, 1e-4, "full forward")
    _close(torch.stack(got, 1), np.stack([np.asarray(w) for w in want], 1), 1e-4,
           "prefill + decode logits")
    for i, (g, w) in enumerate(zip(got_caches, want_caches)):
        w = _flat(w)
        assert sorted(g) == sorted(w), i
        for k in w:
            if k.endswith("index"):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
            else:
                _close(g[k], w[k], 1e-4, f"{k} after step {i}")
    assert caches["host_index"] == S + STEPS


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_attention_launches_per_step(variant, monkeypatch):
    """A hybrid decode step asks the registry's decode_attention once per
    shared application (groups + 1 with a tail), on its head width; an ssm
    step never does."""
    kernels = treg.resolve("cpu")
    calls = []
    plain = kernels.decode_attention

    def counted(q, k, v, length):
        calls.append(q.shape[-1])
        return plain(q, k, v, length)

    monkeypatch.setitem(kernels._fns, "decode_attention", counted)
    cfg = _port_cfg(_rcfg(variant))
    model = tlm.init_params(cfg, seed=0, device="cpu")
    _, caches = tsteps.make_prefill_step(cfg, 8)(
        model, {"tokens": torch.zeros((2, 5), dtype=torch.int32)})
    assert calls == []
    for _ in range(2):
        tsteps.make_decode_step(cfg)(model, torch.ones((2, 1), dtype=torch.int32),
                                     caches)
    if cfg.family == "ssm":
        assert calls == []
    else:
        _, groups, tail = tlm.shared_groups(cfg)
        assert calls == [cfg.hd] * (2 * (groups + (tail > 0)))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _port_grads(cfg, tree, toks, labels):
    loss, grads = tsteps.value_and_grad(
        tsteps.make_loss_fn(cfg), tree,
        {"tokens": _t(toks), "labels": _t(labels)})
    return float(loss), {"/".join(p): g for p, g in tlm.leaves(grads)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_reference(variant):
    rcfg = _rcfg(variant, **F32)
    cfg = _port_cfg(rcfg)
    params = _jax_params(rcfg, 1)
    toks, labels = _tokens(cfg, 2, 19, 2)
    labels[1, :3] = -1
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: rlm.loss_fn(p, batch, rcfg)))(params)
    model = params_from_jax(cfg, params, device="cpu")
    loss, got = _port_grads(cfg, model.tree(), toks, labels)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    assert float(np.abs(want["layers/mamba/A_log"]).max()) > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_leaves_gradients_unchanged(variant):
    """Recomputing each layer (each group for the hybrid family) in the
    backward pass gives the same bits as keeping its activations."""
    cfg = _port_cfg(_rcfg(variant, **F32))
    toks, labels = _tokens(cfg, 2, 12, 5)
    out = []
    for remat in ("block", "none"):
        c = cfg.replace(remat=remat)
        model = tlm.init_params(c, seed=2, device="cpu")
        out.append(_port_grads(c, model.tree(), toks, labels))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


@pytest.mark.parametrize("variant", ["falcon", "zamba2_tail"])
def test_train_step_matches_reference(variant):
    rcfg = _rcfg(variant, **F32)
    cfg = _port_cfg(rcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    params = _jax_params(rcfg, 5)
    rstate = {"params": params, "opt": radamw.init_state(params, ROptConfig(**kw))}
    rstep = jax.jit(rsteps.make_train_step(rcfg, ROptConfig(**kw), n_micro=2))
    model = params_from_jax(cfg, params, device="cpu")
    ocfg = OptConfig(**kw)
    tstate = {"params": model.tree(), "opt": adamw.init_state(model.tree(), ocfg)}
    tstep = tsteps.make_train_step(cfg, ocfg, n_micro=2)
    toks, labels = _tokens(cfg, 4, 10, 20)
    rstate, rloss = rstep(rstate, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)})
    tstate, tloss = tstep(tstate, {"tokens": _t(toks), "labels": _t(labels)})
    np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, rstate))
    got = _flat(tstate)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.astype(np.float32)
        atol = 1e-2 * kw["lr"] if k.startswith("params") else \
            1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(_np(got[k]), w, rtol=1e-5, atol=atol, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_runs_the_family(arch):
    with tempfile.TemporaryDirectory() as d:
        res = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16",
                           "--ckpt-dir", d])
    assert res["steps"] == 2 and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    assert int(res["driver"].state["opt"]["step"]) == 2
