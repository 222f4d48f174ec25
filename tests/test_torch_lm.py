"""The port's LM serving path (repro_torch.models, repro_torch.launch.steps)
against the reference package's, on the CPU: layers, the weight carry-over,
full forwards, and prefill followed by decode steps with their caches.

Weights are the reference's ``init_params`` carried over bit for bit with
``params_from_jax``; tokens come from numpy.  Tolerances:

- float32 layers: atol 1e-5 (the same float32 operations, summed in
  another order by another library);
- float32 models: atol 1e-4 on logits of magnitude ~1, against both of the
  reference's decode routes (``attn_decode_kernel`` False: plain softmax
  attention; True: its Pallas kernel in interpret mode); the port always
  decodes through ``decode_attention``;
- bfloat16 models: 0.1, the reference's own bound between its two bf16
  decode routes (tests/test_kernels_decode_attention.py): its plain route
  rounds the softmax weights to bf16, the kernel keeps them in float32.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import get_reduced as rget_reduced  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import layers as rl  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_are_the_references():
    from repro.configs import ARCH_IDS as rids
    from repro_torch.configs import ARCH_IDS
    assert ARCH_IDS == rids
    for arch in ARCH_IDS:
        for mine, ref in ((get_config(arch), rget_config(arch)),
                          (get_reduced(arch), rget_reduced(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert mine.param_count() == ref.param_count()


# ---------------------------------------------------------------------------
# layers, float32
# ---------------------------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=64).astype(np.float32)
    _close(tl.rmsnorm(_t(x), _t(scale), 1e-5), rl.rmsnorm(x, scale, 1e-5), 1e-5)
    _close(tl.rmsnorm(_t(x), None, 1e-6), rl.rmsnorm(x, None, 1e-6), 1e-5)
    _close(tl.nonparam_layernorm(_t(x), 1e-5), rl.nonparam_layernorm(x, 1e-5), 1e-5)
    for nonparam in (False, True):
        cfg = get_reduced("olmo-1b").replace(nonparam_ln=nonparam)
        rcfg = rget_reduced("olmo-1b").replace(nonparam_ln=nonparam)
        _close(tl.norm(_t(x), _t(scale), cfg), rl.norm(x, scale, rcfg), 1e-5)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 6)).astype(np.int32)
    _close(tl.rope_freqs(32, 1e6), rl.rope_freqs(32, 1e6), 1e-7)
    _close(tl.apply_rope(_t(x), _t(pos), 1e6), rl.apply_rope(x, pos, 1e6), 1e-5)


def _qkv(rng, b, sq, sk, hkv, g, hd):
    return (rng.normal(size=(b, sq, hkv, g, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 4), (False, 0)])
def test_attention_scores_matches_reference(causal, q_offset):
    q, k, v = _qkv(np.random.default_rng(2), 2, 5, 9, 2, 3, 16)
    got = tl.attention_scores(_t(q), _t(k), _t(v), causal, q_offset)
    _close(got, rl.attention_scores(q, k, v, causal, q_offset), 1e-5)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 30), (False, 0)])
def test_attention_chunked_matches_reference(causal, q_offset):
    """Sk = 37 over chunks of 8: the last chunk is short (the reference pads
    it); causal with q_offset, and the plain softmax as a second oracle."""
    q, k, v = _qkv(np.random.default_rng(3), 2, 7, 37, 2, 2, 16)
    got = tl.attention_chunked(_t(q), _t(k), _t(v), causal, q_offset, kv_chunk=8)
    _close(got, rl.attention_chunked(q, k, v, causal, q_offset, kv_chunk=8), 1e-5)
    _close(got, rl.attention_scores(q, k, v, causal, q_offset), 1e-5)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(4)
    p = {n: rng.normal(size=s).astype(np.float32) / 8
         for n, s in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    _close(tl.swiglu({n: _t(a) for n, a in p.items()}, _t(x)), rl.swiglu(p, x), 1e-5)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _jax_params(rcfg, seed):
    return jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.PRNGKey(seed)))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _port_tensor(model, path, layer):
    """The port's tensor at a reference parameter path (and layer of its
    stack; the moe family's blocks run its dense_layers first)."""
    if path[0] not in tlm.stacks(model.cfg):
        return getattr(model, path[0])
    first = tlm.stacks(model.cfg).get("dense_layers", 0) if path[0] == "layers" else 0
    t = getattr(model.blocks[first + layer], path[1])
    for k in path[2:]:
        t = t[k]
    return t


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmo-1b", "deepseek-moe-16b",
                                  "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(arch, dtype):
    rcfg = rget_reduced(arch).replace(param_dtype=dtype)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    params = _jax_params(rcfg, 0)
    model = params_from_jax(cfg, params, device="cpu")
    n = 0
    for path, a in _leaves(params):
        stacked = path[0] in tlm.stacks(cfg)
        for layer in (range(a.shape[0]) if stacked else [None]):
            want = a if layer is None else a[layer]
            got = _port_tensor(model, path, layer)
            assert str(got.dtype) == f"torch.{dtype}", path
            bits = np.int16 if dtype == "bfloat16" else np.int32
            view = torch.int16 if dtype == "bfloat16" else torch.int32
            np.testing.assert_array_equal(got.view(view).numpy(),
                                          np.asarray(want).view(bits), str(path))
            n += got.numel()
    assert n == sum(p.numel() for p in model.parameters())


def test_params_from_jax_rejects_wrong_shapes():
    rcfg = rget_reduced("qwen3-0.6b")
    params = _jax_params(rcfg, 0)
    params["layers"]["attn"]["wq"] = params["layers"]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(ModelConfig(**dataclasses.asdict(rcfg)), params, "cpu")


def test_init_params_follows_the_reference_rule():
    """Ones for 1-D scales, 0.02 N(0, 1) for (L, d) norms and the embedding,
    N(0, 1) / sqrt(L) for the (L, hd) qk norms, N(0, 1) / sqrt(d) for wq."""
    cfg = get_reduced("qwen3-0.6b").replace(**F32)
    m = tlm.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(m.final_ln, torch.ones(cfg.d_model))
    ln1 = torch.stack([b.ln1 for b in m.blocks])
    qn = torch.stack([b.attn["q_norm"] for b in m.blocks])
    wq = torch.stack([b.attn["wq"] for b in m.blocks])
    for t, std in ((m.embed, 0.02), (ln1, 0.02),
                   (qn, 1 / np.sqrt(cfg.n_layers)), (wq, 1 / np.sqrt(cfg.d_model))):
        assert abs(float(t.std()) / std - 1) < 0.25, (tuple(t.shape), float(t.std()))
    if not torch.cuda.is_available():        # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlm.init_params(cfg)


# ---------------------------------------------------------------------------
# models against the reference: full forward, prefill + decode, caches
# ---------------------------------------------------------------------------

B, S, STEPS = 2, 6, 4


def _configs():
    wide = rget_config("qwen3-0.6b").replace(n_layers=2, vocab=4096)
    return {"qwen3-reduced": rget_reduced("qwen3-0.6b"),
            "olmo-reduced": rget_reduced("olmo-1b"),
            "qwen3-wide-2l": wide}


CASES = [(name, "float32", False) for name in _configs()] + \
        [(name, "float32", True) for name in _configs()] + \
        [(name, "bfloat16", False) for name in _configs()]


def _run_reference(rcfg, params, tokens, steps):
    prefill = jax.jit(rsteps.make_prefill_step(rcfg, S + STEPS))
    decode = jax.jit(rsteps.make_decode_step(rcfg))
    full = jax.jit(functools.partial(rlm.forward, cfg=rcfg))
    logits, caches = prefill(params, {"tokens": jnp.asarray(tokens)})
    out, cache_seq = [np.asarray(logits, np.float32)], [caches]
    for t in steps:
        logits, caches = decode(params, jnp.asarray(t), caches)
        out.append(np.asarray(logits, np.float32))
        cache_seq.append(caches)
    full_logits = np.asarray(full(params, jnp.asarray(tokens))[0], np.float32)
    return np.stack(out, 1), cache_seq, full_logits


def _run_port(cfg, model, tokens, steps):
    prefill = tsteps.make_prefill_step(cfg, S + STEPS)
    decode = tsteps.make_decode_step(cfg)
    logits, caches = prefill(model, {"tokens": _t(tokens)})
    out = [logits.float()]
    snap = lambda c: {k: v.clone() for k, v in c["layers"].items()}  # noqa: E731
    cache_seq = [snap(caches)]
    for t in steps:
        logits, caches = decode(model, _t(t), caches)
        out.append(logits.float())
        cache_seq.append(snap(caches))
    full_logits = tlm.forward(model, _t(tokens), cfg)[0].float()
    return torch.stack(out, 1), cache_seq, full_logits


@pytest.mark.parametrize("name,dtype,kernel_route", CASES)
def test_prefill_and_decode_match_reference(name, dtype, kernel_route):
    rcfg = _configs()[name].replace(param_dtype=dtype, compute_dtype=dtype,
                                    attn_decode_kernel=kernel_route)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    atol = 1e-4 if dtype == "float32" else 0.1
    params = _jax_params(rcfg, 7)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
             for _ in range(STEPS)]
    want, want_caches, want_full = _run_reference(rcfg, params, tokens, steps)
    model = params_from_jax(cfg, params, device="cpu")
    got, got_caches, got_full = _run_port(cfg, model, tokens, steps)
    _close(got_full, want_full, atol, "full forward")
    _close(got, want, atol, "prefill + decode logits")
    for i, (g, w) in enumerate(zip(got_caches, want_caches)):
        w = w["layers"]
        np.testing.assert_array_equal(g["index"].numpy(), np.asarray(w["index"]))
        _close(g["k"], w["k"], atol, f"cache k after step {i}")
        _close(g["v"], w["v"], atol, f"cache v after step {i}")


def test_decode_matches_full_forward_within_port():
    """Prefill then greedy decode equals a full forward over the prompt and
    the generated tokens, position by position (float32, 1e-5)."""
    cfg = get_reduced("qwen3-0.6b").replace(**F32)
    model = tlm.init_params(cfg, seed=5, device="cpu")
    prompt = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, (3, 7)).astype(np.int32))
    prefill = tsteps.make_prefill_step(cfg, 7 + 5)
    decode = tsteps.make_decode_step(cfg)
    logits, caches = prefill(model, {"tokens": prompt})
    seq, out = [prompt], [logits]
    for _ in range(5):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        seq.append(tok)
        logits, caches = decode(model, tok, caches)
        out.append(logits)
    full = tlm.forward(model, torch.cat(seq, 1), cfg)[0]
    torch.testing.assert_close(torch.stack(out, 1), full[:, 6:], atol=1e-5, rtol=0)
    assert caches["host_index"] == 12
    assert caches["layers"]["index"].tolist() == [12] * cfg.n_layers


def test_decode_goes_through_the_registry(monkeypatch):
    """Every single-token step with a cache calls the registry's
    decode_attention once per layer, whatever cfg.attn_decode_kernel says."""
    kernels = treg.resolve("cpu")
    calls = []
    plain = kernels.decode_attention

    def counted(*a):
        calls.append(a[3].tolist())
        return plain(*a)

    monkeypatch.setitem(kernels._fns, "decode_attention", counted)
    for flag in (False, True):
        cfg = get_reduced("qwen3-0.6b").replace(attn_decode_kernel=flag)
        model = tlm.init_params(cfg, seed=1, device="cpu")
        logits, caches = tsteps.make_prefill_step(cfg, 8)(
            model, {"tokens": torch.zeros((2, 5), dtype=torch.int32)})
        assert calls == []
        tsteps.make_decode_step(cfg)(model, torch.ones((2, 1), dtype=torch.int32),
                                     caches)
        assert calls == [[6, 6]] * cfg.n_layers
        calls.clear()


def test_cache_raises_past_max_seq():
    """The reference's dynamic_update_slice clamps a write past max_seq onto
    the last rows; the port raises (ROADMAP.md §3)."""
    cfg = get_reduced("qwen3-0.6b")
    model = tlm.init_params(cfg, seed=0, device="cpu")
    _, caches = tsteps.make_prefill_step(cfg, 4)(
        model, {"tokens": torch.zeros((1, 3), dtype=torch.int32)})
    step = tsteps.make_decode_step(cfg)
    _, caches = step(model, torch.zeros((1, 1), dtype=torch.int32), caches)
    with pytest.raises(ValueError, match="KV cache overflow"):
        step(model, torch.zeros((1, 1), dtype=torch.int32), caches)
    with pytest.raises(ValueError, match="KV cache overflow"):
        tsteps.make_prefill_step(cfg, 2)(
            model, {"tokens": torch.zeros((1, 3), dtype=torch.int32)})


def test_other_families_raise():
    # every family of the configs is ported (vlm and encdec:
    # tests/test_torch_vlm.py, tests/test_torch_whisper.py); a family the
    # port does not know raises, naming ROADMAP
    for arch in ("qwen2-vl-2b", "whisper-base"):
        cfg = get_reduced(arch)
        tlm.require_ported(cfg)
        assert callable(tsteps.make_prefill_step(cfg, 8))
        assert callable(tsteps.make_decode_step(cfg))
    cfg = get_reduced("qwen3-0.6b").replace(family="retnet")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsteps.make_prefill_step(cfg, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsteps.make_decode_step(cfg)
