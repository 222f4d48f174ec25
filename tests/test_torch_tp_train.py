"""Training on the model axis: ``models/tp.py``'s autograd collectives,
the vocabulary-parallel loss, the global norm on a (data, model) mesh,
and the train step on (data 2, model 2) against the reference package.

The operators run on ranks simulated by threads of this process
(``tests/torch_thread_ranks.py``): each backward against the one-rank
expansion of the same function (the whole tensors on one rank, the same
float32 arithmetic), and the trap ``gather_from_model`` avoids pinned (its
backward slices the replicated cotangent, never sums it).  The
vocabulary-parallel loss is held against ``lm.token_loss`` on the gathered
logits, masked labels and a data group included, and the largest tensor a
rank makes while it runs is counted.  The thread ranks also take the train
step at (data 1, model 2) and (data 2, model 2) against the port's
one-device step.

Then ONE module-scoped spawn of four gloo ranks (``tests/torch_dp_ranks.py
DIR tp4``, started as ``torchrun`` would start them) trains the reduced
qwen3-0.6b at d = 64 on a (data 2, model 2) mesh with ZeRO-1 against the
reference's jitted one-device ``make_train_step`` on the same global batch
(``test_dp_train_step_matches_reference``'s tolerances: losses rtol 1e-5,
parameters rtol 1e-5 atol 1e-2 lr, the AdamW state atol 1e-4 x the
leaf's largest |w|), checks each rank's ZeRO-1 moments as blocks of its
model blocks, and saves a checkpoint there that restores at (2, 2) on the
ranks and at one process here, bitwise.  The (data 1, model 2) cases
against the reference run in tests/test_torch_sharding.py's two-rank
spawn.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import ShapeSpec, get_reduced  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import sharding as tsharding  # noqa: E402
from repro_torch.models import tp  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from torch_thread_ranks import run_ranks, thread_meshes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def _model(mesh):
    return mesh.groups["model"]


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the operators, against their one-rank expansions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4])
def test_copy_to_model_and_reduce_from_model(m):
    """x (replicated) @ this rank's columns, a nonlinearity, @ its rows, then
    the sum: the loss and the gradients of x and of every block equal the
    one-rank function's (f's backward sums the ranks' parts; g's forward
    sums in float32, its backward is the identity)."""
    g = torch.Generator().manual_seed(m)
    x = torch.randn(3, 5, 8, generator=g)
    w1, w2 = torch.randn(8, 4 * m, generator=g), torch.randn(4 * m, 8, generator=g)
    c = torch.randn(3, 5, 8, generator=g)

    def one(x, w1, w2):
        return ((torch.tanh(x @ w1) @ w2) * c).sum()

    want = [t.requires_grad_() for t in (x.clone(), w1.clone(), w2.clone())]
    loss = one(*want)
    grads = torch.autograd.grad(loss, want)

    def rank(mesh):
        group, r = _model(mesh), mesh.coords["model"]
        xs = x.clone().requires_grad_()
        b1 = w1[:, 4 * r:4 * r + 4].clone().requires_grad_()
        b2 = w2[4 * r:4 * r + 4].clone().requires_grad_()
        y = tp.reduce_from_model(torch.tanh(tp.copy_to_model(xs, group) @ b1) @ b2, group)
        out = (y * c).sum()
        return (float(out.detach()), *torch.autograd.grad(out, (xs, b1, b2)))

    outs = run_ranks(rank, thread_meshes((1, m)))
    for r, (val, gx, g1, g2) in enumerate(outs):
        _close(val, float(loss.detach()))
        _close(gx, grads[0])
        _close(g1, grads[1][:, 4 * r:4 * r + 4])
        _close(g2, grads[2][4 * r:4 * r + 4])
        assert torch.equal(gx, outs[0][1])          # replicated: the same bits


@pytest.mark.parametrize("m", [2, 4])
def test_gather_backward_slices_never_sums(m):
    """The trap: the gathered tensor feeds a computation every rank repeats,
    so each rank's cotangent of it is already the whole one.  The backward
    takes this rank's block of it: each block's gradient is the one-rank
    gradient, not M times it (a reduce-scatter would sum M replicated
    cotangents)."""
    g = torch.Generator().manual_seed(10 + m)
    x = torch.randn(2, 3 * m, 4, generator=g)
    c = torch.randn(2, 3 * m, 4, generator=g)
    whole = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad((torch.sin(whole) * c).sum(), whole)

    def rank(mesh):
        group, r = _model(mesh), mesh.coords["model"]
        part = x[:, 3 * r:3 * r + 3].clone().requires_grad_()
        full = tp.gather_from_model(part, group, dim=1)
        (gp,) = torch.autograd.grad((torch.sin(full) * c).sum(), part)
        return gp, dict(mesh.counts)

    for r, (gp, counts) in enumerate(run_ranks(rank, thread_meshes((1, m)))):
        _close(gp, gx[:, 3 * r:3 * r + 3])
        assert not torch.allclose(gp, m * gx[:, 3 * r:3 * r + 3])
        # one all-gather forward, nothing in the backward
        assert counts == {"all_gather": {"calls": 1, "bytes": x.numel() * 4}}


@pytest.mark.parametrize("m", [2, 4])
def test_scatter_to_model_backward_gathers(m):
    """A replicated y's block through a row-parallel product and g: the
    cotangent of y comes back whole and replicated (an all-gather), so a
    gather before it slices correctly; the whole chain's gradient is the
    one-rank one."""
    g = torch.Generator().manual_seed(20 + m)
    x = torch.randn(3, 2 * m, generator=g)
    w = torch.randn(2 * m, 5, generator=g)
    want_x, want_w = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss = torch.cos(torch.exp(want_x) @ want_w).sum()
    gx, gw = torch.autograd.grad(loss, (want_x, want_w))

    def rank(mesh):
        group, r = _model(mesh), mesh.coords["model"]
        xp = x[:, 2 * r:2 * r + 2].clone().requires_grad_()
        wp = w[2 * r:2 * r + 2].clone().requires_grad_()
        y = torch.exp(tp.gather_from_model(xp, group, dim=1))     # replicated
        out = tp.reduce_from_model(tp.scatter_to_model(y, group, -1) @ wp, group)
        val = torch.cos(out).sum()
        return (float(val.detach()), *torch.autograd.grad(val, (xp, wp)))

    # float32 sums of M partials in another order: rtol 1e-4
    for r, (val, gxp, gwp) in enumerate(run_ranks(rank, thread_meshes((1, m)))):
        _close(val, float(loss.detach()), rtol=1e-4, atol=1e-5)
        _close(gxp, gx[:, 2 * r:2 * r + 2], rtol=1e-4, atol=1e-5)
        _close(gwp, gw[2 * r:2 * r + 2], rtol=1e-4, atol=1e-5)


def test_all_to_all_backward_is_the_reverse_exchange():
    """<A x, y> = <x, A^T y> over the ranks: the gradient of the exchanged
    rows' weighted sum is the weights sent back."""
    send = [[1, 3], [2, 2]]                  # rows rank i sends to rank j
    g = torch.Generator().manual_seed(7)
    xs = [torch.randn(sum(s), 3, generator=g) for s in send]

    def rank(mesh):
        group, r = _model(mesh), mesh.coords["model"]
        recv = [send[i][r] for i in range(2)]
        x = xs[r].clone().requires_grad_()
        y = tp.all_to_all_model(x, group, send[r], recv)
        wts = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) + 10 * r
        (gx,) = torch.autograd.grad((y * wts).sum(), x)
        return y.detach(), wts, gx

    outs = run_ranks(rank, thread_meshes((1, 2)))
    # the forward: rank j holds rank i's rows for j, in rank order
    for j in range(2):
        parts = [xs[i].split(send[i])[j] for i in range(2)]
        assert torch.equal(outs[j][0], torch.cat(parts))
    # the backward: each row's weight, from the rank that received it
    for i in range(2):
        back = [outs[j][1].split([send[k][j] for k in range(2)])[i] for j in range(2)]
        assert torch.equal(outs[i][2], torch.cat(back))


# ---------------------------------------------------------------------------
# the vocabulary-parallel loss
# ---------------------------------------------------------------------------


class _Largest(torch.utils._python_dispatch.TorchDispatchMode):
    """The most elements of any tensor an op returns while it is on, and
    the shapes of those it returns."""

    def __init__(self):
        super().__init__()
        self.most = 0
        self.shapes: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("dp,m", [(1, 2), (1, 4), (2, 2)])
def test_vocab_parallel_loss_matches_token_loss(dp, m):
    """Each rank's block of the logits of its rows: the loss (this rank's
    share over the data group, the masked labels counted on every rank)
    and each block's gradient against ``token_loss`` of the whole logits;
    the collectives move (B, S) rows (a max, then the sum of exponentials
    and the gold logit together), and no op makes a tensor of B x S x V."""
    b, s, v = 2 * dp, 6, 8 * m
    g = torch.Generator().manual_seed(dp * 10 + m)
    logits = torch.randn(b, s, v, generator=g) * 3
    labels = torch.randint(0, v, (b, s), generator=g)
    labels[-1, :4] = -1                     # the last data rank's rows only
    labels[0, 0] = v - 1                    # the last vocabulary block's
    whole = logits.clone().requires_grad_()
    loss = tlm.token_loss(whole, labels)
    (gw,) = torch.autograd.grad(loss, whole)

    def rank(mesh):
        group, r, d = _model(mesh), mesh.coords["model"], mesh.coords["data"]
        rows = slice(d * b // dp, (d + 1) * b // dp)
        blk = logits[rows, :, r * v // m:(r + 1) * v // m].clone().requires_grad_()
        dgroup = mesh.dp if dp > 1 else None
        with _Largest() as seen:
            share = tp.vocab_parallel_token_loss(blk, labels[rows], group, dgroup)
            (gb,) = torch.autograd.grad(share, blk)
        total = mesh.dp.all_reduce(share.detach().clone()) if dp > 1 else share.detach()
        return float(total), gb, seen.most, dict(mesh.counts)

    outs = run_ranks(rank, thread_meshes((dp, m)))
    for i, (val, gb, most, counts) in enumerate(outs):
        d, r = divmod(i, m)
        _close(val, float(loss))
        _close(gb, gw[d * b // dp:(d + 1) * b // dp, :, r * v // m:(r + 1) * v // m])
        assert most < b // dp * s * v, most
        rows = b // dp * s
        assert counts["all_reduce_max"] == {"calls": 1, "bytes": 4 * rows}
        want = {"calls": 1 + (dp > 1) * 2, "bytes": 4 * 2 * rows + (dp > 1) * 8}
        assert counts["all_reduce_sum"] == want, counts


def test_vocab_parallel_loss_in_a_train_step_never_gathers_logits():
    """The reduced qwen3-0.6b's loss on (data 1, model 2): the same value as
    one rank's; in its forward and backward a rank makes its (B, S, V/2)
    block of the logits and no (B, S, V) tensor (no 3-dim tensor as wide
    as the vocabulary)."""
    cfg = get_reduced("qwen3-0.6b").replace(**F32)
    whole = tlm.init_params(cfg, seed=3, device="cpu").tree()
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (2, 16), generator=g, dtype=torch.int32)}
    want = float(tlm.loss_fn(whole, batch, cfg))

    def rank(mesh):
        params = tsharding.shard_params(whole, mesh)
        with _Largest() as seen:
            loss, _ = tsteps.value_and_grad(tsteps.make_loss_fn(cfg, mesh=mesh),
                                            params, batch)
        return float(loss), seen

    for loss, seen in run_ranks(rank, thread_meshes((1, 2))):
        _close(loss, want)
        assert (2, 16, cfg.vocab // 2) in seen.shapes
        assert (2, 16, cfg.vocab) not in seen.shapes
        assert not any(len(sh) == 3 and sh[-1] >= cfg.vocab for sh in seen.shapes)


# ---------------------------------------------------------------------------
# the global norm on a (data, model) mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zero1", [True, False])
@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)])
def test_global_norm_counts_replicated_leaves_once(sizes, zero1):
    """``adamw.update`` on a model axis: a model-sharded leaf's squares
    summed over "model" and "data", a leaf replicated over "model" (a norm
    scale) counted once, not M times: the norm is the whole gradient's."""
    dp, m = sizes
    g = torch.Generator().manual_seed(dp + m)
    shapes = {"embed": (8, 4), "final_ln": (4,), "layers": {"w_up": (3, 4, 6)}}
    grads = {k: (torch.randn(v, generator=g) if isinstance(v, tuple) else
                 {n: torch.randn(s, generator=g) for n, s in v.items()})
             for k, v in shapes.items()}
    want = float(torch.sqrt(sum(torch.sum(t * t) for _, t in tlm.leaves(grads))))
    ocfg = OptConfig(zero1=zero1)

    def rank(mesh):
        specs = tsharding.param_shardings(None, mesh, grads)
        mine = tsharding.shard_params(grads, mesh)
        params = tlm.tree_map(torch.zeros_like, mine)
        state = tadamw.init_state(params, ocfg, mesh=mesh, specs=specs)
        # each data rank holds a 1/dp share of the gradient
        share = tlm.tree_map(lambda t: t / dp, mine)
        _, _, stats = tadamw.update(params, share, state, ocfg, mesh=mesh, specs=specs)
        return float(stats["grad_norm"])

    for got in run_ranks(rank, thread_meshes(sizes)):
        _close(got, want)


# ---------------------------------------------------------------------------
# the train step on thread ranks against the port's one-device step
# ---------------------------------------------------------------------------

THREAD_CASES = {
    "qwen3-1x2": ("qwen3-0.6b", {}, (1, 2), 1),
    "qwen3-1x2-micro2": ("qwen3-0.6b", {}, (1, 2), 2),
    # heads, the vocabulary and the MLP the rules do not cut whole
    "qwen3-1x2-replicated": ("qwen3-0.6b", dict(vocab=511, d_ff=255, n_heads=3,
                                                n_kv_heads=1), (1, 2), 1),
    "qwen3-2x2-micro2": ("qwen3-0.6b", dict(d_model=64), (2, 2), 2),
    "moe-ep-1x2": ("deepseek-moe-16b", dict(capacity_factor=0.5, moe_impl="ep"),
                   (1, 2), 1),
    "moe-gspmd-1x2": ("deepseek-moe-16b", dict(capacity_factor=0.5), (1, 2), 1),
}


def _compare_state(got: dict, want: dict, lr: float):
    for (k, w), (_, h) in zip(tlm.leaves(want), tlm.leaves(got)):
        w, h = w.float().numpy(), h.float().numpy()
        atol = 1e-2 * lr if k[0] == "params" else 1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(h, w, rtol=1e-5, atol=atol, err_msg="/".join(k))


@pytest.mark.parametrize("name", list(THREAD_CASES))
def test_thread_ranks_train_step_matches_one_device(name):
    """Two steps with remat per block on thread ranks, the global batch on
    each: the losses (every rank the same), the state gathered over both
    axes, against the port's one-device step (itself held against the
    reference's in tests/test_torch_train.py and tests/test_torch_moe.py)."""
    arch, changes, sizes, n_micro = THREAD_CASES[name]
    cfg = get_reduced(arch).replace(**F32, **changes)
    assert cfg.remat == "block"
    whole = tlm.init_params(cfg, seed=1, device="cpu").tree()
    g = torch.Generator().manual_seed(2)
    batches = []
    for _ in range(2):
        b = {"tokens": torch.randint(0, cfg.vocab, (4, 16), generator=g, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (4, 16), generator=g, dtype=torch.int32)}
        b["labels"][3, :5] = -1
        batches.append(b)
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    one = {"params": tlm.tree_map(torch.clone, whole)}
    one["opt"] = tadamw.init_state(one["params"], ocfg)
    step = tsteps.make_train_step(cfg, ocfg, n_micro)
    want = [float(step(one, b)[1]) for b in batches]

    def rank(mesh):
        cell = tsteps.cell_shardings(cfg, ShapeSpec("t", "train", 16, 4), mesh, ocfg)
        params = tsharding.shard_params(whole, mesh)
        state = {"params": params, "opt": tadamw.init_state(
            params, ocfg, mesh=mesh, specs=cell["params"])}
        step = tsteps.make_train_step(cfg, ocfg, n_micro, mesh=mesh)
        losses = [float(step(state, b)[1]) for b in batches]
        return losses, tsharding.gather_tree(
            state, {"params": cell["params"], "opt": cell["opt_sh"]}, mesh)

    outs = run_ranks(rank, thread_meshes(sizes))
    for losses, state in outs:
        assert losses == outs[0][0]
        _close(losses, want)
        _compare_state(state, one, ocfg.lr)


# ---------------------------------------------------------------------------
# four gloo ranks: (data 2, model 2) against the reference
# ---------------------------------------------------------------------------

TP4_WORLD = 4
TP4_KW = dict(lr=1e-3, warmup_steps=2, total_steps=20)
TP4_MICRO = (1, 2)
TP4_STEPS = 2


def _tp4_rcfg():
    return rconfigs.get_reduced("qwen3-0.6b").replace(**F32, d_model=64)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def tp4_run():
    """Write the inputs, start the four ranks, run the reference's one-device
    steps while they work; (inputs, reference, rank outputs, dir)."""
    tmp = tempfile.TemporaryDirectory(prefix="torch_tp4_")
    d = tmp.name
    rcfg = _tp4_rcfg()
    params = jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.PRNGKey(8)))
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(TP4_STEPS):
        labels = rng.integers(0, rcfg.vocab, (8, 16)).astype(np.int32)
        labels[5, :7] = -1          # one data rank's rows: another count
        batches.append({"tokens": rng.integers(0, rcfg.vocab, (8, 16)).astype(np.int32),
                        "labels": labels})
    inputs = {"cfg": dataclasses.asdict(rcfg), "ocfg": dict(TP4_KW, zero1=True),
              "params": params, "batches": batches, "micro": TP4_MICRO,
              "ckpt_dir": os.path.join(d, "ckpt")}
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    port = _free_port()
    procs = []
    for r in range(TP4_WORLD):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1", RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(TP4_WORLD), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dp_ranks.py"), d, "tp4"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        ref = {}
        for n in TP4_MICRO:
            ocfg = ROptConfig(**TP4_KW)
            state = {"params": params, "opt": radamw.init_state(params, ocfg)}
            step = jax.jit(rsteps.make_train_step(rcfg, ocfg, n_micro=n))
            losses = []
            for b in batches:
                state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()})
                losses.append(float(loss))
            ref[n] = (losses, jax.tree.map(np.asarray, state))
        outs = []
        for r, p in enumerate(procs):
            _, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {r}:\n{stderr[-6000:]}"
            outs.append(torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False))
        yield inputs, ref, outs, d
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def test_tp4_ranks_ran_on_a_data_model_mesh(tp4_run):
    _, _, outs, _ = tp4_run
    for r, o in enumerate(outs):
        assert o["world"] == TP4_WORLD and o["backend"] == "gloo"
        assert o["mesh"] == {"data": 2, "model": 2}
        assert o["coords"] == {"data": r // 2, "model": r % 2}


@pytest.mark.parametrize("n_micro", TP4_MICRO)
def test_tp4_train_step_matches_reference(tp4_run, n_micro):
    """TP with DP and ZeRO-1: both steps' losses (rtol 1e-5, every rank the
    same), then the parameters and the AdamW state gathered over both axes
    against the reference's one-device state."""
    _, ref, outs, _ = tp4_run
    want_losses, want_state = ref[n_micro]
    got = outs[0]["cases"][n_micro]
    for o in outs:
        assert o["cases"][n_micro]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    want, have = _flat(want_state), _flat(got["state"])
    assert sorted(have) == sorted(want)
    for k, w in want.items():
        w = w.astype(np.float32)
        atol = 1e-2 * TP4_KW["lr"] if k.startswith("params") else \
            1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(np.asarray(have[k], np.float32), w, rtol=1e-5,
                                   atol=atol, err_msg=k)


def test_tp4_zero1_blocks_of_model_blocks(tp4_run):
    """Each rank's moments are ``zero1_spec``'s data-axis blocks of its model
    blocks: the shape the whole leaf's spec gives, the gathered state's
    block; some leaves are cut over both axes."""
    _, _, outs, _ = tp4_run
    both = 0
    for r, o in enumerate(outs):
        for path, b in o["cases"][1]["blocks"].items():
            assert b["shape"] == b["zero1_shape"] and b["is_block"], (r, path, b)
            names = {a for e in b["spec"] if e is not None
                     for a in ((e,) if isinstance(e, str) else e)}
            both += names >= {"data", "model"}
    assert both > 0


def test_tp4_checkpoint_restores_at_2x2_and_one_process(tp4_run):
    """The checkpoint saved at (2, 2): on the ranks, restored into a fresh
    state bitwise against the live blocks; here, at one process, bitwise
    against the state gathered on the ranks."""
    _, _, outs, d = tp4_run
    for o in outs:
        assert o["ckpt"]["bitwise"] and o["ckpt"]["step"] == TP4_STEPS, o["ckpt"]
    whole = outs[0]["cases"][1]["state"]
    template = jax.tree.map(torch.from_numpy, whole)
    tree, step, _ = tckpt.restore(os.path.join(d, "ckpt"), template, device="cpu")
    assert step == TP4_STEPS
    for k, w in _flat(whole).items():
        assert np.array_equal(_flat(tree)[k].numpy(), w), k
