"""The port's training path against the JAX package on the CPU: the
fused head + cross entropy, the transformer's loss and gradients (remat
included), the token stream, the optimizer, the train step (with
``steps_per_call``), ``TrainLoop`` and the entry point (with ``--data``
and ``--ckpt-dir``).

Inputs are numpy arrays made from a seed and handed to both sides;
weights come from the JAX ``init_params`` through ``convert``.
Tolerances (float32 unless stated): atol 1e-5 / rtol 1e-4 — the same
float32 arithmetic summed in other orders by XLA and PyTorch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.ops import layers as jl
from tfmesos_tpu.train import data as jdata
from tfmesos_tpu.train import trainer as jtrainer
from tfmesos_tpu.train.trainer import make_train_step as j_make_train_step
from tfmesos_tpu_torch import convert, transformer_train
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.ops import layers as tl
from tfmesos_tpu_torch.train import data as tdata
from tfmesos_tpu_torch.train import optim, trainer

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


# -- fused head + cross entropy ----------------------------------------------


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("chunk", [7, 16, 1000])
def test_fused_ce_matches_jax(z_loss, chunk):
    """Mirrors tests/test_fused_ce.py: loss and grads of the port's fused
    op against the JAX fused op, and against the port's unfused
    cross_entropy_loss."""
    rng = np.random.RandomState(0)
    d, v = 16, 37
    x = rng.randn(3, 8, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.3).astype(np.float32)
    labels = rng.randint(0, v, (3, 8)).astype(np.int32)
    want, (dx_j, dw_j) = jax.value_and_grad(
        lambda x_, w_: jl.fused_linear_cross_entropy(
            x_, w_, jnp.asarray(labels), z_loss, chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = tl.fused_linear_cross_entropy(tx, tw, _t(labels), z_loss=z_loss,
                                        chunk=chunk)
    dx, dw = torch.autograd.grad(got, (tx, tw))
    _close(float(got.detach()), float(want))
    _close(dx, dx_j)
    _close(dw, dw_j)
    ref = tl.cross_entropy_loss(tx @ tw, _t(labels), z_loss=z_loss)
    _close(float(ref.detach()), float(want))
    assert tl._ce_chunk(24, chunk) == jl._ce_chunk(24, chunk)


def test_fused_ce_bf16_inputs_fp32_master_weight():
    """The model path: bf16 hidden states, float32 master head.  dx comes
    back bf16 and dw float32, as in JAX; values within bf16 rounding of
    JAX's: loss rtol 1e-3; dx atol 2e-3, two bf16 ulps at its scale; dw
    (|dw| up to ~0.05) atol 1e-3 — the bf16 logits and dlogits of the two
    frameworks may differ by an ulp, and dw sums 24 such products."""
    rng = np.random.RandomState(1)
    d, v = 32, 64
    x = rng.randn(4, 6, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.2).astype(np.float32)
    labels = rng.randint(0, v, (4, 6)).astype(np.int32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, (dx_j, dw_j) = jax.value_and_grad(
        lambda x_, w_: jl.fused_linear_cross_entropy(
            x_, w_, jnp.asarray(labels)), argnums=(0, 1))(xb, jnp.asarray(w))
    tx = _t(x).bfloat16().requires_grad_()
    tw = _t(w).requires_grad_()
    got = tl.fused_linear_cross_entropy(tx, tw, _t(labels))
    dx, dw = torch.autograd.grad(got, (tx, tw))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    _close(float(got.detach()), float(want), atol=0, rtol=1e-3)
    _close(dx.float(), np.asarray(dx_j.astype(jnp.float32)), atol=2e-3,
           rtol=0)
    _close(dw, dw_j, atol=1e-3, rtol=0)


# -- the transformer's loss and gradients ------------------------------------


def _tiny_pair(n_kv_heads=None, dtype="float32", **extra):
    base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                max_seq_len=64, n_kv_heads=n_kv_heads, **extra)
    jcfg = jt.TransformerConfig(dtype=getattr(jnp, dtype), **base)
    tcfg = tt.TransformerConfig(dtype=getattr(torch, dtype), **base)
    jp = jax.tree_util.tree_map(np.asarray,
                                jt.init_params(jcfg, jax.random.PRNGKey(2)))
    return jcfg, jp, tcfg


def _batch(b=2, t=64, seed=100):
    return next(tdata.token_batches(b, t, 256, seed=seed))


def _loss_and_grads_both(jcfg, jp, tcfg, batch):
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, {"tokens": jnp.asarray(
            batch["tokens"])}), has_aux=True)(jax.tree_util.tree_map(
                jnp.asarray, jp))
    tp = convert.params_from_jax(jp)
    flat = convert.flatten(tp)
    for p in flat.values():
        p.requires_grad_(True)
    tloss, tm = tt.loss_fn(tcfg, tp, {"tokens": _t(batch["tokens"])})
    tgrads = dict(zip(flat, torch.autograd.grad(tloss, list(flat.values()))))
    jflat = convert.flatten(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads)))
    return (float(jloss), float(jm["perplexity"]), jflat,
            float(tloss), float(tm["perplexity"]), tgrads)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
@pytest.mark.parametrize("fused_ce", [None, False])
def test_loss_and_grads_match_jax(n_kv_heads, fused_ce):
    """loss_fn value and every leaf's gradient against
    jax.value_and_grad(transformer.loss_fn): tiny dense config (2 layers,
    d 64, vocab 256, T 64), MHA and GQA, fused and unfused head."""
    jcfg, jp, tcfg = _tiny_pair(n_kv_heads, fused_ce=fused_ce)
    assert tt._fused_ce_mode(tcfg) == jt._fused_ce_mode(jcfg, jp, None)
    jl_, jppl, jg, tl_, tppl, tg = _loss_and_grads_both(jcfg, jp, tcfg,
                                                        _batch())
    _close(tl_, jl_)
    _close(tppl, jppl)
    assert sorted(jg) == sorted(tg)
    for k in jg:
        _close(tg[k], jg[k])


def test_loss_and_grads_match_jax_bf16():
    """The same in bf16 compute over float32 masters.  The two frameworks
    round activations to bf16 at different points (JAX's plain attention
    rounds the scores, the port's flash path keeps them float32), so the
    bound is bf16's: |Δloss| <= 2e-2, and each leaf's gradient within 5%
    of JAX's in relative L2 norm."""
    jcfg, jp, tcfg = _tiny_pair(2, dtype="bfloat16")
    jl_, _, jg, tl_, _, tg = _loss_and_grads_both(jcfg, jp, tcfg, _batch())
    assert abs(tl_ - jl_) <= 2e-2
    for k in jg:
        want, got = jg[k].float(), tg[k].float()
        rel = float((got - want).norm() / want.norm().clamp_min(1e-12))
        assert rel <= 5e-2, (k, rel)


def test_remat_and_fused_ce_mode():
    """remat's loss and grads equal the plain port step's exactly (the
    same ops, recomputed), and JAX ``remat=True``'s within the float32
    tolerances; the fused-CE mode rule is unchanged."""
    jcfg, jp, tcfg = _tiny_pair(2, remat=True)
    assert tcfg.remat and jcfg.remat
    jl_, jppl, jg, tl_, tppl, tg = _loss_and_grads_both(jcfg, jp, tcfg,
                                                        _batch())
    plain = _loss_and_grads_both(jcfg, jp, tt.TransformerConfig(
        **{**tcfg.__dict__, "remat": False}), _batch())
    assert tl_ == plain[3] and tppl == plain[4]
    assert all(torch.equal(tg[k], plain[5][k]) for k in tg)
    _close(tl_, jl_)
    _close(tppl, jppl)
    assert sorted(jg) == sorted(tg)
    for k in jg:
        _close(tg[k], jg[k])
    assert tt._fused_ce_mode(tt.TransformerConfig()) == "dense"
    assert tt._fused_ce_mode(tt.TransformerConfig(fused_ce=True)) == "dense"
    assert tt._fused_ce_mode(tt.TransformerConfig(fused_ce=False)) is None


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,start_step", [(0, 0), (100, 0), (7, 5)])
def test_token_batches_equal_jax(seed, start_step):
    got = tdata.token_batches(3, 33, 97, seed=seed, start_step=start_step)
    want = jdata.token_batches(3, 33, 97, seed=seed, start_step=start_step)
    for _ in range(3):
        a, b = next(got)["tokens"], next(want)["tokens"]
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)


def test_prefetch_yields_the_stream_as_tensors():
    stream = list(zip(range(5), tdata.token_batches(2, 8, 50, seed=1)))
    out = list(tdata.prefetch((b for _, b in stream), "cpu", depth=2))
    assert len(out) == 5
    for (_, b), t in zip(stream, out):
        assert t["tokens"].dtype == torch.int32
        assert np.array_equal(t["tokens"].numpy(), b["tokens"])


# -- optimizer ----------------------------------------------------------------


def _opt_case():
    rng = np.random.RandomState(3)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": {"c": rng.randn(5).astype(np.float32)}}
    grads = [{"a": (rng.randn(4, 3) * s).astype(np.float32),
              "b": {"c": (rng.randn(5) * s).astype(np.float32)}}
             for s in (2.0, 0.05, 1.0)]
    return params, grads


def test_schedule_matches_optax():
    for kw in [dict(init_value=0.0, peak_value=1e-2, warmup_steps=2,
                    decay_steps=6, end_value=1e-3),
               dict(init_value=3e-4, peak_value=3e-4, warmup_steps=0,
                    decay_steps=5, end_value=3e-5)]:
        want = optax.warmup_cosine_decay_schedule(**kw)
        got = optim.warmup_cosine_decay_schedule(**kw)
        for c in range(9):
            _close(got(c), float(want(c)), atol=1e-9, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    params, grads = _opt_case()
    g = grads[0]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        jax.tree_util.tree_map(jnp.asarray, g), optax.EmptyState())
    tg = [_t(g["a"]), _t(g["b"]["c"])]
    norm = optim.clip_by_global_norm(max_norm)(tg)
    _close(float(norm), float(optax.global_norm(g)))
    _close(tg[0], want["a"], atol=1e-7, rtol=1e-6)
    _close(tg[1], want["b"]["c"], atol=1e-7, rtol=1e-6)


def test_adamw_clip_warmup_cosine_match_optax():
    """Three updates of clip_by_global_norm -> adamw(warmup-cosine,
    weight_decay 0.01) against optax from the same params and grads.
    optax evaluates the schedule at count 0 first, so with a warmup from
    0 the first update moves nothing — weight decay included."""
    params, grads = _opt_case()
    sched_kw = dict(init_value=0.0, peak_value=1e-2, warmup_steps=2,
                    decay_steps=6, end_value=1e-3)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(**sched_kw), weight_decay=0.01))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = optim.adamw(optim.warmup_cosine_decay_schedule(**sched_kw),
                       weight_decay=0.01, max_norm=1.0)
    tp = convert.params_from_jax(params)
    state = topt.init(tp)
    for i, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        state = topt.update(convert.params_from_jax(g), state)
        assert state.count == i + 1
        if i == 0:
            assert torch.equal(tp["a"].detach(), _t(params["a"]))
        _close(tp["a"].detach(), jp["a"], atol=1e-7, rtol=1e-6)
        _close(tp["b"]["c"].detach(), jp["b"]["c"], atol=1e-7, rtol=1e-6)
    assert not torch.equal(tp["a"].detach(), _t(params["a"]))


# -- the train step -----------------------------------------------------------


def test_train_steps_match_jax(tmp_path):
    """Three make_train_step steps on the tiny config against JAX
    make_train_step(mesh=None), from the same .npz weights and batches;
    the params compared after."""
    jcfg, jp, tcfg = _tiny_pair(2)
    path = str(tmp_path / "w.npz")
    convert.save_npz(convert.params_from_jax(jp), path)
    tp = convert.load_npz(path)
    jp = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(
        convert.load_npz(path)))
    batches = [b["tokens"] for _, b in zip(
        range(3), tdata.token_batches(2, 64, 256, seed=100))]
    jopt = optax.adamw(1e-3, weight_decay=0.01)
    jstep = j_make_train_step(lambda p, b: jt.loss_fn(jcfg, p, b), jopt)
    jstate = jopt.init(jp)
    topt = optim.adamw(1e-3, weight_decay=0.01)
    tstep = trainer.make_train_step(lambda p, b: tt.loss_fn(tcfg, p, b),
                                    topt)
    tstate = topt.init(tp)
    for tok in batches:
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(tok)})
        tp, tstate, tm = tstep(tp, tstate, {"tokens": _t(tok)})
        _close(float(tm["loss"]), float(jm["loss"]))
    want = convert.flatten(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    got = convert.flatten(tp)
    for k in want:
        _close(got[k].detach(), want[k], atol=1e-5, rtol=1e-4)


def test_grad_accum_matches_full_batch_step():
    """grad_accum=2 gives the full-batch update (mirrors
    tests/test_models.py::test_grad_accum_matches_full_batch_step)."""
    cfg = _tiny_pair(None)[2]
    batch = {"tokens": _t(_batch(b=4)["tokens"])}
    out = []
    for accum in (1, 2):
        params = tt.init_params(cfg, torch.Generator().manual_seed(0))
        opt = optim.adamw(1e-3, weight_decay=0.01)
        step = trainer.make_train_step(lambda p, b: tt.loss_fn(cfg, p, b),
                                       opt, grad_accum=accum)
        params, _, metrics = step(params, opt.init(params), batch)
        out.append((convert.flatten(params), metrics))
    (p1, m1), (p2, m2) = out
    _close(float(m2["loss"]), float(m1["loss"]), atol=0, rtol=1e-5)
    for k in p1:
        _close(p2[k].detach(), p1[k].detach())
    with pytest.raises(ValueError, match="equal microbatches"):
        trainer.make_train_step(lambda p, b: tt.loss_fn(cfg, p, b), opt,
                                grad_accum=3)(params, opt.init(params),
                                              batch)


def _tiny_step(cfg, seed=0, **kw):
    params = tt.init_params(cfg, torch.Generator().manual_seed(seed))
    opt = optim.adamw(1e-3, weight_decay=0.01)
    step = trainer.make_train_step(lambda p, b: tt.loss_fn(cfg, p, b), opt,
                                   **kw)
    return params, opt.init(params), step


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_scanned_steps_match_sequential(grad_accum):
    """steps_per_call=K gives params bit-identical to K sequential calls
    on the same batches, with grad_accum too (mirrors
    tests/test_models.py::test_scanned_steps_match_sequential and the
    steps_per_call x grad_accum composition of tests/test_fused_ce.py)."""
    cfg = _tiny_pair(None)[2]
    k = 3
    batches = [_t(b["tokens"]) for _, b in zip(
        range(k), tdata.token_batches(4, 16, 256, seed=9))]
    p_seq, o_seq, seq = _tiny_step(cfg, grad_accum=grad_accum)
    for tok in batches:
        p_seq, o_seq, m_seq = seq(p_seq, o_seq, {"tokens": tok})
    p_scan, o_scan, scan = _tiny_step(cfg, steps_per_call=k,
                                      grad_accum=grad_accum)
    p_scan, o_scan, m_scan = scan(p_scan, o_scan,
                                  {"tokens": torch.stack(batches)})
    assert o_scan.count == o_seq.count == k
    assert torch.equal(m_scan["loss"], m_seq["loss"])
    a, b = convert.flatten(p_seq), convert.flatten(p_scan)
    assert all(torch.equal(a[n], b[n]) for n in a)
    with pytest.raises(ValueError, match="steps_per_call"):
        scan(p_scan, o_scan, {"tokens": batches[0]})


def test_scan_unroll_matches_rolled():
    """scan_unroll changes no arithmetic (bit-equal params and loss), and
    is validated as the JAX step validates it (mirrors
    tests/test_models.py::test_scan_unroll_matches_rolled)."""
    cfg = _tiny_pair(None)[2]
    tok = torch.stack([_t(b["tokens"]) for _, b in zip(
        range(4), tdata.token_batches(2, 16, 256, seed=5))])
    outs = []
    for unroll in (1, 4):
        params, state, step = _tiny_step(cfg, steps_per_call=4,
                                         scan_unroll=unroll)
        params, _, metrics = step(params, state, {"tokens": tok})
        outs.append((convert.flatten(params), float(metrics["loss"])))
    assert all(torch.equal(outs[0][0][n], outs[1][0][n]) for n in outs[0][0])
    assert outs[0][1] == outs[1][1]
    jopt = optax.adamw(1e-3)
    for kw in (dict(steps_per_call=4, scan_unroll=3),
               dict(steps_per_call=4, scan_unroll=0),
               dict(steps_per_call=1, scan_unroll=2)):
        with pytest.raises(ValueError, match="divide") as want:
            j_make_train_step(lambda p, b: (0.0, {}), jopt, **kw)
        with pytest.raises(ValueError, match="divide") as got:
            trainer.make_train_step(lambda p, b: (0.0, {}),
                                    optim.adamw(1e-3), **kw)
        assert str(got.value) == str(want.value)


def test_train_loop_metrics_lines_match_jax(tmp_path):
    """TrainLoop's metrics_path lines against the JAX TrainLoop's on the
    same weights and batches: the same steps and keys, the metrics
    within the float32 tolerances; the result dict has the same keys."""
    jcfg, jp, tcfg = _tiny_pair(2)
    batches = [b for _, b in zip(range(5), tdata.token_batches(
        2, 32, 256, seed=100))]
    jopt = optax.adamw(1e-3, weight_decay=0.01)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jloop = jtrainer.TrainLoop(
        step_fn=j_make_train_step(lambda p, b: jt.loss_fn(jcfg, p, b), jopt),
        state=jtrainer.TrainState(jparams, jopt.init(jparams), step=3),
        log_every=2, metrics_path=str(tmp_path / "jax.jsonl"))
    jres = jloop.run(iter([{"tokens": jnp.asarray(b["tokens"])}
                           for b in batches]), 5)
    tparams = convert.params_from_jax(jp)
    topt = optim.adamw(1e-3, weight_decay=0.01)
    tloop = trainer.TrainLoop(
        step_fn=trainer.make_train_step(
            lambda p, b: tt.loss_fn(tcfg, p, b), topt),
        state=trainer.TrainState(tparams, topt.init(tparams), step=3),
        log_every=2, metrics_path=str(tmp_path / "port.jsonl"))
    seen = []
    tres = tloop.run(iter([{"tokens": _t(b["tokens"])} for b in batches]),
                     5, on_metrics=lambda i, m: seen.append(i))
    import json

    want = [json.loads(x) for x in open(tmp_path / "jax.jsonl")]
    got = [json.loads(x) for x in open(tmp_path / "port.jsonl")]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [5, 7, 8]
    assert seen == [2, 4, 5]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("loss", "perplexity"):
            _close(g[k], w[k])
    assert sorted(tres) == sorted(jres)
    assert tres["start_step"] == 3 and tres["final_step"] == 8
    assert tres["restores"] == 0 and tres["resumed_step"] == 0
    assert tloop.state.step == jloop.state.step == 8
    assert tres["steps_per_sec_per_chip"] == tres["steps_per_sec"]
    _close(tres["final_metrics"]["loss"], jres["final_metrics"]["loss"])


def _token_file(tmp_path, vocab=256, n=20000):
    path = str(tmp_path / "tokens.bin")
    stream = tdata.token_batches(4, 999, vocab, seed=3)
    toks = np.concatenate([next(stream)["tokens"].ravel()
                           for _ in range(-(-n // 4000))])[:n]
    tdata.TokenFileDataset.write(path, toks)
    return path


def _train_main(*argv):
    return transformer_train.main(["--tiny", "--device", "cpu",
                                   "--batch_size", "2", "--seq_len", "32",
                                   *argv])


def test_transformer_train_data_ckpt_resume(tmp_path, capsys):
    """--data --ckpt-dir on the CPU: 8 steps straight and 4 + a resumed
    4 save bit-identical step-8 checkpoints (params, moments, count: the
    stream restarted at the resumed step); a third call has nothing to
    do; --ckpt-every < 1 is refused, as is a file with ids >= vocab."""
    from tfmesos_tpu_torch.train.checkpoint import STATE_FILE

    data = _token_file(tmp_path)
    straight, split = str(tmp_path / "a"), str(tmp_path / "b")
    assert _train_main("--data", data, "--ckpt-dir", straight, "--steps",
                       "8", "--ckpt-every", "3") == 0
    assert _train_main("--data", data, "--ckpt-dir", split, "--steps", "4",
                       "--ckpt-every", "3") == 0
    capsys.readouterr()
    assert _train_main("--data", data, "--ckpt-dir", split, "--steps", "8",
                       "--ckpt-every", "3") == 0
    assert "resumed from step 4" in capsys.readouterr().out
    for d, steps in ((straight, [3, 6, 8]), (split, [3, 4, 6, 8])):
        have = sorted(int(n.split("_")[1]) for n in os.listdir(d))
        assert have == steps[-3:]
    a = torch.load(os.path.join(straight, "step_8", STATE_FILE),
                   weights_only=True)
    b = torch.load(os.path.join(split, "step_8", STATE_FILE),
                   weights_only=True)
    assert sorted(a) == sorted(b) and a["1/count"] == b["1/count"] == 8
    assert all(torch.equal(a[k], b[k]) for k in a if k != "1/count")
    assert _train_main("--data", data, "--ckpt-dir", split, "--steps",
                       "8") == 0
    out = capsys.readouterr().out
    assert "resumed from step 8" in out
    assert "already trained to step 8 >= --steps 8; nothing to do" in out
    with pytest.raises(SystemExit, match="--ckpt-every must be >= 1"):
        _train_main("--ckpt-dir", split, "--ckpt-every", "0")
    bad = str(tmp_path / "bad.bin")
    tdata.TokenFileDataset.write(bad, np.arange(300))
    with pytest.raises(SystemExit, match="token id 299 >= model vocab 256"):
        _train_main("--data", bad, "--steps", "1")


def test_eval_step_and_evaluate():
    cfg = _tiny_pair(None)[2]
    params = tt.init_params(cfg, torch.Generator().manual_seed(1))
    batches = [{"tokens": _t(b["tokens"])} for _, b in zip(
        range(2), tdata.token_batches(2, 32, 256, seed=4))]
    ev = trainer.make_eval_step(lambda p, b: tt.loss_fn(cfg, p, b))
    got = trainer.evaluate(ev, params, iter(batches), 2)
    want = np.mean([float(tt.loss_fn(cfg, params, b)[0]) for b in batches])
    _close(got["loss"], want, atol=1e-6, rtol=1e-6)
    assert set(got) == {"loss", "perplexity"}


# -- the entry point and weights ----------------------------------------------


def test_transformer_train_tiny_cpu(capsys):
    assert transformer_train.main(["--tiny", "--device", "cpu", "--steps",
                                   "3"]) == 0
    out = capsys.readouterr().out
    assert "Training elapsed time" in out and "tokens/sec" in out


def test_transformer_train_refuses_later_slice_flags():
    """The JAX example's MoE and pipeline flags are not flags here, and a
    later model axis of ``--mesh`` is refused by name (the data axes and
    tp are ported: a tp mesh wants its ranks)."""
    for argv in (["--moe", "4"], ["--pp-schedule", "1f1b"]):
        with pytest.raises(SystemExit):
            transformer_train.parse_args(argv)
    assert transformer_train.parse_args(["--mesh", "dp=2"]).mesh == "dp=2"
    with pytest.raises(SystemExit, match=r"mesh axis pp \(ROADMAP A\.10\)"):
        transformer_train.main(["--tiny", "--device", "cpu", "--mesh",
                                "dp=1,pp=2"])
    with pytest.raises(SystemExit, match=r"wants 2 ranks, have 1"):
        transformer_train.main(["--tiny", "--device", "cpu", "--mesh",
                                "dp=1,tp=2"])


def test_params_to_numpy_round_trip():
    cfg = _tiny_pair(2)[2]
    params = tt.init_params(cfg, torch.Generator().manual_seed(5))
    params["norm_f"] = params["norm_f"].bfloat16()
    back = convert.params_from_jax(convert.params_to_numpy(params))
    a, b = convert.flatten(params), convert.flatten(back)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k].float(), b[k].float()) for k in a)
