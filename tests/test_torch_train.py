"""The training slice of the port against the JAX package on a tiny seeded
model: ``compute_loss`` and every parameter's grad, the clipped Adam step,
the repairs that training needs (the duration predictor's detached input,
dropout, f32 parameters under bf16 compute), resume, and the training and
inference CLIs on a synthetic corpus."""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (CMUDICT, TINY_SET, jax_model_and_params,
                         seeded_tree, text_batch, torch_model, write_corpus)
from gradtts_tpu.models.tts import compute_loss as jax_compute_loss
from gradtts_tpu.train.state import _subtree_clip
from gradtts_tpu_torch.cli.inference import main as inference_main
from gradtts_tpu_torch.cli.train import main as train_main
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.layers import dropout
from gradtts_tpu_torch.models.tts import compute_loss, set_compute_dtype
from gradtts_tpu_torch.train.loop import batch_to, train
from gradtts_tpu_torch.train.state import (make_optimizer, subtree_clip,
                                           train_step)
from gradtts_tpu_torch.utils.convert import flax_params_to_state_dict

OUT_SIZE = 32
TRUNK = ('encoder.emb.', 'encoder.prenet.', 'encoder.encoder.')


@pytest.fixture(scope='module')
def tiny():
    return jax_model_and_params(seed=21)


def _batch(seed=22):
    """Three items: two longer than the crop (each cropped at its own
    offset), one shorter (not cropped)."""
    x, xl = text_batch(seed, (16, 11, 6))
    rng = np.random.default_rng(seed)
    yl = np.array([64, 50, 20], np.int32)
    y = rng.standard_normal((3, 64, 80)).astype(np.float32)
    y *= (np.arange(64)[None, :, None] < yl[:, None, None])
    return x, xl, y, yl


def _jax_draws(key, y_lengths, n_feats=80):
    """The crop offset, t and z that JAX ``compute_loss`` draws from ``key``
    (models/tts.py:266-269, then models/diffusion.py:777-780)."""
    key, off_key = jax.random.split(key)
    max_offset = np.maximum(y_lengths - OUT_SIZE, 0)
    rand = np.asarray(jax.random.randint(off_key, (len(y_lengths),), 0,
                                         1 << 30))
    offset = np.where(max_offset > 0, rand % np.maximum(max_offset, 1), 0)
    _, diff_key = jax.random.split(key)
    key_t, key_z = jax.random.split(diff_key)
    t = jax.random.uniform(key_t, (len(y_lengths),), dtype=jnp.float32)
    z = jax.random.normal(key_z, (len(y_lengths), OUT_SIZE, n_feats),
                          dtype=jnp.float32)
    return offset, np.asarray(t), np.asarray(z)


def _jax_loss_and_grads(jmodel, params, key, batch, fused):
    x, xl, y, yl = map(jnp.asarray, batch)

    def loss_fn(p):
        res = jax_compute_loss(jmodel, p, key, x, xl, y, yl,
                               out_size=OUT_SIZE, train=False,
                               dropout_key=None, fused_attention=fused)
        return res.dur_loss + res.prior_loss + res.diff_loss, res

    (_, res), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return res, grads


def _port_loss(model, batch, draws):
    x, xl, y, yl = batch
    offset, t, z = (a.copy() for a in draws)
    res = compute_loss(model, torch.from_numpy(x).long(),
                       torch.from_numpy(xl).long(), torch.from_numpy(y),
                       torch.from_numpy(yl).long(), out_size=OUT_SIZE,
                       offset=torch.from_numpy(offset).long(),
                       t=torch.from_numpy(t), z=torch.from_numpy(z))
    return res


@pytest.mark.parametrize('fused', [True, False])
def test_compute_loss_and_grads_match_jax(tiny, fused):
    jmodel, params = tiny
    batch = _batch()
    key = jax.random.PRNGKey(3)
    want, jgrads = _jax_loss_and_grads(jmodel, params, key, batch, fused)
    model = torch_model(params)
    got = _port_loss(model, batch, _jax_draws(key, batch[3]))
    (got.dur_loss + got.prior_loss + got.diff_loss).backward()

    np.testing.assert_array_equal(got.attn.numpy(), np.asarray(want.attn))
    # f32 on both sides; the U-Net sums in other orders (~1e-6 relative
    # per call), and the losses are means of squares of its output
    for name in ('dur_loss', 'prior_loss', 'diff_loss'):
        np.testing.assert_allclose(getattr(got, name).item(),
                                   float(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)
    # every grad within 2e-4 of its tensor's largest value: the backward of
    # the U-Net (convs, norms, attention sweeps) sums over many more terms
    # than the forward, in other orders (measured: up to 9e-5). The key
    # biases of the encoder's attention have an exact grad of zero (they
    # shift every score of a row alike, which the softmax cancels), so
    # both sides hold rounding noise there: each below 1e-8 of the largest
    # grad of the model
    want_grads = flax_params_to_state_dict(jax.device_get(jgrads))
    params_t = dict(model.named_parameters())
    assert set(want_grads) == set(params_t)
    largest = max(float(w.abs().max()) for w in want_grads.values())
    for name, w in want_grads.items():
        g = params_t[name].grad
        g = torch.zeros_like(w) if g is None else g
        if name.endswith('conv_k.bias'):
            assert float(g.abs().max()) < 1e-8 * largest, name
            assert float(w.abs().max()) < 1e-8 * largest, name
            continue
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=2e-4 * float(w.abs().max()),
                                   msg=name)


def test_clipped_adam_matches_optax(tiny):
    _, params = tiny
    model = torch_model(params).train()
    optimizer = make_optimizer(model.parameters())
    inner = params['params']
    tx = optax.adam(1e-4)
    opt_state = tx.init(inner)

    @jax.jit
    def jax_step(grads, opt_state, inner):
        clipped, norms = _subtree_clip(grads, 1.0)
        updates, opt_state = tx.update(clipped, opt_state, inner)
        return optax.apply_updates(inner, updates), opt_state, norms

    for step, scale in enumerate((50.0, 0.01)):
        # the first step's encoder and U-Net norms are far above the clip
        # of 1, the second's below it
        grads = jax.tree_util.tree_map(lambda g: g * scale,
                                       seeded_tree(inner, 30 + step))
        sd = flax_params_to_state_dict(grads)
        for name, p in model.named_parameters():
            p.grad = sd[name].clone()
        enc_norm, dec_norm = subtree_clip(model, 1.0)
        optimizer.step()
        inner, opt_state, (j_enc, j_dec) = jax_step(grads, opt_state, inner)
        np.testing.assert_allclose([float(enc_norm), float(dec_norm)],
                                   [float(j_enc), float(j_dec)], rtol=1e-6)
    want = flax_params_to_state_dict(jax.device_get(inner))
    # Adam's update is lr * m_hat / (sqrt(v_hat) + eps): both libraries
    # compute it in f32 with the bias corrections in another order, a few
    # ulps of a 1e-4 step on parameters of O(0.1-1)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=1e-6,
                                   atol=1e-8, msg=name)


def test_duration_loss_does_not_reach_the_trunk(tiny):
    jmodel, params = tiny
    x, xl, y, yl = _batch(23)

    def dur(p):
        return jax_compute_loss(jmodel, p, jax.random.PRNGKey(0), *map(
            jnp.asarray, (x, xl, y, yl)), train=False).dur_loss

    want = flax_params_to_state_dict(jax.device_get(jax.jit(jax.grad(dur))(
        params)))
    model = torch_model(params)
    res = compute_loss(model, torch.from_numpy(x).long(),
                       torch.from_numpy(xl).long(), torch.from_numpy(y),
                       torch.from_numpy(yl).long())
    res.dur_loss.backward()
    for name, p in model.named_parameters():
        if name.startswith(TRUNK):
            assert float(want[name].abs().max()) == 0.0, name
            assert p.grad is None or float(p.grad.abs().max()) == 0.0, name
        elif name.startswith('encoder.proj_w.'):
            assert p.grad is not None and float(p.grad.abs().max()) > 0, name


def test_dropout_semantics():
    x = torch.ones(200_000)
    assert dropout(x, 0.1, False, None) is x              # identity in eval
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    y = dropout(x, 0.1, True, gen)
    kept = y != 0
    # 200k Bernoulli(0.9) draws: the kept fraction's std is 6.7e-4
    assert abs(float(kept.float().mean()) - 0.9) < 5e-3
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    gen.set_state(state)
    assert torch.equal(dropout(x, 0.1, True, gen), y)     # same draw
    assert not torch.equal(dropout(x, 0.1, True, gen), y)
    with pytest.raises(ValueError):
        dropout(x, 0.1, True, None)


def test_encoder_dropout_sites(tiny):
    _, params = tiny
    model = torch_model(params)
    enc = model.encoder
    assert enc.prenet.p_dropout == 0.5
    assert enc.proj_w.p_dropout == enc.encoder.p_dropout == 0.1
    assert all(a.p_dropout == f.p_dropout == 0.1 for a, f in zip(
        enc.encoder.attn_layers, enc.encoder.ffn_layers))
    x, xl = (torch.from_numpy(a).long() for a in text_batch(24, (16, 9)))

    def encode(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model.encode(x, xl, gen)[0]

    eval_out = encode(None)
    assert torch.equal(encode(1), eval_out)   # eval(): the generator is unused
    model.train()
    a, b, c = encode(1), encode(1), encode(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, eval_out)


def test_bf16_step_keeps_f32_params_and_moves_them(tiny):
    _, params = tiny
    model = set_compute_dtype(torch_model(params).train(), torch.bfloat16)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    optimizer = make_optimizer(model.parameters())
    x, xl, y, yl = _batch(25)
    batch = batch_to({'x': x, 'x_lengths': xl, 'y': y, 'y_lengths': yl},
                     'cpu')
    metrics = train_step(model, optimizer, batch, OUT_SIZE, 1.0,
                         torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        for s in optimizer.state[p].values():
            assert not torch.is_floating_point(s) or s.dtype == torch.float32
        if p.grad is not None and float(p.grad.abs().max()) > 0:
            assert not torch.equal(p.detach(), before[name]), name


def _tiny_cfg(tmp_path, **extra):
    overrides = {k: eval(v) for k, v in (s.split('=') for s in TINY_SET)}
    overrides.update({
        'data.train_filelist_path': write_corpus(tmp_path, n_items=4),
        'data.cmudict_path': CMUDICT, 'data.x_buckets': (64,),
        'data.y_buckets': (64,), 'train.batch_size': 2,
        'train.use_bf16_compute': False, 'train.seed': 4}, **extra)
    return get_config('ljspeech', **overrides)


def test_resume_continues_exactly(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    x, xl, y, yl = _batch(26)
    loader = [{'x': x, 'x_lengths': xl, 'y': y, 'y_lengths': yl}]
    straight = train(cfg, n_epochs=2, log_dir=str(tmp_path / 'a'),
                     loader=loader, device='cpu')
    first = train(cfg, n_epochs=1, log_dir=str(tmp_path / 'b'),
                  loader=loader, device='cpu')
    assert first.step == 1
    resumed = train(cfg, n_epochs=1, log_dir=str(tmp_path / 'b'),
                    loader=loader, device='cpu')
    assert straight.step == resumed.step == 2
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())
    assert sorted(os.listdir(tmp_path / 'b' / 'ckpt')) == [
        'step_00000001.pt', 'step_00000002.pt']


def test_train_cli_resumes_and_inference_reads_its_checkpoint(tmp_path,
                                                              capsys):
    log_dir = tmp_path / 'logs'
    args = ['--cpu', '--max-steps', '1', '--log-dir', str(log_dir),
            '--batch-size', '2', '--no-previews', '--set', *TINY_SET,
            f'data.train_filelist_path={write_corpus(tmp_path, 4)}',
            f'data.cmudict_path={CMUDICT}', 'data.x_buckets=(64,)',
            'data.y_buckets=(64,)', 'train.use_bf16_compute=False']
    assert train_main(args).step == 1
    assert train_main(args).step == 2                     # resumed
    ckpt = log_dir / 'ckpt' / 'step_00000002.pt'
    assert ckpt.exists()
    assert 'epoch 0:' in (log_dir / 'train.log').read_text()
    texts = tmp_path / 'texts.txt'
    texts.write_text('Hello world.\n')
    inference_main(['-f', str(texts), '-c', str(ckpt), '-o',
                    str(tmp_path / 'out'), '-t', '2', '--cpu', '--set',
                    *TINY_SET, f'data.cmudict_path={CMUDICT}'])
    mel = np.load(tmp_path / 'out' / 'mel_0.npy')
    assert mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all()


@pytest.mark.skipif(torch.cuda.is_available(), reason='a GPU is present')
def test_train_cli_without_cpu_flag_raises_without_gpu(tmp_path):
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_main(['--log-dir', str(tmp_path)])
