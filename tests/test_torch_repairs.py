"""Two faults of the port, repaired: the kernel build on a read-only install
(it builds into the per-user cache, as the JAX package's native loader
does), and the trainer's refusal of the training settings it cannot honour
(remat, a device mesh); device-side mels, refused until the device-mel
pipeline was ported, are now taken."""

import os
import stat
import sys

import numpy as np
import pytest

from _torch_port import CMUDICT, TINY_SET, text_batch, write_corpus
from gradtts_tpu_torch.cli.train import main as train_main
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.ops import _build
from gradtts_tpu_torch.train.loop import check_ported, train


# ---- the build directory ---------------------------------------------------


def _fake_nvcc(tmp_path):
    """A stand-in for nvcc that writes the file named after -o."""
    path = tmp_path / 'bin' / 'nvcc'
    path.parent.mkdir()
    path.write_text(f'#!{sys.executable}\n'
                    'import sys\n'
                    'out = sys.argv[sys.argv.index("-o") + 1]\n'
                    'open(out, "wb").write(b"not a library")\n')
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def _checkout_read_only(monkeypatch):
    """os.access says no to everything beside the package."""
    parent = os.path.dirname(_build.PACKAGE_DIR)
    real = os.access
    monkeypatch.setattr(_build.os, 'access', lambda p, mode, **kw: (
        False if os.path.abspath(p).startswith(parent) else real(p, mode,
                                                                 **kw)))


def _tree(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs) if os.path.isdir(root) else []


def test_writable_checkout_builds_beside_the_package(monkeypatch, tmp_path):
    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path / 'cache'))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'co' / 'build'))
    assert _build.build_dir() == str(tmp_path / 'co' / 'build')
    assert os.path.dirname(_build.library_path('mas')) == _build.BUILD_DIR


def test_read_only_install_builds_into_the_user_cache(monkeypatch,
                                                      tmp_path):
    cache = tmp_path / 'cache'
    monkeypatch.setenv('XDG_CACHE_HOME', str(cache))
    _checkout_read_only(monkeypatch)
    monkeypatch.setattr(_build, '_nvcc', lambda: _fake_nvcc(tmp_path))
    path = _build.library_path('mas')
    assert os.path.dirname(path) == str(cache / 'gradtts_tpu_torch')
    # the name keeps the hash of the sources and flags
    assert os.path.basename(path).startswith('mas-')
    beside = os.path.dirname(_build.PACKAGE_DIR)
    before = _tree(os.path.join(beside, 'build'))
    report = _build.build(['mas'])
    assert set(report) == {'mas'}
    assert os.path.exists(path)
    assert os.listdir(cache / 'gradtts_tpu_torch') == [
        os.path.basename(path)]
    assert _tree(os.path.join(beside, 'build')) == before
    assert _build.build(['mas']) == {}        # built already: reused


def test_read_only_install_without_nvcc_creates_nothing(monkeypatch,
                                                        tmp_path):
    cache = tmp_path / 'cache'
    monkeypatch.setenv('XDG_CACHE_HOME', str(cache))
    _checkout_read_only(monkeypatch)

    def no_nvcc():
        raise RuntimeError('nvcc not found')

    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build(['groupnorm_mish'])
    assert not cache.exists()


# ---- the trainer's refusals --------------------------------------------------

REFUSED = [('train.mesh_data', 2), ('train.mesh_data', 0),
           ('train.mesh_model', 2)]


def _tiny_cfg(**extra):
    overrides = dict({'encoder.n_enc_channels': 32,
                      'encoder.filter_channels': 64,
                      'encoder.filter_channels_dp': 16,
                      'encoder.n_enc_layers': 2, 'decoder.dec_dim': 16,
                      'data.x_buckets': (64,), 'data.y_buckets': (64,),
                      'train.batch_size': 2,
                      'train.use_bf16_compute': False}, **extra)
    return get_config('ljspeech', **overrides)


def _loader():
    x, xl = text_batch(31, (12, 7))
    yl = np.array([40, 24], np.int32)
    y = np.random.default_rng(31).standard_normal((2, 40, 80)).astype(
        np.float32) * (np.arange(40)[None, :, None] < yl[:, None, None])
    return [{'x': x, 'x_lengths': xl, 'y': y, 'y_lengths': yl}]


@pytest.mark.parametrize('key,value', REFUSED)
def test_train_refuses_unported_settings(key, value, tmp_path):
    field = key.split('.')[1]
    with pytest.raises(ValueError, match=field):
        train(_tiny_cfg(**{key: value}), max_steps=1,
              log_dir=str(tmp_path), loader=_loader(), device='cpu')
    assert not (tmp_path / 'ckpt').exists()


@pytest.mark.parametrize('key,value', REFUSED)
def test_train_cli_refuses_unported_settings(key, value, tmp_path):
    with pytest.raises(ValueError, match=key.split('.')[1]):
        train_main(['--cpu', '--max-steps', '1', '--log-dir', str(tmp_path),
                    '--set', *TINY_SET, f'data.cmudict_path={CMUDICT}',
                    f'{key}={value}'])


@pytest.mark.parametrize('mesh_data,device_mel', [(-1, None), (1, False),
                                                  (1, None), (-1, False)])
def test_one_device_and_host_mels_are_accepted(mesh_data, device_mel):
    check_ported(_tiny_cfg(**{'train.mesh_data': mesh_data,
                              'train.device_mel': device_mel,
                              'train.mesh_model': 1,
                              'train.remat_estimator': False}))


def test_train_runs_with_one_device_settings_spelled_out(tmp_path):
    cfg = _tiny_cfg(**{'train.mesh_data': 1, 'train.device_mel': False,
                       'train.mesh_model': 1})
    res = train(cfg, max_steps=1, log_dir=str(tmp_path), loader=_loader(),
                device='cpu')
    assert res.step == 1


# ---- device-side mels, once refused, now taken ------------------------------


def test_train_takes_device_mels(tmp_path, caplog):
    cfg = _tiny_cfg(**{'train.device_mel': True,
                       'data.cmudict_path': CMUDICT,
                       'data.train_filelist_path': write_corpus(tmp_path, 4)})
    with caplog.at_level('INFO', logger='gradtts_tpu_torch.train'):
        res = train(cfg, max_steps=1, log_dir=str(tmp_path / 'logs'),
                    device='cpu', synthesis_every_epoch=False)
    assert res.step == 1
    assert 'input pipeline: device mels' in caplog.text
    assert (tmp_path / 'logs' / 'ckpt' / 'step_00000001.pt').exists()


def test_train_cli_takes_device_mels(tmp_path, caplog):
    log_dir = tmp_path / 'logs'
    with caplog.at_level('INFO', logger='gradtts_tpu_torch.train'):
        res = train_main([
            '--cpu', '--max-steps', '1', '--log-dir', str(log_dir),
            '--batch-size', '2', '--no-previews', '--set', *TINY_SET,
            f'data.cmudict_path={CMUDICT}',
            f'data.train_filelist_path={write_corpus(tmp_path, 4)}',
            'data.x_buckets=(64,)', 'data.y_buckets=(64,)',
            'train.use_bf16_compute=False', 'train.device_mel=True'])
    assert res.step == 1
    assert 'input pipeline: device mels' in caplog.text
    assert 'epoch 0:' in (log_dir / 'train.log').read_text()
