"""The port's profiling utilities (``utils/profiling.py``) against the JAX
package's: ``Throughput`` gives JAX's ``summary()`` for the same calls and
clock, ``time_jitted`` JAX's keys and the last output (after
tests/test_prepare.py:97-124), and ``trace`` writes a non-empty trace on
the CPU whose events the caller reads."""

import itertools
import json
import os

import pytest
import torch

import gradtts_tpu.utils.profiling as jprof
import gradtts_tpu_torch.utils.profiling as tprof


@pytest.mark.parametrize('sr,hop,calls', [
    (16000, 256, [(1600, 2)]),
    (22050, 256, [(768, 8), (512, 1), (0, 3)]),
    (24000, 300, [])])
def test_throughput_summary_matches_jax(monkeypatch, sr, hop, calls):
    """The same start/add/stop calls, with ``time.perf_counter`` giving
    both modules the same ticks, give the same summary (rtf and rates 0
    where nothing was added)."""
    summaries = []
    for mod in (jprof, tprof):
        ticks = itertools.count(1.0, 0.25)
        monkeypatch.setattr(mod.time, 'perf_counter', lambda: next(ticks))
        tp = mod.Throughput(sample_rate=sr, hop_length=hop)
        for frames, items in calls:
            tp.start()
            tp.add(frames=frames, items=items)
            tp.stop()
        summaries.append(tp.summary())
    assert summaries[1] == summaries[0]
    assert set(summaries[1]) == {'items', 'audio_seconds', 'elapsed_s',
                                 'audio_sec_per_sec', 'rtf'}


def test_throughput_counts_as_the_jax_test_does():
    tp = tprof.Throughput(sample_rate=16000, hop_length=256)
    tp.start()
    tp.add(frames=1600, items=2)   # 1600*256/16000 = 25.6 audio-sec
    tp.stop()
    s = tp.summary()
    assert s['audio_seconds'] == pytest.approx(25.6)
    assert s['items'] == 2
    assert s['audio_sec_per_sec'] > 0
    assert s['rtf'] == pytest.approx(s['elapsed_s'] / 25.6)
    with pytest.raises(RuntimeError):
        tp.stop()                  # not started


def test_time_jitted_keys_and_last_output():
    calls = []

    def f(x, scale=1.0):
        calls.append(1)
        return {'sum': (x @ x).sum() * scale, 'parts': [x[0], (x[1],)]}

    x = torch.ones((64, 64))
    stats = tprof.time_jitted(f, x, iters=3, warmup=1, scale=2.0)
    assert set(stats) == {'median_s', 'mean_s', 'min_s', 'iters',
                          'last_output'}
    assert stats['iters'] == 3 and len(calls) == 4
    assert 0 < stats['min_s'] <= stats['median_s']
    assert float(stats['last_output']['sum']) == 2.0 * 64 ** 3
    # warmup 0 still warms up once, as JAX's does
    tprof.time_jitted(f, x, iters=1, warmup=0)
    assert len(calls) == 6


def test_trace_writes_a_trace_on_the_cpu(tmp_path, caplog):
    x = torch.randn(32, 32)
    with caplog.at_level('INFO', logger='gradtts_tpu_torch.profiling'):
        with tprof.trace(str(tmp_path / 'tb'),
                         create_perfetto_link=True) as prof:
            torch.mm(x, x).sum()
    files = os.listdir(tmp_path / 'tb')
    assert len(files) == 1 and files[0].endswith('.pt.trace.json')
    path = tmp_path / 'tb' / files[0]
    assert path.stat().st_size > 0
    assert 'traceEvents' in json.loads(path.read_text())
    assert any(e.name == 'aten::mm' for e in prof.events())
    assert str(path) in caplog.text
