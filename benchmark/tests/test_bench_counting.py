"""The frozen arithmetic against hand-worked shapes (CPU)."""

import pytest
import torch

from benchmark import counting, drives, run
from benchmark.reference import gradtts as ref


def test_peaks():
    assert counting.HBM_BPS == 3.35e12
    assert counting.PEAK_FLOPS == {'bfloat16': 989e12, 'float32': 67e12}


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert counting.bound_s(3.35e12, 1.0, 67e12) == pytest.approx(1.0)
    assert counting.bound_s(1.0, 989e12, 989e12) == pytest.approx(1.0)


def test_kernel_work_by_hand():
    # K1 on [2, 4, 8, 16] bf16: elems 1024; bytes 2 * 1024 * 2 + 2 * 8 * 2
    nbytes, flops, peak = counting.kernel_work('K1', 2, 4, 8, 16, 'bfloat16')
    assert (nbytes, flops, peak) == (4128, 13 * 1024, 67e12)
    # K3 on [1, 2, 2, 64] f32: N 4, elems 256, H 128
    nbytes, flops, peak = counting.kernel_work('K3', 1, 2, 2, 64, 'float32')
    assert nbytes == 2 * 256 * 4 + 64 * 128 * 4 + 128 * 64 * 4 + 64 * 4
    assert flops == 4 * (4 * 64 * 128 + 64)
    assert peak == 67e12
    assert counting.mas_work(2, 3, 5, 20) == (3 * 30 * 4, 80, 67e12)


def test_unet_levels_count_every_block_and_attention():
    levels = counting.unet_levels(80, 768, 64)
    assert sum(b for _, b, _ in levels) == 25
    assert sum(a for _, _, a in levels) == 6
    assert levels[2][0] == (20, 192, 256)


def test_flops_of_a_convolution_by_hand():
    conv = torch.nn.Conv2d(8, 16, 3, padding=1).to('meta')
    x = torch.zeros((2, 8, 10, 12), device='meta')
    counts = counting._flops(lambda: conv(x))
    assert sum(counts.values()) == 2 * (2 * 16 * 10 * 12) * (8 * 9)


def test_jvp_counts_a_weight_product_twice():
    cfg = dict(n_feats=80, dec_dim=16, pe_scale=1000.0, n_spks=1,
               spk_emb_dim=64, n_vocab=149, n_enc_channels=32,
               filter_channels=64, filter_channels_dp=16, n_heads=2,
               n_enc_layers=2, enc_kernel=3, window_size=4,
               enc_dropout=0.1, beta_min=0.05, beta_max=20.0)
    m = counting.meta_model(lambda: ref.GradTTS(cfg))
    fwd = counting.unet_flops(m, 2, 64)
    jvp = counting.unet_flops(m, 2, 64, 'jvp')
    assert 2 * fwd < jvp < 3 * fwd
    assert counting.unet_flops(m, 2, 64, 'train') == pytest.approx(
        3 * fwd, rel=0.05)


def test_conv3x3_work_by_hand():
    # n-best's 64 -> 64 top level, B 50 x 80 x 512: 18 B F T C_in C_out
    nbytes, flops, peak = counting.conv3x3_work(50, 80, 512, 64, 64)
    assert flops == 18 * 50 * 80 * 512 * 64 * 64
    assert flops / 1e9 == pytest.approx(151.0, abs=0.05)
    assert nbytes == 4 * (50 * 80 * 512 * 128 + 50 * 512 + 9 * 64 * 64 + 64)
    assert peak == 67e12
    assert 1e3 * counting.bound_s(nbytes, flops, peak) == pytest.approx(
        2.254, abs=5e-4)
    assert counting.KERNEL_FAMILIES['conv3x3'] == ('conv3x3_kernel',
                                                   'conv3x3_small_kernel')


@pytest.mark.parametrize('n_spks', [1, 675])
def test_unet_blocks_are_the_programs(n_spks):
    """The yardstick's list, written from dec_dim and the speakers, against
    the program's own table of its Blocks."""
    from gradtts_tpu_torch.models.diffusion import GradLogPEstimator2d
    program = GradLogPEstimator2d(64, n_spks=n_spks,
                                  spk_emb_dim=128).block_widths()
    assert counting.unet_blocks(64, n_spks) == program
    assert len(program) == 25 and program[0][0] == (3 if n_spks > 1 else 2)


@pytest.mark.parametrize('B, T, smoke_ms', [(50, 512, 41.80),
                                            (32, 768, 40.13)])
def test_conv3x3_bound_of_a_unet_pass_is_the_smokes(B, T, smoke_ms):
    """The 25 Blocks' bound a pass of the n-best and generate cells
    against the sum that ``chip_smoke.py phase_conv3x3`` printed (PERF.md
    §6): within 2%."""
    got = 1e3 * counting.conv3x3_bound_s(B, 80, T, 64, 675)
    assert got == pytest.approx(smoke_ms, rel=0.02)


@pytest.mark.parametrize('workload, passes', [
    ('tedlium-spk-nbest-b50', 2), ('tedlium-spk-generate-b32', 1),
    ('ljspeech-synth-b32', 0), ('ljspeech-train-b128', 0)])
def test_drives_bound_the_block_convolutions_in_f32_only(workload, passes):
    """A call's conv3x3 bound: 25 Blocks an evaluation, twice in forward
    mode (n-best), once in synthesis, at the cell's batch and frames; none
    in a bf16 cell, which never runs the kernel."""
    _, cfg, tr, _ = run.load_cell(workload, traffic_sizes={'batches': 1})
    drive = drives.load(tr['drive'])(cfg, tr, 5, 'cpu')
    drive.prepare()
    bounds = drive.kernel_bound_per_call()
    assert set(bounds) <= set(drive.kernel_families)
    if not passes:
        assert 'conv3x3' not in bounds
        return
    B, T = ((50, 512) if passes == 2 else (32, 768))
    assert bounds['conv3x3'] == pytest.approx(
        passes * 10 * counting.conv3x3_bound_s(B, 80, T, 64, 675))
