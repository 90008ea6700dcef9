"""The port's flagship decode->render step
(ohpipeline_tpu_torch.parallel.decode_render_step, entry.entry) against the
JAX package's ``parallel.decode_render_step``, bit-exact, on
``example_step_args`` and on random ramps and gains with unity rows."""

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import parallel
from ohpipeline_tpu_torch.entry import entry


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_args(seed, nframes=6, n=512):
    """Real FLAC rows (stable predictors, every channel mode) with random
    ramps and gains; frames 0 and 1 are unity."""
    rng = np.random.default_rng(seed)
    B = nframes * 2
    data = rng.integers(-3000, 3000, (B, n)).astype(np.int32)
    order = rng.integers(0, 13, B).astype(np.int32)
    shift = rng.integers(9, 14, B).astype(np.int32)
    coeffs = np.zeros((B, 32), np.int32)
    for b in range(B):
        c = rng.integers(-(1 << 9), 1 << 9, order[b]).astype(np.float64)
        gain = np.abs(c).sum() / (1 << shift[b])
        coeffs[b, :order[b]] = np.trunc(c * min(1.0, 0.9 / max(gain, 1e-9)))
    wasted = rng.integers(0, 3, B).astype(np.int32)
    assign = rng.choice([1, 8, 9, 10], nframes).astype(np.int32)
    rs = rng.uniform(0, 1, nframes).astype(np.float32)
    re = rng.uniform(0, 1, nframes).astype(np.float32)
    gain = rng.uniform(0, 1, nframes).astype(np.float32)
    rs[:2], re[:2], gain[:2] = 1.0, 1.0, 1.0
    return data, coeffs, shift, order, wasted, assign, rs, re, gain


def _compare(args):
    from ohpipeline_tpu import parallel as jparallel

    want_r, want_p = jparallel.decode_render_step(*args, num_channels=2)
    got_r, got_p = parallel.decode_render_step(
        *(torch.from_numpy(a) for a in args), num_channels=2)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    return got_r.numpy()


def test_example_step_args_match_jax():
    from ohpipeline_tpu import parallel as jparallel

    ours = parallel.example_step_args(nframes=4, n=256, seed=3)
    theirs = jparallel.example_step_args(nframes=4, n=256, seed=3)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _compare(ours)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_ramps_and_gains_match_jax(seed):
    args = _random_args(seed)
    rendered = _compare(args)
    # unity frames carry the synthesised PCM through unchanged
    from ohpipeline_tpu import parallel as jparallel
    unity = np.asarray(jparallel.decode_render_step(
        *args[:6], np.ones(6, np.float32), np.ones(6, np.float32),
        np.ones(6, np.float32))[0])
    np.testing.assert_array_equal(rendered[:2], unity[:2])


def test_entry_runs_on_cpu():
    import jax

    from ohpipeline_tpu.parallel import decode_render_step

    fn, args = entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    rendered, peaks = fn(*args)
    assert rendered.shape == (8, 2, 1024) and rendered.dtype == torch.int32
    assert peaks.shape == (8,) and int(peaks.min()) > 0
    want_r, want_p = jax.jit(lambda *a: decode_render_step(*a))(
        *(a.numpy() for a in args))
    np.testing.assert_array_equal(rendered.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(peaks.numpy(), np.asarray(want_p))


@pytest.mark.gpu
def test_entry_on_card_matches_cpu(cuda):
    fn, args = entry(cuda)
    got = fn(*args)
    torch.cuda.synchronize()
    want = entry("cpu")[0](*entry("cpu")[1])
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
