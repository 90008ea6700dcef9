"""The port's LPC synthesis (ohpipeline_tpu_torch.ops.lpc) against the JAX
package: the bigint oracle, the lax.scan path and the Pallas kernel in
interpret mode, on the cases of tests/test_lpc.py.  Every comparison is
bit-exact: the recurrence is integer.  The kernel itself runs only on the
card (marker ``gpu``), against the plain version.

JAX is imported inside the tests that compare with it, so that the ``gpu``
tests also run where JAX is not installed."""

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _kernels
from ohpipeline_tpu_torch.ops import lpc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_case(rng, B, N, max_order=32, sample_bits=17, coeff_bits=15,
                max_shift=15, fixed_shift=None):
    """Random stable filters (sum|c| < 2^shift), as encoders emit them."""
    data = rng.integers(-(1 << (sample_bits - 1)), 1 << (sample_bits - 1),
                        (B, N), dtype=np.int64).astype(np.int32)
    order = rng.integers(0, max_order + 1, (B,)).astype(np.int32)
    coeffs = np.zeros((B, lpc.MAX_ORDER), np.int32)
    shift = np.zeros((B,), np.int32)
    for b in range(B):
        o = order[b]
        shift[b] = (fixed_shift if fixed_shift is not None
                    else rng.integers(max(coeff_bits - 2, 1), max_shift + 1))
        if o == 0:
            continue
        c = rng.integers(-(1 << (coeff_bits - 1)), 1 << (coeff_bits - 1),
                         (o,)).astype(np.float64)
        gain = np.abs(c).sum() / (1 << shift[b])
        if gain > 0.9:
            c = np.trunc(c * (0.9 / gain))
        coeffs[b, :o] = c.astype(np.int32)
    return data, coeffs, shift, order


def _worst_case_accumulator(rng):
    # order-32 filter, max-magnitude coeffs against max-magnitude 25-bit
    # warm-up, two synthesised samples
    B, N = 8, 34
    data = np.zeros((B, N), np.int32)
    data[:, :32] = (rng.integers(0, 2, (B, 32)) * 2 - 1) * ((1 << 24) - 1)
    coeffs = ((rng.integers(0, 2, (B, 32)) * 2 - 1)
              * ((1 << 14) - 1)).astype(np.int32)
    return data, coeffs, np.full(B, 15, np.int32), np.full(B, 32, np.int32)


def _fixed_predictors(rng):
    B, N = 5, 40
    data = rng.integers(-1000, 1000, (B, N)).astype(np.int32)
    coeffs = np.zeros((B, lpc.MAX_ORDER), np.int32)
    for b in range(B):
        coeffs[b, :len(lpc.FIXED_COEFFS[b])] = lpc.FIXED_COEFFS[b]
    return data, coeffs, np.zeros(B, np.int32), np.arange(5, dtype=np.int32)


def _order_zero(rng):
    B, N = 3, 16
    z = np.zeros(B, np.int32)
    return (rng.integers(-100, 100, (B, N)).astype(np.int32),
            np.zeros((B, lpc.MAX_ORDER), np.int32), z, z)


def _known_first_order(rng):
    coeffs = np.zeros((1, lpc.MAX_ORDER), np.int32)
    coeffs[0, 0] = 1
    return (np.array([[5, 1, 2, 3, 4]], np.int32), coeffs,
            np.zeros(1, np.int32), np.ones(1, np.int32))


def _negative_floor(rng):
    # c*s = -3, shift 1 -> -2 (toward -inf), not -1
    coeffs = np.zeros((1, lpc.MAX_ORDER), np.int32)
    coeffs[0, 0] = -1
    return (np.array([[3, 0, 0, 0]], np.int32), coeffs,
            np.ones(1, np.int32), np.ones(1, np.int32))


CASES = {
    "random": lambda rng: random_case(rng, B=16, N=64),
    "24bit": lambda rng: random_case(rng, B=8, N=48, sample_bits=25),
    "worst_case_accumulator": _worst_case_accumulator,
    **{f"shift_{sh}": (lambda rng, sh=sh: random_case(
        rng, B=4, N=32, sample_bits=12, coeff_bits=6, fixed_shift=sh))
       for sh in (0, 1, 12, 13, 24, 25, 31)},
    "fixed_predictors": _fixed_predictors,
    "order_zero": _order_zero,
    "known_first_order": _known_first_order,
    "negative_floor": _negative_floor,
}


def _pallas_interpret(data, coeffs, shift, order):
    """The TPU kernel itself, run in interpret mode as tests/test_lpc.py
    runs it."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from ohpipeline_tpu.ops import lpc as jlpc

    B, N = data.shape
    out = pl.pallas_call(
        jlpc._lpc_kernel,
        out_shape=jax.ShapeDtypeStruct((N, B), jnp.int32),
        grid=(1, 1),
        in_specs=[
            pl.BlockSpec((N, B), lambda i, j: (j, i)),
            pl.BlockSpec((jlpc.MAX_ORDER, B), lambda i, j: (0, i)),
            pl.BlockSpec((1, B), lambda i, j: (0, i)),
            pl.BlockSpec((1, B), lambda i, j: (0, i)),
        ],
        out_specs=pl.BlockSpec((N, B), lambda i, j: (j, i)),
        scratch_shapes=[pltpu.VMEM((jlpc.MAX_ORDER, B), jnp.int32)] * 3,
        interpret=True,
    )(jnp.asarray(data.T), jnp.asarray(coeffs.T),
      jnp.asarray(shift.reshape(1, B)), jnp.asarray(order.reshape(1, B)))
    return np.asarray(out).T


def _port(data, coeffs, shift, order, device="cpu"):
    t = [torch.from_numpy(a).to(device) for a in (data, coeffs, shift, order)]
    return lpc.lpc_synthesize(*t).cpu().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_package(case):
    import jax.numpy as jnp
    from ohpipeline_tpu.ops import lpc as jlpc

    data, coeffs, shift, order = CASES[case](np.random.default_rng(
        sorted(CASES).index(case)))
    truth = jlpc.lpc_synthesize_py(data, coeffs, shift, order)
    assert np.abs(truth).max() < (1 << 31), "case overflows int32"
    got = _port(data, coeffs, shift, order)
    assert got.dtype == np.int32 and got.shape == data.shape
    np.testing.assert_array_equal(got.astype(np.int64), truth)
    scan = np.asarray(jlpc.lpc_synthesize_scan(
        jnp.asarray(data), jnp.asarray(coeffs), jnp.asarray(shift),
        jnp.asarray(order)))
    np.testing.assert_array_equal(got, scan)
    np.testing.assert_array_equal(
        got, _pallas_interpret(data, coeffs, shift, order))


def test_known_first_order_is_cumulative_sum():
    got = _port(*_known_first_order(None))
    np.testing.assert_array_equal(got[0], [5, 6, 8, 11, 15])


def test_cpu_tensors_take_plain_version():
    _kernels.reset_launches()
    data, coeffs, shift, order = random_case(np.random.default_rng(5), 4, 16)
    _port(data, coeffs, shift, order)
    assert _kernels.launches["lpc"] == 0


# --- the kernel's decomposition: blocks of G outputs, one accumulator a lane -

def _rows(rng, orders, N, sample_bits=17, shifts=None, taps=None):
    """One row per entry of ``orders``: stable coefficients over the first
    ``taps`` (default: the order) taps, zero past them."""
    B = len(orders)
    data = rng.integers(-(1 << (sample_bits - 1)), 1 << (sample_bits - 1),
                        (B, N)).astype(np.int32)
    coeffs = np.zeros((B, lpc.MAX_ORDER), np.int32)
    shift = (np.asarray(shifts, np.int32) if shifts is not None
             else rng.integers(12, 16, B).astype(np.int32))
    for b, o in enumerate(orders):
        n = o if taps is None else taps[b]
        if n:
            c = rng.integers(-(1 << 14), 1 << 14, n).astype(np.float64)
            gain = np.abs(c).sum() / np.exp2(shift[b])
            coeffs[b, :n] = np.trunc(c * min(1.0, 0.9 / gain))
    return data, coeffs, shift, np.asarray(orders, np.int32)


def _order32_shifts(rng):
    # shift 0 only stays in range with a tiny filter: c = +-1 on tap 31
    data, coeffs, shift, order = _rows(rng, [32, 32, 32, 32], 300,
                                       shifts=[0, 31, 0, 31])
    coeffs[0] = 0
    coeffs[0, 31] = 1
    coeffs[2] = 0
    coeffs[2, 31] = -1
    data[[0, 2], 32:] &= 0xFF
    return data, coeffs, shift, order


def _worst_25bit(rng):
    # max warm-up against max coefficients, then 25-bit residuals that keep
    # the accumulator near 2^40 across block edges
    B, N = 6, 70
    data = rng.integers(-(1 << 24), 1 << 24, (B, N)).astype(np.int32)
    data[:, :32] = (rng.integers(0, 2, (B, 32)) * 2 - 1) * ((1 << 24) - 1)
    coeffs = ((rng.integers(0, 2, (B, 32)) * 2 - 1)
              * ((1 << 14) - 1)).astype(np.int32)
    return data, coeffs, np.full(B, 15, np.int32), np.full(B, 32, np.int32)


STRESS = {
    # N not a multiple of 32 (nor of 4: the 4-byte staging path), and a
    # multiple of 4 that is not one of 128 (16-byte staging, ragged piece)
    "n_ragged": lambda rng: _rows(rng, [8, 12, 32, 3, 0, 8, 8], 1001),
    "n_mult4": lambda rng: _rows(rng, [8, 12, 32, 3, 0, 8, 8], 1004),
    "order32_shift0_31": _order32_shifts,
    # order 12 but taps only up to c[7]: the 8-lane path with a warm-up
    # that crosses its block edge at sample 8
    "warmup_across_block": lambda rng: _rows(rng, [12, 20, 9, 31], 200,
                                             taps=[8, 8, 8, 6]),
    # a block of four rows mixing orders 0, 1, 8 and 12, then 32
    "mixed_orders": lambda rng: _rows(rng, [0, 1, 8, 12, 32, 8, 1, 0],
                                      500),
    # every row at most 8 taps: the 8-lane path, B = 4 k + 1 and 4 k + 3
    "narrow_b9": lambda rng: _rows(rng, [8, 0, 1, 2, 3, 4, 8, 8, 5], 777),
    "wide_b7": lambda rng: _rows(rng, [32, 8, 16, 9, 12, 32, 1], 256),
    "worst_25bit": _worst_25bit,
}


def lane_model(data, coeffs, shift, order, G):
    """numpy model of csrc/lpc.cu's split: lane k of a row owns output
    n0 + k of each block of G, keeps one int64 accumulator and adds
    c[(k - 1 - j) mod G] * s_j at step j, restarting after it finishes its
    own output.  Terms reaching back further than G samples are lost, so
    G = 8 holds only for rows whose taps past c[7] are zero."""
    B, N = data.shape
    k = np.arange(G)
    w = coeffs.astype(np.int64)[:, (k[:, None] - 1 - k[None, :]) % G]
    sh = shift.astype(np.int64)
    acc = np.zeros((B, G), np.int64)
    out = np.zeros((B, N), np.int32)
    for n in range(N):
        j = n % G
        r = data[:, n].astype(np.int64)
        s = np.where(n < order, r, lpc.wrap32(r + (acc[:, j] >> sh)))
        acc[:, j] = 0
        acc += w[:, :, j] * s[:, None]
        out[:, n] = s
    return out


def _taps(coeffs):
    nz = coeffs != 0
    return np.where(nz.any(1), lpc.MAX_ORDER - np.argmax(nz[:, ::-1], 1), 0)


WIDE_ONLY = ("order32_shift0_31", "worst_25bit")  # no row of 8 taps or fewer


@pytest.mark.parametrize("case,G", [(c, 32) for c in sorted(STRESS)]
                         + [(c, 8) for c in sorted(STRESS)
                            if c not in WIDE_ONLY])
def test_lane_model_matches_plain(case, G):
    """The kernel's decomposition is bit-exact with the plain version on the
    stress cases, on both paths (G = 8 for the rows it takes)."""
    data, coeffs, shift, order = STRESS[case](np.random.default_rng(
        sorted(STRESS).index(case)))
    want = _port(data, coeffs, shift, order)
    if G == 8:
        keep = _taps(coeffs) <= 8
        assert keep.any()
        data, coeffs, shift, order = (a[keep] for a in (data, coeffs, shift,
                                                        order))
        want = want[keep]
    np.testing.assert_array_equal(lane_model(data, coeffs, shift, order, G),
                                  want)


def test_lane_model_matches_plain_on_lpc_case():
    """chip_smoke.py's synthetic group (orders 0-32, shifts 0-31, 5% worst
    rows), cut to 64 rows x 300 samples."""
    data, coeffs, shift, order = (a[:64] for a in chip_smoke.lpc_case())
    data = np.ascontiguousarray(data[:, :300])
    np.testing.assert_array_equal(lane_model(data, coeffs, shift, order, 32),
                                  _port(data, coeffs, shift, order))



@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(STRESS))
def test_kernel_matches_plain_on_card_stress(case, cuda):
    args = STRESS[case](np.random.default_rng(sorted(STRESS).index(case)))
    t = [torch.from_numpy(a).to(cuda) for a in args]
    before = _kernels.launches["lpc"]
    got = lpc.lpc_synthesize(*t)
    torch.cuda.synchronize()
    assert _kernels.launches["lpc"] == before + 1
    assert torch.equal(got, lpc.lpc_synthesize_torch(*t))
    np.testing.assert_array_equal(got.cpu().numpy(), _port(*args))


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    # one serving group's shape, 25-bit samples, orders 0-32, shifts 13-31
    case = random_case(np.random.default_rng(0), B=1152, N=4096,
                       sample_bits=25, max_shift=31)
    t = [torch.from_numpy(a).to(cuda) for a in case]
    _kernels.reset_launches()
    got = lpc.lpc_synthesize(*t)
    torch.cuda.synchronize()
    assert _kernels.launches["lpc"] == 1
    want = lpc.lpc_synthesize_torch(*t)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card_small(case, cuda):
    # the plain version on the CPU is held to the bigint oracle above
    args = CASES[case](np.random.default_rng(sorted(CASES).index(case)))
    np.testing.assert_array_equal(_port(*args, cuda), _port(*args))
