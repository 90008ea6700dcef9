"""The port's multi-device layer (``ohpipeline_tpu_torch.parallel``,
``pipeline.branch.IciBranch``, ``entry.dryrun_multichip``) on a mesh of named
devices, against the JAX package on its 8-device CPU mesh
(tests/conftest.py).

The port's mesh is one process placing tensors explicitly; on the CPU a
mesh of ``["cpu"] * n`` stands in for JAX's ``n`` virtual CPU devices.
Bounds, and why: ``serving_put``'s shards hold the same blocks as JAX's
``addressable_shards``; ``room_fanout``'s replicas equal the input; the
per-room render grid equals JAX bit for bit on tests/test_parallel.py's
rooms, which divide dp (the port fuses the multiply-adds as XLA-CPU does
there), and is within 1e-2 of JAX where they do not (XLA fuses otherwise:
~1e-3 apart); on that test's inputs it is within the test's own bound
(rtol 5e-3, atol 1.0) of its unfused numpy oracle; it prints how many
samples differ from each; ``sharded_pipeline_step``
renders and meters bit-exactly, its AAC PCM within 0.05 and its Vorbis
IMDCT within 1e-3 of JAX (test_parallel.py's bound against ``imdct_many``).
The ``gpu`` tests run a logical mesh of four entries on one card against
one device.  JAX is imported inside the tests that compare with it."""

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _kernels, parallel
from ohpipeline_tpu_torch.entry import dryrun_multichip
from ohpipeline_tpu_torch.host.core import events as ev
from ohpipeline_tpu_torch.host.core.streaminfo import PcmStreamInfo
from ohpipeline_tpu_torch.pipeline.branch import Brancher, IciBranch

CPU8 = ["cpu"] * 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax_mesh():
    import jax

    from ohpipeline_tpu import parallel as jp

    assert len(jax.devices()) >= 8, "needs the 8-device CPU mesh"
    return jp, jp.make_mesh(8)


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (2, 1)), (4, (2, 2)),
                                     (8, (4, 2))])
def test_mesh_shapes(n, shape):
    mesh = parallel.make_mesh(devices=["cpu"] * n)
    assert mesh.devices.shape == shape
    assert mesh.axis_names == ("dp", "sp")
    assert mesh.shape == {"dp": shape[0], "sp": shape[1]}
    assert mesh.size == n and mesh.rows() == [torch.device("cpu")] * shape[0]
    assert parallel.make_mesh(n, devices=CPU8).devices.shape == shape


def test_mesh_shape_matches_jax():
    jp, jmesh = _jax_mesh()
    for n in (1, 2, 4, 8):
        assert parallel.make_mesh(devices=["cpu"] * n).devices.shape \
            == jp.make_mesh(n).devices.shape


def test_mesh_larger_than_its_device_list_raises():
    with pytest.raises(_kernels.KernelError):
        parallel.make_mesh(9, devices=CPU8)


def _blocks(shards, shape) -> dict:
    """{((start, stop) per axis): data} over the distinct blocks."""
    out = {}
    for index, data in shards:
        key = tuple(sl.indices(n)[:2] for sl, n in zip(index, shape))
        out.setdefault(key, data)
    return out


@pytest.mark.parametrize("shape,axis", [((8, 3), 0), ((4, 6), 1),
                                        ((3, 8, 5), 1), ((6, 5), 0),
                                        ((2, 1024), 0), ((8, 3), None)])
def test_serving_put_shards_match_jax(shape, axis):
    jp, jmesh = _jax_mesh()
    a = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = parallel.serving_put(parallel.make_mesh(devices=CPU8), a, axis)
    want = jp.serving_put(jmesh, a, axis)
    got_b = _blocks(((idx, t.numpy()) for _, idx, t in got.shards), shape)
    want_b = _blocks(((s.index, np.asarray(s.data))
                      for s in want.addressable_shards), shape)
    assert got_b.keys() == want_b.keys()
    for key in got_b:
        np.testing.assert_array_equal(got_b[key], want_b[key])
    split = axis is not None and shape[axis] % 4 == 0
    assert len(got.shards) == (4 if split else 8)
    np.testing.assert_array_equal(got.full("cpu").numpy(), a)


def test_serving_put_without_a_mesh_returns_the_array():
    a = np.zeros(3)
    assert parallel.serving_put(None, a, 0) is a


@pytest.mark.parametrize("shape", [(8, 16), (2, 1024), (10,), ()])
def test_room_fanout_replicates_to_every_device(shape):
    import jax

    jp, jmesh = _jax_mesh()
    x = (np.random.default_rng(2).standard_normal(shape) * 1000) \
        .astype(np.float32)
    full, peak = parallel.room_fanout(parallel.make_mesh(devices=CPU8), x)
    assert len(full.shards) == 8
    for _, index, t in full.shards:
        np.testing.assert_array_equal(t.numpy(), x)
    with jmesh:
        jfull, jpeak = jax.jit(lambda t: jp.room_fanout(jmesh, t))(x)
    for s in jfull.addressable_shards:
        np.testing.assert_array_equal(np.asarray(s.data), x)
    assert float(peak) == float(jpeak) == float(np.abs(x).max())


def _grid_inputs(seed=7, N=2048, R=4):
    """tests/test_parallel.py's inputs (seed 7, N 2048, R = dp rooms)."""
    rng = np.random.default_rng(seed)
    master = rng.integers(-30000, 30000, (2, N)).astype(np.float32)
    gains = np.linspace(0.2, 1.0, R).astype(np.float32)
    delays = np.array(([0.0, 0.5, 3.0, 10.25] * ((R + 3) // 4))[:R],
                      np.float32)
    skew = np.linspace(-200.0, 200.0, R).astype(np.float32)
    skew[0] = 0.0
    return (master, gains, delays, skew, np.zeros(R, np.float32),
            np.ones(R, np.float32))


def _numpy_oracle(master, gains, delays, skew, ramp0, ramp1):
    """tests/test_parallel.py's unfused float32 numpy oracle."""
    C, N = master.shape
    t = np.arange(N, dtype=np.float32)
    out = []
    for r in range(len(gains)):
        pos = t * np.float32(1.0 + skew[r] * 1e-6) - delays[r]
        i0 = np.clip(np.floor(pos).astype(np.int32), 0, N - 1)
        i1 = np.clip(i0 + 1, 0, N - 1)
        frac = (pos - i0).astype(np.float32)
        x = master[:, i0] * (1 - frac) + master[:, i1] * frac
        x[:, (pos < 0) | (pos > N - 1)] = 0.0
        ramp = ramp0[r] + (ramp1[r] - ramp0[r]) * t / np.float32(N)
        out.append(x * (gains[r] * ramp))
    return np.stack(out)


def _jax_grid(args):
    import jax

    jp, jmesh = _jax_mesh()
    with jmesh:
        return np.asarray(jax.jit(lambda m, *a: jp.room_render_grid(
            jmesh, m, *a))(*args))


@pytest.mark.parametrize("case", ["test_parallel", "ragged"])
def test_room_render_grid_matches_jax_and_the_numpy_oracle(case):
    if case == "test_parallel":
        args = _grid_inputs()
    else:        # odd width, fractional delays, large skews, uneven ramps
        rng = np.random.default_rng(11)
        R, N = 6, 2047
        args = (rng.integers(-30000, 30000, (2, N)).astype(np.float32),
                rng.random(R).astype(np.float32),
                (rng.random(R) * 20).astype(np.float32),
                ((rng.random(R) - 0.5) * 600).astype(np.float32),
                rng.random(R).astype(np.float32),
                rng.random(R).astype(np.float32))
    mesh = parallel.make_mesh(devices=CPU8)
    grid = parallel.room_render_grid(mesh, *args)
    R = len(args[1])
    assert grid.shape == (R, *args[0].shape)
    assert grid.devices == mesh.rows()[:len(grid.shards)]
    out = grid.full("cpu").numpy()
    # JAX fuses the same three multiply-adds: on test_parallel's rooms the
    # grids agree bit for bit; when the rooms do not divide dp, XLA fuses
    # otherwise and ~1e-3 is seen.  The loose bound is the unfused numpy
    # oracle's (test_parallel.py's, for its inputs only).
    refs = [("JAX", _jax_grid(args),
             {"rtol": 0, "atol": 0 if case == "test_parallel" else 1e-2})]
    if case == "test_parallel":
        refs.append(("the numpy oracle", _numpy_oracle(*args),
                     {"rtol": 5e-3, "atol": 1.0}))
    for name, want, tol in refs:
        print(f"{case}: {int((out != want).sum())} of {out.size} samples "
              f"differ from {name}, max |diff| {np.abs(out - want).max()}")
        np.testing.assert_allclose(out, want, **tol)
    if case == "test_parallel":
        master, gains = args[:2]
        N = master.shape[1]
        np.testing.assert_allclose(
            out[0], master * (gains[0] * np.arange(N, dtype=np.float32)
                              / np.float32(N)), atol=1e-2)
        assert np.all(out[2][:, :3] == 0.0)


def _step_inputs(dp=4):
    nframes = max(8, dp * 2)
    args = parallel.example_step_args(nframes=nframes, n=1024)
    rng = np.random.default_rng(3)
    B = dp * 2
    return args + (rng.standard_normal((4, B, 1024)).astype(np.float32),
                   np.zeros((4, B), np.int32),
                   np.zeros((B, 1024), np.float32),
                   rng.standard_normal((B, 1024)).astype(np.float32))


def test_sharded_pipeline_step_matches_jax():
    import jax

    jp, jmesh = _jax_mesh()
    args = _step_inputs()
    mesh = parallel.make_mesh(devices=CPU8)
    rendered, meters, aac_pcm, aac_ov, vtime = \
        parallel.sharded_pipeline_step(mesh)(*args)
    step = jp.sharded_pipeline_step(jmesh, num_channels=2)
    with jmesh:
        want = [np.asarray(a) for a in step(*args)]
    assert rendered.shape == (8, 2, 1024) and meters.shape == (8,)
    assert len(rendered.shards) == 8          # frames over dp, samples sp
    assert len(meters.shards) == 8            # replicated to every device
    for _, _, t in meters.shards:
        np.testing.assert_array_equal(t.numpy(), want[1])
    np.testing.assert_array_equal(rendered.full("cpu").numpy(), want[0])
    np.testing.assert_allclose(aac_pcm.full("cpu").numpy(), want[2],
                               atol=0.05)
    np.testing.assert_allclose(aac_ov.full("cpu").numpy(), want[3],
                               atol=0.05)
    assert vtime.shape == (8, 2048) and len(vtime.shards) == 8
    np.testing.assert_allclose(vtime.full("cpu").numpy(), want[4], atol=1e-3)


def test_sharded_pipeline_step_equals_the_one_device_step():
    """The step on a mesh of four entries against the same step on a
    one-entry mesh: the rows' work does not depend on their split."""
    args = _step_inputs(dp=2)
    outs = [parallel.sharded_pipeline_step(parallel.make_mesh(
        devices=["cpu"] * n))(*args) for n in (1, 4)]
    for one, four in zip(*outs):
        np.testing.assert_array_equal(one.full("cpu").numpy(),
                                      four.full("cpu").numpy())


class _Up:
    def __init__(self, events):
        self._ev = list(events)

    def pull(self):
        return self._ev.pop(0)


def _ici_run(brancher_cls, branch, info_cls, evm):
    info = info_cls(sample_rate=44100, bit_depth=16, num_channels=2)
    rng = np.random.default_rng(11)
    pcm = rng.integers(-30000, 30000, (2, 2500)).astype(np.int32)
    events = [evm.DecodedStreamEvent(stream_id=1, info=info),
              # uneven event sizes exercise the tile re-blocking
              evm.AudioPcmEvent(pcm[:, :700], info),
              evm.AudioPcmEvent(pcm[:, 700:], info),
              evm.HaltEvent()]
    tee = brancher_cls(_Up(events), "tee")
    tee.attach(branch)
    for _ in range(len(events)):
        tee.pull()
    return pcm


def test_ici_branch_fans_the_pipeline_out_as_jax_does():
    from ohpipeline_tpu.core import events as jev
    from ohpipeline_tpu.core.streaminfo import PcmStreamInfo as JInfo
    from ohpipeline_tpu.pipeline.branch import Brancher as JBrancher
    from ohpipeline_tpu.pipeline.branch import IciBranch as JIci

    ici = IciBranch(parallel.make_mesh(devices=CPU8))
    pcm = _ici_run(Brancher, ici, PcmStreamInfo, ev)
    # 2500 samples = 2 full tiles + a zero-padded halt tile
    assert ici.tiles_sent == 3
    rooms = ici.rooms()
    assert len(rooms) == 8
    tail = np.zeros((2, IciBranch.TILE), np.float32)
    tail[:, :2500 - 2048] = pcm[:, 2048:].astype(np.float32)
    for room in rooms:
        np.testing.assert_array_equal(room, tail)
    assert ici.peak == float(np.abs(tail).max())

    _jp, jmesh = _jax_mesh()
    jici = JIci(jmesh)
    _ici_run(JBrancher, jici, JInfo, jev)
    assert jici.tiles_sent == ici.tiles_sent and jici.peak == ici.peak
    jrooms = jici.rooms()
    assert len(jrooms) == len(rooms)
    for a, b in zip(rooms, jrooms):
        np.testing.assert_array_equal(a, b)


def test_ici_branch_drops_a_partial_tile_on_a_new_stream():
    ici = IciBranch(parallel.make_mesh(devices=["cpu"] * 2))
    info = PcmStreamInfo(sample_rate=44100, bit_depth=16, num_channels=2)
    ici.push(ev.AudioPcmEvent(np.ones((2, 1500), np.int32), info))
    ici.push(ev.DecodedStreamEvent(stream_id=2, info=info))
    ici.push(ev.HaltEvent())
    assert ici.tiles_sent == 1
    assert ici.rooms()[0].shape == (2, IciBranch.TILE)


def test_dryrun_multichip_on_eight_cpu_entries():
    line = dryrun_multichip(devices=CPU8)
    assert line.startswith("dryrun_multichip ok: mesh (4, 2)")


@pytest.mark.gpu
def test_logical_mesh_on_the_card(cuda):
    """Four entries on one card (dp 2, sp 2) against a one-entry mesh on
    it: the step (rendered and meters bit-exact; the AAC and Vorbis
    products, whose split blocks may take other cuBLAS kernels, within the
    bounds held against JAX), the fan-out and the render grid, and the dry
    run."""
    four = parallel.make_mesh(devices=["cuda:0"] * 4)
    one = parallel.make_mesh(devices=["cuda:0"])
    args = _step_inputs(dp=2)
    outs = [[o.full("cpu") for o in parallel.sharded_pipeline_step(m)(*args)]
            for m in (one, four)]
    for i, atol in enumerate((0, 0, 0.05, 0.05, 1e-3)):
        torch.testing.assert_close(outs[1][i], outs[0][i], rtol=0, atol=atol)
    gargs = _grid_inputs(R=2)
    for mesh in (one, four):
        full, _ = parallel.room_fanout(mesh, gargs[0])
        assert all(torch.equal(t.cpu(), torch.from_numpy(gargs[0]))
                   for _, _, t in full.shards)
    assert torch.equal(parallel.room_render_grid(one, *gargs).full("cpu"),
                       parallel.room_render_grid(four, *gargs).full("cpu"))
    dryrun_multichip(devices=["cuda:0"] * 4)
