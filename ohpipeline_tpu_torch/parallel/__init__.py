"""The multi-device layer: the flagship step, the mesh and the multiroom
fan-out.

Port of ``ohpipeline_tpu.parallel``.  A JAX mesh has one controller: one
Python process places every shard and runs one program over the devices.
The counterpart here is one process that places tensors explicitly
(``.to(device)``) and launches each shard's work on its own device:

* :class:`Mesh` is a (dp, sp) grid of ``torch.device``; ``dp`` shards
  streams (rows), ``sp`` the samples of the elementwise render stages.
  :func:`make_mesh` builds it over the visible cards, or over a named list
  of devices, which may repeat an entry (``["cpu"] * 8`` stands in for the
  JAX tests' eight virtual CPU devices, ``["cuda:0"] * 4`` for four cards on
  one).  It never falls back to the CPU: with no card and no list it raises.
* :class:`Sharded` is an array laid out over a mesh, as a ``jax.Array`` and
  its ``addressable_shards``: a block split over ``dp`` lives on the first
  device of its dp row, a replicated array on every device of the mesh.
* :func:`serving_put` places one serving-call array as the JAX function
  does.  The serving calls' ``mesh=`` runs on ``codecs._serving`` (below
  this layer, as JAX's ``codecs._serving_util``): each dp row serves a
  contiguous block of the streams on its device with its own group loop,
  and the blocks advance group by group together.
* :func:`room_fanout` is the Songcast-style fan-out (every device receives
  the whole master mix by peer copies), :func:`room_render_grid` the
  per-room receiver chain over the rooms split on ``dp``, and
  :func:`sharded_pipeline_step` the decode -> render -> multiroom step over
  a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..codecs._serving import blocks as _blocks
from ..codecs.aac import synthesis as asyn
from ..codecs.flac import synthesise_group
from ..host.codecs.vorbis import synthesis as vsyn
from ..ops import lpc as lpc_ops
from ..ops import pcm as pcm_ops


class Mesh:
    """A (dp, sp) grid of devices: ``devices`` an object array of
    ``torch.device``, ``axis_names`` its two axes, ``shape`` a dict of the
    axis sizes (``mesh.shape["dp"]``, as in JAX)."""

    def __init__(self, devices: np.ndarray, axis_names=("dp", "sp")):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def flat(self) -> list:
        """Every device of the mesh, row by row."""
        return list(self.devices.ravel())

    def rows(self) -> list:
        """The first device of each dp row: where a block split over dp
        lives."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.flat()]})")


def make_mesh(n_devices: int | None = None, axes=("dp", "sp"), *,
              devices=None) -> Mesh:
    """A 2D mesh over ``n_devices`` devices: the visible cards
    (``cuda:0`` ... ``cuda:n-1``), or the first ``n_devices`` of
    ``devices`` (all of them by default).  dp gets the larger factor of the
    count (streams dominate), sp the rest: 8 -> (4, 2), 4 -> (2, 2),
    1 -> (1, 1).  Raises ``KernelError`` with no card and no ``devices``,
    and for more devices than there are cards (or entries)."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise _kernels.KernelError(
                "make_mesh: torch sees no CUDA device; name the mesh's "
                "devices (make_mesh(devices=['cpu'] * 8) on the CPU)")
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = [_kernels.checked_device(d) for d in devices]
        for d in devs:
            if d.type == "cuda" and d.index is not None \
                    and d.index >= torch.cuda.device_count():
                raise _kernels.KernelError(
                    f"make_mesh: {d} asked for, torch sees "
                    f"{torch.cuda.device_count()} CUDA devices")
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise _kernels.KernelError(
            f"make_mesh: {n} devices asked for, {len(devs)} available")
    sp = next(c for c in (4, 2, 1) if n % c == 0 and n // c >= c)
    grid = np.empty((n // sp, sp), dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i // sp, i % sp] = d
    return Mesh(grid, axes)


def _index(ndim: int, axis: int, sl: slice) -> tuple:
    return tuple(sl if k == axis else slice(None) for k in range(ndim))


def _key(index: tuple, shape: tuple) -> tuple:
    return tuple(s.indices(n)[:2] for s, n in zip(index, shape))


class Sharded:
    """An array laid out over a mesh: ``shape`` and ``dtype`` of the whole,
    and ``shards``, one ``(device, index, tensor)`` per placement, ``index``
    a tuple of slices into the whole (the port's ``addressable_shards``).  A
    replicated array has one shard per mesh device, each the whole."""

    def __init__(self, shape, shards: list):
        self.shape = tuple(shape)
        self.shards = shards

    @property
    def dtype(self):
        return self.shards[0][2].dtype

    @property
    def devices(self) -> list:
        return [d for d, _, _ in self.shards]

    def full(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (the first shard's by default),
        each distinct block copied once."""
        device = self.shards[0][0] if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for _, index, t in self.shards:
            key = _key(index, self.shape)
            if key not in seen:
                seen.add(key)
                out[index] = t.to(device)
        return out


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


def replicate(mesh: Mesh, arr) -> Sharded:
    """``arr`` copied whole to every device of the mesh."""
    a = _tensor(arr)
    whole = tuple(slice(None) for _ in a.shape)
    return Sharded(a.shape, [(d, whole, a.to(d)) for d in mesh.flat()])


def split(mesh: Mesh, arr, axis: int = 0) -> Sharded:
    """``arr`` split along ``axis`` into dp contiguous blocks, block i on
    the first device of dp row i (``P("dp")`` on that axis)."""
    a = _tensor(arr)
    return Sharded(a.shape, [
        (d, _index(a.ndim, axis, sl), a[_index(a.ndim, axis, sl)].to(d))
        for d, sl in zip(mesh.rows(), _blocks(a.shape[axis],
                                              mesh.shape["dp"]))])


def serving_put(mesh: Mesh | None, arr, stream_axis: int | None = None):
    """Place one serving-call array for stream-parallel execution: the
    stream axis splits over dp where its extent is a multiple of dp (and
    at least dp), anything else replicates.  ``mesh=None`` returns ``arr``
    unchanged."""
    if mesh is None:
        return arr
    a = _tensor(arr)
    dp = mesh.shape["dp"]
    if stream_axis is not None and a.ndim > stream_axis \
            and a.shape[stream_axis] >= dp \
            and a.shape[stream_axis] % dp == 0:
        return split(mesh, a, stream_axis)
    return replicate(mesh, a)


def _distinct_blocks(x: Sharded) -> list:
    """The distinct blocks of ``x``, in index order (one replica each)."""
    seen, out = set(), []
    for _, index, t in sorted(x.shards, key=lambda s: _key(s[1], x.shape)):
        key = _key(index, x.shape)
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def room_fanout(mesh: Mesh, x):
    """OHM-style multiroom fan-out (the Songcast OhmSender analogue): ``x``
    (a :class:`Sharded` split along axis 0 or replicated, or an array, which
    is split over dp along axis 0 first) is gathered to every device of the
    mesh by peer copies of its blocks, so every device ("room") holds the
    full master mix.
    Returns (full, peak): the replicated :class:`Sharded` and ``max|full|``
    on the mesh's first device."""
    if not isinstance(x, Sharded):
        x = split(mesh, x, 0) if _tensor(x).ndim else replicate(mesh, x)
    blocks = _distinct_blocks(x)
    whole = tuple(slice(None) for _ in x.shape)
    shards = [(d, whole, torch.cat([b.to(d) for b in blocks])
               if x.shape else blocks[0].to(d)) for d in mesh.flat()]
    full = Sharded(x.shape, shards)
    return full, shards[0][2].abs().max()


def render_rooms(master, gains, delays, skew_ppm, ramp0, ramp1):
    """The receiver chain of a batch of rooms on one device (the body of
    ``room_render_grid``): master (C, N) float32; gains, delays (samples,
    may be fractional), skew_ppm, ramp0, ramp1 (R,) float32 on the same
    device.  Each room resamples the master at ``t * (1 + skew 1e-6) -
    delay`` (a linear blend of the two taps around it; silent outside the
    master), times ``gain * ramp``, the ramp running from ramp0 to ramp1
    over the N samples.  Returns (R, C, N) float32.  The float32 operations
    run as XLA-CPU compiles the JAX function over rooms that divide dp, so
    the two agree bit for bit there: the position's, the blend's and the
    ramp's multiply-adds fused, the ramp's 1 / N a float32 reciprocal."""
    C, N = master.shape
    dev = master.device
    t = torch.arange(N, dtype=torch.float32, device=dev)
    rate = 1.0 + skew_ppm * 1e-6
    pos = pcm_ops.fma32(t[None, :], rate[:, None], -delays[:, None])
    i0 = torch.floor(pos).to(torch.int64).clamp(0, N - 1)
    i1 = (i0 + 1).clamp(0, N - 1)
    frac = (pos - i0.to(torch.float32))[:, None, :]
    m0, m1 = (master[:, i].transpose(0, 1) for i in (i0, i1))
    x = pcm_ops.fma32(m0, 1.0 - frac, m1 * frac)
    x = torch.where(((pos < 0.0) | (pos > N - 1.0))[:, None, :], 0.0, x)
    recip = torch.tensor(np.float32(1.0 / N), device=dev)
    ramp = pcm_ops.fma32((ramp1 - ramp0)[:, None] * t[None, :], recip,
                         ramp0[:, None])
    return x * (gains[:, None] * ramp)[:, None, :]


def room_render_grid(mesh: Mesh, master, gains, delays, skew_ppm, ramp0,
                     ramp1) -> Sharded:
    """The per-room receiver chain over the mesh, the receiver half of
    multiroom: each room runs its own pipeline tail on the master mix (a
    VariableDelay's latency alignment, ClockPullerSongcast's fractional
    clock-skew resample, the local ramp x volume).  The rooms (R,) split
    over dp; each dp row's first device runs its block of rooms as one
    batch (:func:`render_rooms`) on its copy of ``master`` (C, N).
    Returns the (R, C, N) float32 result, split over dp on the rooms."""
    master = _tensor(master).to(torch.float32)
    params = [_tensor(a).to(torch.float32)
              for a in (gains, delays, skew_ppm, ramp0, ramp1)]
    R = params[0].shape[0]
    C, N = master.shape
    shards = []
    for d, sl in zip(mesh.rows(), _blocks(R, mesh.shape["dp"])):
        out = render_rooms(master.to(d), *(p[sl].to(d) for p in params))
        shards.append((d, (sl, slice(None), slice(None)), out))
    return Sharded((R, C, N), shards)


def decode_render_step(data, coeffs, shift, order, wasted, assign,
                       ramp_start, ramp_end, gain, num_channels: int = 2):
    """FLAC-family subframe batch -> rendered PCM.

    B = F * num_channels rows of subframe data: LPC synthesis -> wasted-bit
    shift -> inter-channel decorrelation -> fused ramp x volume gain.
    Returns (F, num_channels, N) int32 PCM and the per-frame peak meters
    (F,) int32.
    """
    chans = synthesise_group(data, coeffs, shift, order, wasted, assign,
                             num_channels)
    rendered = pcm_ops.apply_gain(chans, ramp_start, ramp_end, gain)
    peaks = torch.amax(rendered.abs(), dim=(1, 2))
    return rendered, peaks


def example_step_args(nframes: int = 8, n: int = 1024, num_channels: int = 2,
                      seed: int = 0):
    """Small, realistic example inputs (numpy), the same as the JAX
    package's for the same arguments."""
    rng = np.random.default_rng(seed)
    B = nframes * num_channels
    data = rng.integers(-1000, 1000, size=(B, n)).astype(np.int32)
    coeffs = np.zeros((B, lpc_ops.MAX_ORDER), np.int32)
    coeffs[:, :4] = [4, -6, 4, -1]
    shift = np.zeros(B, np.int32)
    order = np.full(B, 4, np.int32)
    wasted = np.zeros(B, np.int32)
    assign = np.full(nframes, 10, np.int32)   # mid/side
    ramp_start = np.ones(nframes, np.float32)
    ramp_end = np.ones(nframes, np.float32)
    gain = np.full(nframes, 0.8, np.float32)
    return (data, coeffs, shift, order, wasted, assign, ramp_start,
            ramp_end, gain)


def sharded_pipeline_step(mesh: Mesh, num_channels: int = 2):
    """The decode -> render -> multiroom step over ``mesh``.  Returns
    ``step(data, coeffs, shift, order, wasted, assign, ramp_start,
    ramp_end, gain, aac_spec, aac_opidx, aac_overlap, vorbis_spec)`` (the
    JAX step's arguments, numpy arrays or tensors) -> (rendered,
    room_meters, aac_pcm, aac_overlap, vorbis_time), each a
    :class:`Sharded`:

    1. :func:`decode_render_step` on frame-aligned row blocks over dp (the
       ``lpc`` kernel once a dp row); the rendered (F, C, N) tile then
       splits its samples over sp, block (i, j) on device (i, j);
    2. the AAC filterbank (``synthesis.filterbank_fast``) on the rows
       (axis 1 of aac_spec (T, B, 1024)) over dp;
    3. the Vorbis IMDCT, a float32 ``torch.matmul`` of vorbis_spec (B,
       1024) by the (1024, 2048) operator: device (i, j) multiplies row
       block i by column block j;
    4. the per-frame peak meters through :func:`room_fanout`, so every
       device holds all of them.
    """
    rows = mesh.rows()
    dp, sp = mesh.devices.shape
    consts = {str(d): asyn.filterbank_constants(device=d) for d in rows}
    op = torch.from_numpy(vsyn._imdct_op(2048))
    op_cols = {}
    for i in range(dp):
        for j, cols in enumerate(_blocks(op.shape[1], sp)):
            d = mesh.devices[i, j]
            op_cols.setdefault((str(d), j), op[:, cols].to(d))

    def step(data, coeffs, shift, order, wasted, assign, ramp_start,
             ramp_end, gain, aac_spec, aac_opidx, aac_overlap, vorbis_spec):
        nc = num_channels
        row_args = [_tensor(a) for a in (data, coeffs, shift, order,
                                         wasted)]
        frame_args = [_tensor(a) for a in (assign, ramp_start, ramp_end,
                                           gain)]
        F, N = frame_args[0].shape[0], row_args[0].shape[1]
        rendered, peaks = [], []
        for i, (d, fs) in enumerate(zip(rows, _blocks(F, dp))):
            rs = slice(fs.start * nc, fs.stop * nc)
            r, p = decode_render_step(
                *(a[rs].to(d) for a in row_args),
                *(a[fs].to(d) for a in frame_args), num_channels=nc)
            peaks.append((d, (fs,), p))
            for j, ns in enumerate(_blocks(N, sp)):
                dj = mesh.devices[i, j]
                rendered.append((dj, (fs, slice(None), ns),
                                 r[:, :, ns].to(dj)))
        room_meters, _peak = room_fanout(mesh, Sharded((F,), peaks))

        spec, opidx, ov = (_tensor(a) for a in (aac_spec, aac_opidx,
                                                aac_overlap))
        Tn, B = opidx.shape
        aac_pcm, aac_ov = [], []
        for d, bs in zip(rows, _blocks(B, dp)):
            pcm, new_ov = asyn.filterbank_fast(
                spec[:, bs].to(d), opidx[:, bs].to(d), ov[bs].to(d),
                *consts[str(d)])
            aac_pcm.append((d, (slice(None), bs, slice(None)), pcm))
            aac_ov.append((d, (bs, slice(None)), new_ov))

        vspec = _tensor(vorbis_spec)
        vt = []
        for i, bs in enumerate(_blocks(vspec.shape[0], dp)):
            for j, cols in enumerate(_blocks(op.shape[1], sp)):
                d = mesh.devices[i, j]
                _kernels.require_full_fp32(d)
                vt.append((d, (bs, cols), torch.matmul(
                    vspec[bs].to(d), op_cols[(str(d), j)])))
        return (Sharded((F, nc, N), rendered), room_meters,
                Sharded((Tn, B, 1024), aac_pcm),
                Sharded((B, 1024), aac_ov),
                Sharded((vspec.shape[0], op.shape[1]), vt))

    return step
