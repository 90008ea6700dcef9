"""This tree's CUDA kernels against other trees' versions of them, on the card.

    python -m ohpipeline_tpu_torch.tools.kernel_ab OTHER [OTHER ...]  # root

    python -m ohpipeline_tpu_torch.tools.kernel_ab OTHER --only ps_mix

Each OTHER is a directory holding another version's
``ohpipeline_tpu_torch/csrc`` (for example the parent commit's, unpacked
with ``git archive``, or a patched copy of this tree's).  Its ``lpc.cu``,
``rice.cu``, ``tns.cu``, ``sbr_env.cu``, ``celt_comb.cu``, ``mp3_window.cu``
and ``ps_mix.cu`` (those of them it has: a tree from before a kernel was
ported is compared on the others) are built with nvcc for sm_90a into
``OTHER/_ab/`` and loaded with ctypes.  ``--only`` names the kernels
compared (all by default).  Each keeps its C entry point, and where the
argument lists differ each tree is fed its own form: a ``sbr_env.cu`` with
``ohp_sbr_env_map`` takes the compact arguments (noise and sine made in the
kernel from the counters), one with ``ohp_sbr_env_scan`` the noise and sine
planes made beforehand by ``codecs.aac.sbr.plane_args``; a ``ps_mix.cu``
with ``ohp_ps_mix_scratch`` takes a scratch plane of that many floats a
slot after ``imap``, one without it (the one-kernel design) none.  A
version is named by its directory; this tree's own kernels are the
package's build (``_kernels.library()``), named ``this``.

Shapes, as ``chip_smoke.py`` makes them: LPC on the 1152 x 4096 synthetic
group (``lpc_case``), on the rows of the first FLAC serving group of the
smoke content and on its first 4 rows alone; the rice decode on that
group's units, on ``rice_worst_case`` and on the group's first 32 units
alone (one warp); TNS on the first AAC-LC
serving group's TnsPool planes, on the 1024-row worst case and on the
group's row with the longest run alone; the SBR frame scan on the first
HE-AAC serving group and the worst cases at 24 and 40 bins; the CELT comb on
the first CELT serving group, on the worst case and on the group's first row
alone; the MP3 window pass on the first MP3 serving group of the smoke
content (Tg 64, B 32) and on ``mp3_window_case`` at 16 and 24 bits; the PS
decorrelator scan on the first PS group of ``ps_content``'s stream 0 (one
stream, S = 3072), on ``ps_mix_worst_case`` (16 streams) and on that case's
first stream alone.  A few rows (one stream) alone time the
chain of one row (stream) plus a launch: the chain floor.  Every version's
output is held to this tree's (LPC, rice, SBR, CELT, MP3 and PS bit for bit,
TNS within 1e-5 of each row's peak); then the versions are timed in turns, each
and then each again in reverse order, with ``chip_smoke.kernel_ms`` (REPS
launches in one CUDA graph).  Prints one line
per shape, the card's name and power limit, and one JSON line.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from .. import _kernels
from . import smoke

#: The kernels compared, each built from OTHER's ``csrc/<name>.cu``.
KERNELS = ("lpc", "rice", "tns", "sbr_env", "celt_comb", "mp3_window",
           "ps_mix")
_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: Every C entry point a tree's kernels may have, with its argument types.
ENTRY = {
    "ohp_lpc_synthesize": [_p] * 5 + [_i32, _i32, _p],
    "ohp_rice_decode_units": [_p, _i64, _p, _p, _p, _p, _p, _i64, _p],
    "ohp_tns_apply": [_p, _i64, _p, _p, _p, _p, _i64, _p],
    "ohp_sbr_env_map": ([_p] * 16 + [ctypes.c_float] + [_p] * 10
                        + [_i64, _i32, _i32, _p]),
    "ohp_sbr_env_scan": [_p] * 23 + [_i64, _i32, _i32, _p],
    "ohp_celt_comb": [_p] * 6 + [_i64, _i32, _i32, _p],
    "ohp_mp3_window": [_p] * 3 + [_i32, _i32, _i32, _p],
    "ohp_ps_mix_scratch": [],
    "ohp_ps_mix": [_p] * 12 + [_i32, _i32, _p],
}


def build(sources: list, out: pathlib.Path) -> ctypes.CDLL:
    """nvcc ``sources`` into the shared library ``out`` and bind whichever
    entry points of ``ENTRY`` it has."""
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS,
                           "-shared", "-o", str(out),
                           *map(str, sources)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {out.name}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in ENTRY.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, _i32
    if hasattr(lib, "ohp_ps_mix") and not hasattr(lib, "ohp_ps_mix_scratch"):
        lib.ohp_ps_mix.argtypes = [_p] * 11 + [_i32, _i32, _p]
    return lib


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ok(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def lpc_call(lib, args):
    data, coeffs, shift, order = args
    out = torch.empty_like(data)
    B, N = data.shape
    _ok(lib.ohp_lpc_synthesize(data.data_ptr(), coeffs.data_ptr(),
                               shift.data_ptr(), order.data_ptr(),
                               out.data_ptr(), B, N, _stream()), "lpc")
    return out


def rice_launcher(lib, words, cur, kk, mode, counts):
    """A function that launches ``lib``'s rice decode of the units into an
    output allocated once; it returns [out]."""
    U = cur.shape[0]
    out = torch.empty((U, 64), dtype=torch.int32, device=words.device)

    def run():
        _ok(lib.ohp_rice_decode_units(
            words.data_ptr(), words.shape[0], cur.data_ptr(), kk.data_ptr(),
            mode.data_ptr(), counts.data_ptr(), out.data_ptr(), U,
            _stream()), "rice")
        return [out]

    return run


def tns_call(lib, spec, tfi, tco, tdir, trow):
    _ok(lib.ohp_tns_apply(spec.data_ptr(), spec.shape[0], tfi.data_ptr(),
                          tco.data_ptr(), tdir.data_ptr(), trow.data_ptr(),
                          trow.shape[0], _stream()), "tns")
    return spec


def sbr_launcher(lib, args):
    """A function that launches ``lib``'s SBR frame scan on the compact
    arguments ``args``, in the form that tree's kernel takes (the planes
    made here, before any launch, for an ``ohp_sbr_env_scan`` tree), into
    outputs allocated once; it returns them."""
    from ..codecs.aac import sbr as sbrd

    C, F, _, M = args[0].shape
    out_r = torch.empty((C, F, 32, M), device=args[0].device)
    outs = (out_r, torch.empty_like(out_r), torch.empty_like(args[-3]),
            torch.empty_like(args[-2]), torch.empty_like(args[-1]))
    if hasattr(lib, "ohp_sbr_env_map"):
        ins = args
        ptrs = [*(t.data_ptr() for t in args[:16]), ctypes.c_float(args[16]),
                *(t.data_ptr() for t in (*args[17:], *outs))]
        fn = lib.ohp_sbr_env_map
    else:
        ins = sbrd.plane_args(*args)
        ptrs = [t.data_ptr() for t in (*ins, *outs)]
        fn = lib.ohp_sbr_env_scan

    def run(ins=ins):           # holds the tensors behind the pointers
        _ok(fn(*ptrs, C, F, M, _stream()), "sbr_env")
        return outs

    return run


def celt_launcher(lib, y, Tv, gt, win2):
    """A function that launches ``lib``'s comb on the rows ``y`` into
    outputs allocated once; it returns them."""
    R, S, F = y.shape[0], Tv.shape[0], Tv.shape[1]
    out = torch.empty((R, F * _kernels.CELT_N), device=y.device)
    hist = torch.empty((R, _kernels.CELT_HLEN), device=y.device)

    def run():
        _ok(lib.ohp_celt_comb(y.data_ptr(), Tv.data_ptr(), gt.data_ptr(),
                              win2.data_ptr(), out.data_ptr(),
                              hist.data_ptr(), R, R // S, F, _stream()),
            "celt_comb")
        return out, hist

    return run


def ps_launcher(lib, mr, mi, H, carry, coef, imap):
    """A function that launches ``lib``'s PS scan into outputs allocated
    once; it returns them."""
    C, S = mr.shape[:2]
    outs = [*(torch.empty_like(mr) for _ in range(4)), torch.empty_like(carry)]
    scratch = []
    if hasattr(lib, "ohp_ps_mix_scratch"):
        scratch = [torch.empty((C, S, lib.ohp_ps_mix_scratch()),
                               device=mr.device)]
    ptrs = [t.data_ptr() for t in (mr, mi, H, carry, coef, imap, *scratch,
                                   *outs)]

    def run(scratch=scratch):   # holds the scratch behind its pointer
        _ok(lib.ohp_ps_mix(*ptrs, C, S, _stream()), "ps_mix")
        return outs

    return run


def mp3_launcher(lib, vfull, wnd, bit_depth):
    """A function that launches ``lib``'s MP3 window pass into an output
    allocated once; it returns [out]."""
    Tg, B = (vfull.shape[0] - _kernels.MP3_HIST) // 18, vfull.shape[1]
    out = torch.empty((Tg, B, 576), dtype=torch.int32, device=vfull.device)

    def run():
        _ok(lib.ohp_mp3_window(vfull.data_ptr(), wnd.data_ptr(),
                               out.data_ptr(), Tg, B, bit_depth, _stream()),
            "mp3_window")
        return [out]

    return run


def flac_group_planes(cs, dev) -> dict:
    """The wire planes, on ``dev``, of the first FLAC serving group of
    chip_smoke.py's content (its 18 streams, encoded in spawned workers)."""
    from ..codecs import flac
    from ..codecs.flac.serving import iter_groups

    _, encoded = cs.flac_content()
    planes, _ = next(iter_groups([b for _, b in encoded],
                                 cs.FRAMES_PER_GROUP))
    return flac.to_device(planes, dev)


def aac_group_pool(cs) -> tuple:
    """chip_smoke.py phase 6's first AAC-LC serving group: seeded spectra
    and the group's TnsPool planes."""
    from ..codecs.aac.serving import iter_groups

    planes0, _ = next(iter_groups(cs.aac_streams(), cs.AAC_FRAMES_PER_GROUP))
    TB = planes0["q4"].shape[0] * planes0["q4"].shape[1]
    spec = (np.random.default_rng(6).standard_normal((TB, 1024))
            * 3000).astype(np.float32)
    return (spec, *(planes0[k] for k in ("tfi", "tco", "tdir", "trow")))


def longest_run_row(spec, tfi, tco, tdir, trow) -> tuple:
    """The pool with only the pooled row that holds the longest run (a
    maximal stretch of one slot byte) left live: its time is the kernel's
    chain plus a launch, with no other row competing."""
    f = tfi.astype(np.int64)
    live = (trow >= 0) & (trow < spec.shape[0])
    best, at = -1, 0
    for j in np.nonzero(live)[0]:
        edges = np.flatnonzero(np.diff(f[j]) != 0)
        bounds = np.concatenate([[-1], edges, [1023]])
        for lo, hi in zip(bounds[:-1] + 1, bounds[1:]):
            if f[j, lo] and hi - lo + 1 > best:
                best, at = hi - lo + 1, j
    one = np.full_like(trow, -1)
    one[at] = trow[at]
    return spec, tfi, tco, tdir, one


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=pathlib.Path, nargs="+",
                    help="directory holding ohpipeline_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS,
                    help="the kernels compared")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    cs = smoke()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = {"this": _kernels.library()}
    for other in a.other:
        src = other / "ohpipeline_tpu_torch" / "csrc"
        libs[other.name] = build([src / f"{k}.cu" for k in a.only
                                  if (src / f"{k}.cu").exists()],
                                 other / "_ab" / "libab.so")

    failed = []

    def timed(shape, fns: dict, agrees) -> dict:
        """Hold every other version to this tree's, then time in turns:
        each version, then each again in reverse order.  A version that
        disagrees is timed all the same and the run fails at its end."""
        for name in fns:
            torch.cuda.synchronize()
            if name != "this" and not agrees(name):
                failed.append(f"{shape}: {name} != this tree's")
                print(failed[-1])
        ms = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            ms[name].append(cs.kernel_ms(fns[name], a.reps))
        return ms

    def same(runs):
        """Each version's outputs bit for bit against this tree's."""
        want = [t.clone() for t in runs["this"]()]
        return lambda name: all(torch.equal(g, w) for g, w in
                                zip(runs[name](), want))

    from ..codecs import flac
    from ..codecs.flac import rice

    result = {}
    if "lpc" in a.only or "rice" in a.only:
        t = flac_group_planes(cs, dev)
        group = cs.lpc_group_inputs(t)
    if "lpc" in a.only:
        lpc_shapes = {"lpc synthetic 1152x4096":
                      [torch.from_numpy(x).to(dev) for x in cs.lpc_case()],
                      "lpc serving group 0": group,
                      "lpc serving group 0, first 4 rows (chain floor)":
                      [t[:4] for t in group]}
        for shape, args in lpc_shapes.items():
            runs = {k: (lambda lib=lib, args=args: [lpc_call(lib, args)])
                    for k, lib in libs.items()}
            result[shape] = timed(shape, runs, same(runs))
    if "rice" in a.only:
        lanes = rice.unit_lanes(*(t[k] for k in flac.RICE_PLANES[:7]))
        rice_shapes = {"rice serving group 0": lanes,
                       "rice worst case": [torch.from_numpy(a).to(dev)
                                           for a in cs.rice_worst_case()],
                       "rice serving group 0, first 32 units (chain floor)":
                       [lanes[0], *(x[:32] for x in lanes[1:])]}
        for shape, args in rice_shapes.items():
            runs = {k: rice_launcher(lib, *args) for k, lib in libs.items()}
            result[shape] = timed(shape, runs, same(runs))
    if "tns" in a.only:
        pool0 = aac_group_pool(cs)
        tns_shapes = {"tns serving group 0": pool0,
                      "tns worst case": cs.tns_worst_case(),
                      "tns serving group 0, the row of its longest run "
                      "(chain floor)": longest_run_row(*pool0)}
        for shape, arrays in tns_shapes.items():
            spec, *pool = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                           for x in arrays]
            want = tns_call(libs["this"], spec.clone(), *pool)
            rows = pool[3][(pool[3] >= 0) & (pool[3] < spec.shape[0])].long()

            def close(name, spec=spec, pool=pool, want=want, rows=rows):
                got = tns_call(libs[name], spec.clone(), *pool)
                err = (got[rows] - want[rows]).abs().amax(1)
                return bool((err <= 1e-5 * want[rows].abs().amax(1)).all())

            work = spec.clone()  # filtered in place, over and over
            result[shape] = timed(
                shape, {k: (lambda lib=libs[k], work=work, pool=pool:
                            tns_call(lib, work, *pool)) for k in libs},
                close)
    from ..codecs.aac import sbr as sbrd
    from ..codecs.aac.serving import decode_he_streams_device

    if "sbr_env" in a.only:
        _, seen = cs.first_calls(sbrd, ["envelope_scan"], lambda: (
            decode_he_streams_device(cs.he_streams(), cs.HE_FRAMES_PER_GROUP,
                                     device="cuda")))
        he0 = seen["envelope_scan"][0]
        sbr_shapes = {"sbr_env serving HE group 0": he0,
                      "sbr_env worst case": cs.sbr_env_case(dev, M=24),
                      "sbr_env worst case, 40 bins":
                      cs.sbr_env_case(dev, M=40)}
        for shape, args in sbr_shapes.items():
            runs = {k: sbr_launcher(lib, args) for k, lib in libs.items()}
            result[shape] = timed(shape, runs, same(runs))
    if "celt_comb" in a.only:
        from ..codecs.opus import celt as pc

        _, seen = cs.first_calls(pc, ["comb"], lambda: (
            pc.decode_celt_streams_device(cs.celt_streams(), cs.CELT_GROUP)))
        y, Tv, gt, win2 = seen["comb"][0]
        celt_shapes = {"celt_comb serving group 0": (y, Tv, gt),
                       "celt_comb worst case": cs.celt_comb_worst_case(dev),
                       "celt_comb serving group 0, first row alone (chain "
                       "floor)": (y[:1].contiguous(), Tv[:1], gt[:1])}
        for shape, (y_, Tv_, gt_) in celt_shapes.items():
            runs = {k: celt_launcher(lib, y_, Tv_, gt_, win2)
                    for k, lib in libs.items()}
            result[shape] = timed(shape, runs, same(runs))
    if "mp3_window" in a.only:
        from ..codecs.mp3 import synthesis as msyn
        from ..codecs.mp3.serving import decode_mp3_streams_device

        _, seen = cs.first_calls(msyn, ["mp3_window"], lambda: (
            decode_mp3_streams_device(cs.codec_content()["mp3"],
                                      cs.MP3_FRAMES_PER_GROUP,
                                      device="cuda")))
        vfull0, wnd, bd0 = seen["mp3_window"][0]
        worst = cs.mp3_window_case(dev)
        mp3_shapes = {"mp3_window serving MP3 group 0": (vfull0, bd0),
                      "mp3_window worst case, 16 bits": (worst, 16),
                      "mp3_window worst case, 24 bits": (worst, 24)}
        for shape, (vfull, bd) in mp3_shapes.items():
            runs = {k: mp3_launcher(lib, vfull, wnd, bd)
                    for k, lib in libs.items()
                    if hasattr(lib, "ohp_mp3_window")}
            result[shape] = timed(shape, runs, same(runs))
    if "ps_mix" in a.only:
        _, seen = cs.first_calls(sbrd, ["ps_scan"], lambda: cs.serve_ps(
            [cs.ps_content(0, cs.PS_GROUP)], "cuda"))
        worst = cs.ps_mix_worst_case(dev)
        ps_shapes = {"ps_mix PS group 0": seen["ps_scan"][0],
                     "ps_mix worst case": worst,
                     "ps_mix worst case, first stream alone (chain floor)":
                     [a[:1] if a.dim() > 1 else a for a in worst]}
        for shape, args in ps_shapes.items():
            runs = {k: ps_launcher(lib, *args) for k, lib in libs.items()
                    if hasattr(lib, "ohp_ps_mix")}
            result[shape] = timed(shape, runs, same(runs))
    for shape, ms in result.items():
        cells = "  ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms"
                          for k, v in ms.items())
        print(f"{shape}: {cells}")
    print(card)
    print(json.dumps({"card": card, "reps": a.reps, "ms": result}))
    if failed:
        sys.exit("kernel_ab: " + "; ".join(failed))


if __name__ == "__main__":
    main()
