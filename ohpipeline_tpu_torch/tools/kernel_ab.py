"""The LPC and TNS kernels of this tree against other trees', on the card.

    python -m ohpipeline_tpu_torch.tools.kernel_ab OTHER [OTHER ...]  # root

Each OTHER is a directory holding another version's
``ohpipeline_tpu_torch/csrc`` (for example the parent commit's, unpacked
with ``git archive``, or a patched copy of this tree's).  Its ``lpc.cu`` and
``tns.cu`` are built with nvcc for sm_90a into ``OTHER/_ab/`` and loaded
with ctypes; they must keep the C entry points ``ohp_lpc_synthesize`` and
``ohp_tns_apply``.  A version is named by its directory; this tree's own
kernels are the package's build (``_kernels.library()``), named ``this``.

Shapes, as ``chip_smoke.py`` makes them: LPC on the 1152 x 4096 synthetic
group (``lpc_case``), on the rows of the first FLAC serving group of the
smoke content and on its first 4 rows alone; TNS on the first AAC-LC
serving group's TnsPool planes, on the 1024-row worst case and on the
group's row with the longest run alone.  A few rows alone time the chain of
one row plus a launch: the chain floor.  Every version's output is held to
this tree's (LPC bit for bit, TNS within 1e-5 of each row's peak); then the
versions are timed in turns, each and then each again in reverse order,
with ``chip_smoke.kernel_ms`` (REPS launches in one CUDA graph).  Prints one
line per shape, the card's name and power limit, and one JSON line.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing as mp
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from .. import _kernels


def _smoke():
    sys.path.insert(0, ".")
    import chip_smoke

    return chip_smoke


def build(sources: list, out: pathlib.Path) -> ctypes.CDLL:
    """nvcc ``sources`` into the shared library ``out`` and bind its LPC
    and TNS entry points."""
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
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ohp_lpc_synthesize.argtypes = [p, p, p, p, p, i32, i32, p]
    lib.ohp_lpc_synthesize.restype = i32
    lib.ohp_tns_apply.argtypes = [p, i64, p, p, p, p, i64, p]
    lib.ohp_tns_apply.restype = i32
    return lib


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def lpc_call(lib, args):
    data, coeffs, shift, order = args
    out = torch.empty_like(data)
    B, N = data.shape
    rc = lib.ohp_lpc_synthesize(data.data_ptr(), coeffs.data_ptr(),
                                shift.data_ptr(), order.data_ptr(),
                                out.data_ptr(), B, N, _stream())
    if rc:
        raise RuntimeError(f"lpc launch failed: CUDA error {rc}")
    return out


def tns_call(lib, spec, tfi, tco, tdir, trow):
    rc = lib.ohp_tns_apply(spec.data_ptr(), spec.shape[0], tfi.data_ptr(),
                           tco.data_ptr(), tdir.data_ptr(), trow.data_ptr(),
                           trow.shape[0], _stream())
    if rc:
        raise RuntimeError(f"tns launch failed: CUDA error {rc}")
    return spec


def flac_group_rows(cs, dev) -> list:
    """The LPC arguments of the first FLAC serving group of chip_smoke.py's
    content (its 18 streams, encoded in spawned workers)."""
    from ..codecs import flac
    from ..codecs.flac.serving import iter_groups

    jobs = ([(s, cs.CD_SECONDS, 44100, 16) for s in cs.CD_SEEDS]
            + [(s, cs.HIRES_SECONDS, 96000, 24) for s in cs.HIRES_SEEDS])
    with mp.get_context("spawn").Pool(min(len(jobs), os.cpu_count() or 1)) \
            as pool:
        streams = [b for _, b in pool.map(cs.encode_job, jobs)]
    planes, _ = next(iter_groups(streams, cs.FRAMES_PER_GROUP))
    return cs.lpc_group_inputs(flac.to_device(planes, dev))


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
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    cs = _smoke()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = {"this": _kernels.library()}
    for other in a.other:
        src = other / "ohpipeline_tpu_torch" / "csrc"
        libs[other.name] = build([src / "lpc.cu", src / "tns.cu"],
                                 other / "_ab" / "libab.so")

    def timed(fns: dict, agrees) -> dict:
        """Hold every other version to this tree's, then time in turns:
        each version, then each again in reverse order."""
        for name in fns:
            torch.cuda.synchronize()
            if name != "this" and not agrees(name):
                raise AssertionError(f"{shape}: {name} != this tree's")
        ms = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            ms[name].append(cs.kernel_ms(fns[name], a.reps))
        return ms

    result = {}
    group = flac_group_rows(cs, dev)
    lpc_shapes = {"lpc synthetic 1152x4096":
                  [torch.from_numpy(x).to(dev) for x in cs.lpc_case()],
                  "lpc serving group 0": group,
                  "lpc serving group 0, first 4 rows (chain floor)":
                  [t[:4] for t in group]}
    for shape, args in lpc_shapes.items():
        want = lpc_call(libs["this"], args)
        result[shape] = timed(
            {k: (lambda lib=libs[k], args=args: lpc_call(lib, args))
             for k in libs},
            lambda name, args=args, want=want: torch.equal(
                lpc_call(libs[name], args), want))
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
            {k: (lambda lib=libs[k], work=work, pool=pool:
                 tns_call(lib, work, *pool)) for k in libs},
            close)
    for shape, ms in result.items():
        cells = "  ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms"
                          for k, v in ms.items())
        print(f"{shape}: {cells}")
    print(card)
    print(json.dumps({"card": card, "reps": a.reps, "ms": result}))


if __name__ == "__main__":
    main()
