"""Build, bind and launch the port's hand-written CUDA kernels.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and the objects are linked into
one shared library under ``_build/`` (named by a hash of the sources, so an
edited source rebuilds; written to a temporary name and renamed into
place, so a concurrent process never loads a half-written file), which is
loaded with ``ctypes``.  Each kernel has a
plain C entry point that launches on the caller's stream and returns
``cudaGetLastError()``; the wrappers here check their tensors, launch on
``torch.cuda.current_stream()``, raise on a non-zero return and count the
launch in :data:`launches`.  Nothing falls back: a missing ``nvcc``, a
failed build, a bad argument or a failed launch raises :class:`KernelError`
(:class:`KernelArgumentError`, also a ``ValueError``, for a bad argument).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "csrc"
_BUILD = _DIR / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: nvcc flags of each source's compile step (the link adds ``-shared``).
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


class KernelError(RuntimeError):
    """A kernel could not be built, was given arguments it does not take, or
    failed to launch: a fault of the card or the build, never of a stream's
    content."""


class KernelArgumentError(KernelError, ValueError):
    """A kernel wrapper was called with tensors its kernel does not take."""


def is_device_fault(exc: BaseException) -> bool:
    """True for a :class:`KernelError` and for what torch raises when an
    operation on the card fails (``torch.AcceleratorError``, an out-of-memory
    error, or a ``RuntimeError`` or assertion that names CUDA, as torch
    raises when there is no card or driver)."""
    if isinstance(exc, (KernelError, torch.cuda.OutOfMemoryError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, (RuntimeError, AssertionError)) \
        and "CUDA" in str(exc)


def checked_device(device) -> torch.device:
    """``torch.device(device)``; raises :class:`KernelError` for a CUDA device
    when torch sees no card, so a caller that asked for the card never runs
    on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise KernelError(f"device {dev} asked for, but torch sees no CUDA "
                          f"device")
    return dev


#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches = {"lpc": 0, "rice": 0, "tns": 0, "sbr_env": 0, "celt_comb": 0,
            "mp3_window": 0, "ps_mix": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: nvcc's output of the build this process loaded (register use, spills).
build_log = ""


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def find_nvcc() -> str | None:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    return next((c for c in cands if c and os.access(c, os.X_OK)), None)


def _build() -> ctypes.CDLL:
    global build_log
    sources = sorted(_SRC.glob("*.cu"))
    digest = hashlib.sha1()
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    so = _BUILD / f"libohp_kernels-{digest.hexdigest()[:12]}.so"
    if not so.exists():
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelError("nvcc not found (set CUDA_HOME or PATH); the "
                              "port's CUDA kernels cannot be built")
        _BUILD.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:12]}.{os.getpid()}"
        objs = [_BUILD / f"{src.stem}-{tag}.o" for src in sources]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o",
                                       str(obj), str(src)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(sources, objs)]
            build_log = "".join(p.communicate()[0] for p in procs)
            failed = [src.name for src, p in zip(sources, procs)
                      if p.returncode != 0]
            if not failed:
                link = subprocess.run([nvcc, *_ARCH, "-shared", "-o",
                                       str(tmp), *map(str, objs)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                build_log += link.stdout
                failed = ["link"] if link.returncode != 0 else []
            if failed:
                raise KernelError(f"nvcc failed ({', '.join(failed)}):\n"
                                  f"{build_log}")
            os.replace(tmp, so)
        finally:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ohp_lpc_synthesize.argtypes = [p, p, p, p, p, i32, i32, p]
    lib.ohp_lpc_synthesize.restype = i32
    lib.ohp_rice_decode_units.argtypes = [p, i64, p, p, p, p, p, i64, p]
    lib.ohp_rice_decode_units.restype = i32
    lib.ohp_tns_apply.argtypes = [p, i64, p, p, p, p, i64, p]
    lib.ohp_tns_apply.restype = i32
    lib.ohp_sbr_env_map.argtypes = ([p] * 16 + [ctypes.c_float] + [p] * 10
                                    + [i64, i32, i32, p])
    lib.ohp_sbr_env_map.restype = i32
    lib.ohp_celt_comb.argtypes = [p] * 6 + [i64, i32, i32, p]
    lib.ohp_celt_comb.restype = i32
    lib.ohp_mp3_window.argtypes = [p, p, p, i32, i32, i32, p]
    lib.ohp_mp3_window.restype = i32
    lib.ohp_ps_mix.argtypes = [p] * 12 + [i32, i32, p]
    lib.ohp_ps_mix.restype = i32
    lib.ohp_ps_mix_scratch.argtypes = []
    lib.ohp_ps_mix_scratch.restype = i32
    if lib.ohp_ps_mix_scratch() != PS_SCRATCH:
        raise KernelError(f"csrc/ps_mix.cu takes {lib.ohp_ps_mix_scratch()} "
                          f"scratch floats a slot, PS_SCRATCH says "
                          f"{PS_SCRATCH}")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def _check(name: str, t: torch.Tensor, shape: tuple, device,
           dtype=torch.int32) -> None:
    if t.device != device or t.dtype != dtype \
            or not t.is_contiguous() or tuple(t.shape) != shape:
        raise KernelArgumentError(
            f"{name}: want contiguous {dtype} {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name} kernel launch failed: CUDA error {rc}")


def lpc(data: torch.Tensor, coeffs: torch.Tensor, shift: torch.Tensor,
        order: torch.Tensor) -> torch.Tensor:
    """``csrc/lpc.cu``: (B, N) int32 samples from (B, N) residuals with
    warm-up, (B, 32) coefficients and (B,) shift and order, on the card."""
    dev = data.device
    if dev.type != "cuda":
        raise KernelArgumentError(f"lpc kernel needs a CUDA tensor, got {dev}")
    B, N = data.shape
    _check("data", data, (B, N), dev)
    _check("coeffs", coeffs, (B, 32), dev)
    _check("shift", shift, (B,), dev)
    _check("order", order, (B,), dev)
    if B >= 2 ** 31 or N >= 2 ** 31:
        raise KernelArgumentError(
            f"lpc kernel takes int32 extents, got {B}x{N}")
    out = torch.empty_like(data)
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.ohp_lpc_synthesize(
            data.data_ptr(), coeffs.data_ptr(), shift.data_ptr(),
            order.data_ptr(), out.data_ptr(), B, N, _stream(dev))
    _raise_on(rc, "lpc")
    launches["lpc"] += 1
    return out


def rice(words: torch.Tensor, cur: torch.Tensor, kk: torch.Tensor,
         mode: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``csrc/rice.cu``: (U, 64) int32 residuals from the (W,) slab words
    (big-endian u32 bit patterns held in int32) and (U,) per-unit cursor,
    rice parameter, mode and count, on the card."""
    dev = words.device
    if dev.type != "cuda":
        raise KernelArgumentError(
            f"rice kernel needs a CUDA tensor, got {dev}")
    (W,), U = words.shape, cur.shape[0]
    if W == 0:
        raise KernelArgumentError("rice kernel needs a non-empty word slab")
    _check("words", words, (W,), dev)
    for name, t in (("cur", cur), ("kk", kk), ("mode", mode),
                    ("counts", counts)):
        _check(name, t, (U,), dev)
    out = torch.empty((U, 64), dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.ohp_rice_decode_units(
            words.data_ptr(), W, cur.data_ptr(), kk.data_ptr(),
            mode.data_ptr(), counts.data_ptr(), out.data_ptr(), U,
            _stream(dev))
    _raise_on(rc, "rice")
    launches["rice"] += 1
    return out


def tns(spec: torch.Tensor, tfi: torch.Tensor, tco: torch.Tensor,
        tdir: torch.Tensor, trow: torch.Tensor) -> None:
    """``csrc/tns.cu``: TNS-filter the rows ``trow`` (P,) int32 of ``spec``
    (TB, 1024) float32 in place on the card, from the TnsPool planes tfi
    (P, 1024) uint8, tco (P, 24, 12) float32 and tdir (P, 24) uint8.  Rows
    outside [0, TB) are padding.  The kernel reads rows, slot bytes and
    coefficients 16 bytes at a time, so every base pointer must be 16-byte
    aligned."""
    dev = spec.device
    if dev.type != "cuda":
        raise KernelArgumentError(f"tns kernel needs a CUDA tensor, got {dev}")
    TB, P = spec.shape[0], trow.shape[0]
    _check("spec", spec, (TB, 1024), dev, torch.float32)
    _check("tfi", tfi, (P, 1024), dev, torch.uint8)
    _check("tco", tco, (P, 24, 12), dev, torch.float32)
    _check("tdir", tdir, (P, 24), dev, torch.uint8)
    _check("trow", trow, (P,), dev)
    for name, t in (("spec", spec), ("tfi", tfi), ("tco", tco)):
        if t.data_ptr() % 16:
            raise KernelArgumentError(
                f"tns kernel: {name} is not 16-byte aligned")
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.ohp_tns_apply(spec.data_ptr(), TB, tfi.data_ptr(),
                               tco.data_ptr(), tdir.data_ptr(),
                               trow.data_ptr(), P, _stream(dev))
    _raise_on(rc, "tns")
    launches["tns"] += 1


#: Envelope count (MAXE), buffered slots per frame (NSL) and output slots
#: per frame of the SBR frame scan, fixed in ``csrc/sbr_env.cu``.
SBR_ENV, SBR_SLOTS, SBR_OUT = 8, 38, 32


def sbr_env(gain, noise, sine, sine_bins, env_id, prev_id, last_env, r,
            carry_mask, k_ord, noise_idx0, sine_ph0, no_noise, noise_re,
            noise_im, parity, inject_cal, er, ei, filt, tail_r, tail_i):
    """``csrc/sbr_env.cu``: the SBR frame scan on the card, with the
    arguments of ``codecs.aac.sbr.envelope_scan`` and the results of
    ``envelope_scan_torch``: (C, F, 8, M) float32 envelope planes, (C, F,
    38) int8 env_id / prev_id, (C, F) int8 last_env, (C, F, 38) float32 r /
    carry_mask, (C, F, 38) int32 k_ord, (C,) int32 noise_idx0 / sine_ph0,
    (C, F, 8) float32 no_noise, (512,) float32 noise tables, (M,) float32
    parity, the float inject_cal, (C, F, 38, M) float32 er / ei, (C, 2, M)
    filt and (C, 6, M) tails.  Returns new tensors (out_r, out_i (C, F, 32,
    M), filt, tail_r, tail_i)."""
    dev = gain.device
    if dev.type != "cuda":
        raise KernelArgumentError(
            f"sbr_env kernel needs a CUDA tensor, got {dev}")
    C, F, _, M = gain.shape
    if F < 1 or C * F * SBR_SLOTS * M >= 2 ** 31:
        raise KernelArgumentError(
            f"sbr_env kernel takes 1 <= F and C*F*38*M < 2^31, "
            f"got C={C} F={F} M={M}")
    f32, i8, i32 = torch.float32, torch.int8, torch.int32
    for name, t in (("gain", gain), ("noise", noise), ("sine", sine),
                    ("sine_bins", sine_bins)):
        _check(name, t, (C, F, SBR_ENV, M), dev, f32)
    for name, t in (("env_id", env_id), ("prev_id", prev_id)):
        _check(name, t, (C, F, SBR_SLOTS), dev, i8)
    _check("last_env", last_env, (C, F), dev, i8)
    for name, t in (("r", r), ("carry_mask", carry_mask)):
        _check(name, t, (C, F, SBR_SLOTS), dev, f32)
    _check("k_ord", k_ord, (C, F, SBR_SLOTS), dev, i32)
    for name, t in (("noise_idx0", noise_idx0), ("sine_ph0", sine_ph0)):
        _check(name, t, (C,), dev, i32)
    _check("no_noise", no_noise, (C, F, SBR_ENV), dev, f32)
    for name, t in (("noise_re", noise_re), ("noise_im", noise_im)):
        _check(name, t, (512,), dev, f32)
    _check("parity", parity, (M,), dev, f32)
    for name, t in (("er", er), ("ei", ei)):
        _check(name, t, (C, F, SBR_SLOTS, M), dev, f32)
    _check("filt", filt, (C, 2, M), dev, f32)
    for name, t in (("tail_r", tail_r), ("tail_i", tail_i)):
        _check(name, t, (C, SBR_SLOTS - SBR_OUT, M), dev, f32)
    out_r = torch.empty((C, F, SBR_OUT, M), dtype=f32, device=dev)
    out_i = torch.empty_like(out_r)
    filt_out = torch.empty_like(filt)
    tail_r_out = torch.empty_like(tail_r)
    tail_i_out = torch.empty_like(tail_i)
    ins = (gain, noise, sine, sine_bins, env_id, prev_id, last_env, r,
           carry_mask, k_ord, noise_idx0, sine_ph0, no_noise, noise_re,
           noise_im, parity)
    outs = (out_r, out_i, filt_out, tail_r_out, tail_i_out)
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.ohp_sbr_env_map(
            *(t.data_ptr() for t in ins), ctypes.c_float(inject_cal),
            *(t.data_ptr() for t in (er, ei, filt, tail_r, tail_i) + outs),
            C, F, M, _stream(dev))
    _raise_on(rc, "sbr_env")
    launches["sbr_env"] += 1
    return outs


#: Samples per frame and carried history of the CELT comb, fixed in
#: ``csrc/celt_comb.cu``.
CELT_N, CELT_HLEN = 960, 1026


def celt_comb(y: torch.Tensor, Tv: torch.Tensor, gt: torch.Tensor,
              win2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/celt_comb.cu``: the CELT comb post-filter over a group on the
    card, with the arguments and results of ``codecs.opus.celt.comb_torch``:
    y (R, 1026 + F * 960) float32 rows (carried history, then F frames),
    Tv (S, F, 3) int32 lags and gt (S, F, 3, 3) float32 tap gains shared by
    the R / S rows of a stream, win2 (120,) float32.  The kernel copies
    rows 8 bytes at a time, so y must be 8-byte aligned.  Returns new
    tensors (out (R, F * 960), hist (R, 1026))."""
    dev = y.device
    if dev.type != "cuda":
        raise KernelArgumentError(
            f"celt_comb kernel needs a CUDA tensor, got {dev}")
    R, W = y.shape
    S, F = Tv.shape[:2]
    if S == 0 or R % S or W != CELT_HLEN + F * CELT_N:
        raise KernelArgumentError(
            f"celt_comb: {R} rows of {W} samples do not fit "
            f"{S} streams of {F} frames")
    if F * CELT_N >= 2 ** 31:
        raise KernelArgumentError(
            f"celt_comb kernel takes int32 extents, got F={F}")
    _check("y", y, (R, W), dev, torch.float32)
    _check("Tv", Tv, (S, F, 3), dev)
    _check("gt", gt, (S, F, 3, 3), dev, torch.float32)
    _check("win2", win2, (120,), dev, torch.float32)
    if y.data_ptr() % 8:
        raise KernelArgumentError("celt_comb kernel: y is not 8-byte aligned")
    out = torch.empty((R, F * CELT_N), dtype=torch.float32, device=dev)
    hist = torch.empty((R, CELT_HLEN), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.ohp_celt_comb(y.data_ptr(), Tv.data_ptr(), gt.data_ptr(),
                               win2.data_ptr(), out.data_ptr(),
                               hist.data_ptr(), R, R // S, F, _stream(dev))
    _raise_on(rc, "celt_comb")
    launches["celt_comb"] += 1
    return out, hist


#: Polyphase slots per granule and carried V rows of the MP3 window pass,
#: and its blocks' extent: one channel and a run of 4 granules, all of whose
#: rows a block requests at once into a ring of 128 V rows.  Fixed in
#: ``csrc/mp3_window.cu``.
MP3_SLOTS, MP3_HIST = 18, 15
MP3_RUN, MP3_RING = 4, 128


def mp3_window(vfull: torch.Tensor, wnd: torch.Tensor,
               bit_depth: int = 16) -> torch.Tensor:
    """``csrc/mp3_window.cu``: the MP3 polyphase window pass on the card,
    with the arguments and result of
    ``codecs.mp3.synthesis.mp3_window_torch``: vfull (15 + 18 Tg, B, 64)
    float32 (the carried V history oldest first, then the group's slots)
    and wnd (16, 32) float32 -> (Tg, B, 576) int32 PCM in the bit_depth
    range.  The kernel moves vfull 16 bytes at a time, so it must be
    16-byte aligned (and so is the output it allocates)."""
    dev = vfull.device
    if dev.type != "cuda":
        raise KernelArgumentError(
            f"mp3_window kernel needs a CUDA tensor, got {dev}")
    T, B = vfull.shape[0] - MP3_HIST, vfull.shape[1]
    if T <= 0 or T % MP3_SLOTS:
        raise KernelArgumentError(
            f"mp3_window: {T} slots after the {MP3_HIST}-row "
            f"history is not a whole number of granules")
    if not 1 <= bit_depth <= 24:
        raise KernelArgumentError(
            f"mp3_window kernel takes bit depths 1-24, got "
            f"{bit_depth}")
    Tg = T // MP3_SLOTS
    if vfull.numel() >= 2 ** 31 or Tg * B * 576 >= 2 ** 31 \
            or B > 65535:
        raise KernelArgumentError(
            f"mp3_window kernel takes int32 extents and at most "
            f"65535 channels, got Tg={Tg} B={B}")
    _check("vfull", vfull, (MP3_HIST + T, B, 64), dev, torch.float32)
    _check("wnd", wnd, (16, 32), dev, torch.float32)
    if vfull.data_ptr() % 16:
        raise KernelArgumentError(
            "mp3_window kernel: vfull is not 16-byte aligned")
    out = torch.empty((Tg, B, 576), dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.ohp_mp3_window(vfull.data_ptr(), wnd.data_ptr(),
                                out.data_ptr(), Tg, B, bit_depth,
                                _stream(dev))
    _raise_on(rc, "mp3_window")
    launches["mp3_window"] += 1
    return out


#: Channels of a PS slot, mixing groups, and the sizes of one stream's scan
#: carry and of the packed coefficient and index tables of the PS scan, fixed
#: in ``csrc/ps_mix.cu`` (the layouts ``PS_CARRY``, ``PS_COEF`` and
#: ``PS_IMAP`` of ``codecs.aac.sbr``), and the scratch floats a slot of a
#: stream takes between its stages (the group powers, ppd and nrg, 20 each;
#: the all-pass channels' d, 32 re and 32 im).
PS_CH, PS_MIX, PS_NCARRY, PS_NCOEF, PS_NIMAP = 73, 22, 2104, 367, 787
PS_SCRATCH = 124


def ps_mix(mr: torch.Tensor, mi: torch.Tensor, H: torch.Tensor,
           carry: torch.Tensor, coef: torch.Tensor,
           imap: torch.Tensor) -> tuple:
    """``csrc/ps_mix.cu``: the parametric-stereo decorrelator and mixer scan
    on the card, with the arguments and results of
    ``codecs.aac.sbr.ps_scan_torch``: mr, mi (C, S, 73) float32 mid slots,
    H (C, S, 4, 22) float32 mixing matrices, carry (C, 2104) float32,
    coef (367,) float32 and imap (787,) int32.  Three kernels back to back
    (group powers, the chains with one block a stream, the mix), one launch
    counted; their (C, S, 124) float32 scratch is allocated here.  Returns
    new tensors (Lr, Li, Rr, Ri (C, S, 73), carry)."""
    dev = mr.device
    if dev.type != "cuda":
        raise KernelArgumentError(
            f"ps_mix kernel needs a CUDA tensor, got {dev}")
    C, S = mr.shape[:2]
    if not (1 <= C <= 65535 and 1 <= S and S * PS_CH < 2 ** 31):
        raise KernelArgumentError(
            f"ps_mix kernel takes 1 <= C <= 65535 and 1 <= S "
            f"with S*73 < 2^31, got C={C} S={S}")
    f32 = torch.float32
    _check("mr", mr, (C, S, PS_CH), dev, f32)
    _check("mi", mi, (C, S, PS_CH), dev, f32)
    _check("H", H, (C, S, 4, PS_MIX), dev, f32)
    _check("carry", carry, (C, PS_NCARRY), dev, f32)
    _check("coef", coef, (PS_NCOEF,), dev, f32)
    _check("imap", imap, (PS_NIMAP,), dev)
    outs = [torch.empty_like(mr) for _ in range(4)]
    carry_out = torch.empty_like(carry)
    scratch = torch.empty((C, S, PS_SCRATCH), dtype=f32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.ohp_ps_mix(
            *(t.data_ptr() for t in (mr, mi, H, carry, coef, imap, scratch,
                                     *outs, carry_out)), C, S, _stream(dev))
    _raise_on(rc, "ps_mix")
    launches["ps_mix"] += 1
    return (*outs, carry_out)
