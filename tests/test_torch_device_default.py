"""Every public entry point of the port runs on the card unless the caller
asks for the CPU: ``device`` defaults to "cuda", and without a card a call
that names no device raises; it does not run on the CPU."""

import inspect
import pathlib

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _host
from ohpipeline_tpu_torch.codecs.aac import serving as aac_serving
from ohpipeline_tpu_torch.codecs.flac import serving as flac_serving
from ohpipeline_tpu_torch.codecs.opus import celt
from ohpipeline_tpu_torch.entry import entry

ASSETS = pathlib.Path(__file__).resolve().parent / "assets"


def _flac():
    x = np.stack([np.arange(3000) % 200 - 100] * 2).astype(np.int32)
    return _host.encode_flac(x, 44100, 16, blocksize=1024)


CALLS = {
    "entry": (entry, lambda: ()),
    "decode_flac_streams_device": (
        flac_serving.decode_flac_streams_device, lambda: ([_flac()], 8)),
    "decode_aac_streams_device": (
        aac_serving.decode_aac_streams_device,
        lambda: ([(ASSETS / "dryrun.aac").read_bytes()],)),
    "decode_he_streams_device": (
        aac_serving.decode_he_streams_device,
        lambda: ([(ASSETS / "dryrun_he.aac").read_bytes()],)),
    "decode_celt_streams_device": (
        celt.decode_celt_streams_device,
        lambda: ([(ASSETS / "dryrun.opus").read_bytes()],)),
    "decode_celt_stream_device": (
        celt.decode_celt_stream_device,
        lambda: ((ASSETS / "dryrun.opus").read_bytes(),)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_device_defaults_to_the_card(name):
    fn, _ = CALLS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(CALLS))
def test_without_a_card_a_call_naming_no_device_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fn, args = CALLS[name]
    with pytest.raises((AssertionError, RuntimeError)):
        fn(*args())
