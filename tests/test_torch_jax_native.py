"""The JAX package's tests of the native loader and the C++ parsers, run
against the port's loader (``ohpipeline_tpu_torch.host.native``) and its
byte copies of the ``.cc`` files.

The files are read and their cases collected by ``test_torch_av.py``'s
loader: ``from ohpipeline_tpu import native`` resolves to the port's
loader, and a monkeypatch of one of its names patches the port's module.
"""

import pytest

from test_torch_av import collect

#: The JAX test files, with the number of case functions collected from each.
JAX_FILES = {"test_native_flac.py": 3, "test_native_hardening.py": 6,
             "test_native_celt.py": 3}

#: Cases left out, each with its reason.
LEAVE_OUT = {
    # The port has no Python fallback to select: its MP3 Huffman decode and
    # its Vorbis packet decoder always take the native cores (a failed build
    # raises), so neither native.have_mp3_core() nor OHP_VORBIS_PY selects
    # anything, and these cases would compare the native core with itself.
    # Native vs walk is held by test_torch_mp3.py::
    # test_native_huffman_matches_the_python_walk and, on the hostile
    # packets, by test_the_native_and_python_residue_walks_agree below.
    "test_native_hardening.py": {"test_mp3_python_fallback_matches_native",
                                 "test_vorbis_python_fallback_matches_native",
                                 "test_vorbis_residue_survives_random_packets"},
}

CASES = [case for f in JAX_FILES
         for case in collect(f, globals(), leave_out=LEAVE_OUT.get(f, ()))]


@pytest.mark.parametrize("filename", sorted(JAX_FILES))
def test_every_case_of_the_file_is_collected(filename):
    assert sum(c[0] == filename for c in CASES) == JAX_FILES[filename]


def _hostile_packets(n=300, seed=4242):
    """test_native_hardening.py's hostile audio packets."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for trial in range(n):
        pkt = bytearray(rng.integers(0, 256, int(rng.integers(1, 120)),
                                     dtype=np.uint8))
        if trial % 2:
            pkt[0] &= 0xFE              # force the audio-packet bit
        out.append(bytes(pkt))
    return out


def _spectra(pkg: str, packets: list, walk: str) -> list:
    """(outcome, spectrum) of each packet through ``pkg``'s Vorbis
    PacketDecoder, its residue walk the native core (``walk="native"``) or
    the Python one (``walk="python"``, the decoder's context dropped)."""
    import importlib

    enc = importlib.import_module(f"{pkg}.codecs.vorbis.encoder")
    hdr = importlib.import_module(f"{pkg}.codecs.vorbis.headers")
    syn = importlib.import_module(f"{pkg}.codecs.vorbis.synthesis")
    spec = enc.StreamSpec(channels=2, sample_rate=44100, bs0=256, bs1=1024,
                          coupling=True)
    info = hdr.parse_identification(spec.id_packet())
    dec = syn.PacketDecoder(info, hdr.parse_setup(spec.setup_packet(),
                                                  info.channels))
    assert dec._native is not None
    if walk == "python":
        dec._native = None
    out = []
    for pkt in packets:
        try:
            out.append(("ok", dec.decode_spectrum(pkt)))
        except Exception as e:          # noqa: BLE001 - kinds compared
            out.append((type(e).__name__, None))
    return out


def test_the_native_and_python_residue_walks_agree():
    """The port's Vorbis PacketDecoder (host/codecs/vorbis/synthesis.py)
    decodes hostile packets through its native residue walk as through the
    Python one, and as the JAX package's Python walk does: outcome and
    spectrum."""
    import numpy as np

    packets = _hostile_packets()
    port = _spectra("ohpipeline_tpu_torch.host", packets, "native")
    walked = _spectra("ohpipeline_tpu_torch.host", packets, "python")
    want = _spectra("ohpipeline_tpu", packets, "python")
    decoded = 0
    for (ka, ra), (kb, rb), (kc, rc) in zip(port, walked, want):
        assert ka == kb == kc
        assert (ra is None) == (rb is None) == (rc is None)
        if ra is not None:
            assert ra[:3] == rb[:3] == rc[:3]
            np.testing.assert_array_equal(ra[3], rb[3])
            np.testing.assert_array_equal(ra[3], rc[3])
            decoded += 1
    assert decoded > 10
