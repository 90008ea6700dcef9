"""The JAX package's tests of the codec plug-ins and their host copies, run
against the port.

The files are read and their cases collected by ``test_torch_av.py``'s
loader: ``ohpipeline_tpu.codecs.flac``, ``codecs.aac`` and ``codecs.mp3``
resolve to the port's plug-ins, which decode on the CPU here, and names
the JAX package re-exports from a submodule to that submodule's port
counterpart; the other codecs resolve to their host copies.  A case that
needs an oracle encoder skips as it does in the JAX package's own run,
through the file's own skip.
"""

import pytest

from test_torch_av import collect

#: The JAX test files, with the number of case functions collected from each
#: (every case function of each file: none is left out).
JAX_FILES = {
    "test_flac.py": 17, "test_containers.py": 9, "test_aac.py": 8,
    "test_mp3.py": 15, "test_mp3_vbr_seek.py": 4, "test_vorbis.py": 13,
    "test_vorbis_floor0.py": 3, "test_opus_silk.py": 19,
    "test_opus_plc.py": 4, "test_opus.py": 6, "test_opus_mp4.py": 3,
    "test_opus_celt.py": 5, "test_alac.py": 6, "test_codecs_pcm.py": 7}

CASES = [case for f in JAX_FILES for case in collect(f, globals())]


@pytest.mark.parametrize("filename", sorted(JAX_FILES))
def test_every_case_of_the_file_is_collected(filename):
    assert sum(c[0] == filename for c in CASES) == JAX_FILES[filename]
