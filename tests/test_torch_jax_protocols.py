"""The JAX package's tests of the protocols, run against the port's copies
(``ohpipeline_tpu_torch.host.protocols``): HTTP (a changed copy), DASH and
HLS (whole copies), through ``test_torch_av.py``'s loader.
"""

import pytest

from test_torch_av import collect

#: The JAX test files, with the number of case functions collected from each
#: (every case function of each file: none is left out).
JAX_FILES = {"test_protocol_http_seek.py": 2, "test_protocols_dash.py": 4,
             "test_streaming_misbehaviour.py": 8}

CASES = [case for f in JAX_FILES for case in collect(f, globals())]


@pytest.mark.parametrize("filename", sorted(JAX_FILES))
def test_every_case_of_the_file_is_collected(filename):
    assert sum(c[0] == filename for c in CASES) == JAX_FILES[filename]
