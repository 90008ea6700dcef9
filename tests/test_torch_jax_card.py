"""The JAX package's end-to-end render-path tests, run against the port on
the card: ``test_pipeline_e2e.py`` and ``test_codec_matrix_e2e.py`` as
``test_torch_jax_pipeline.py`` collects them, with ``cuda`` in place of the
CPU as the device of every ``PipelineManager`` and animator (so
``CodecFlac`` launches ``lpc``, ``CodecMp3`` ``mp3_window`` and HE-AAC
``sbr_env``), on the same inputs and with the same assertions.  Every case
is marked ``gpu`` and skips without a card; on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_jax_*.py
"""

import pytest
import torch

from test_torch_av import collect

#: The JAX test files, with the number of case functions collected from each.
JAX_FILES = {"test_pipeline_e2e.py": 6, "test_codec_matrix_e2e.py": 7}

CASES = [case for f in JAX_FILES
         for case in collect(f, globals(), device="cuda",
                             marks=[pytest.mark.gpu])]


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("gpu") \
            and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("filename", sorted(JAX_FILES))
def test_every_case_of_the_file_is_collected(filename):
    assert sum(c[0] == filename for c in CASES) == JAX_FILES[filename]
