"""The JAX package's render-path tests, run against the port.

The files are read and their cases collected by ``test_torch_av.py``'s
loader (``ohpipeline_tpu.pipeline`` and ``pipeline.manager`` resolve to the
port's public ``pipeline``, whose ``PipelineManager`` decodes on the CPU
here; the rest to the host copies), each case its own test
(``Test_<file>__<class>`` / ``test_<file>__<function>``).
``test_codec_matrix_e2e.py`` imports its sibling ``test_pipeline_e2e``,
which the loader runs the same way.
"""

import pytest

from test_torch_av import collect

#: The JAX test files, with the number of case functions collected from each.
JAX_FILES = {
    "test_pipeline_e2e.py": 6, "test_pipeline_semantics.py": 16,
    "test_pipeline_extras.py": 17, "test_pipeline_monkey.py": 0,
    "test_codec_controller_hostile.py": 3, "test_protocol_rtsp.py": 6,
    "test_codec_matrix_e2e.py": 7, "test_core.py": 17,
    "test_pipeline_elements.py": 19}

#: Cases left out, each with its reason.
LEAVE_OUT = {
    # A defect of the JAX package's pipeline/control.py, which the port
    # copies byte for byte: Seeker.seek accepts a seek while the up-ramp
    # after a failed seek (or after the seek's flush) has yet to run, and
    # starts its down-ramp at full level though the level sits at 0, so the
    # RampValidator after the seeker trips ("ramp discontinuity 0 ->
    # 16384") whenever the random commands land two seeks that close.  Both
    # seeds do at times, in the JAX run too;
    # test_the_seeker_restarts_its_down_ramp_at_full_level pins the
    # sequence on both packages.
    "test_pipeline_monkey.py": {"test_monkey_command_sequences"},
}

CASES = [case for f in JAX_FILES
         for case in collect(f, globals(), leave_out=LEAVE_OUT.get(f, ()))]


@pytest.mark.parametrize("filename", sorted(JAX_FILES))
def test_every_case_of_the_file_is_collected(filename):
    assert sum(c[0] == filename for c in CASES) == JAX_FILES[filename]


def _seek_twice_ramps(pkg: str) -> list:
    """The ramps after a Seeker (``pkg``'s) when a seek fails and a second
    seek lands before the up-ramp that follows the failure has run."""
    import importlib

    import numpy as np

    ev = importlib.import_module(f"{pkg}.core.events")
    control = importlib.import_module(f"{pkg}.pipeline.control")
    info = importlib.import_module(f"{pkg}.core.streaminfo").PcmStreamInfo(
        sample_rate=44100, bit_depth=16, num_channels=2)

    class Tone:
        def pull(self):
            return ev.AudioPcmEvent(np.ones((2, 441), np.int32), info)

    seeker = control.Seeker(Tone(), lambda stream, sample:
                            ev.FlushEvent.ID_INVALID)
    ramps = []
    for _ in range(2):
        assert seeker.seek(1, 0)
        while seeker._ramp.active:
            r = seeker.pull().ramp
            ramps.append((r.start, r.end))
    return ramps


def test_the_seeker_restarts_its_down_ramp_at_full_level():
    """The JAX defect that keeps test_pipeline_monkey.py out: the second
    seek's down-ramp starts at 16384 where the first one ended at 0, in
    the port's byte copy of pipeline/control.py as in the JAX package."""
    port = _seek_twice_ramps("ohpipeline_tpu_torch.host")
    assert port == _seek_twice_ramps("ohpipeline_tpu")
    assert (0, 16384) in [(a[1], b[0]) for a, b in zip(port, port[1:])]
