"""The JAX package's tests of the net layer, run against the port's copies
(``ohpipeline_tpu_torch.host.net``).

The files are read and their cases collected by ``test_torch_av.py``'s
loader: ``ohpipeline_tpu.net.X`` resolves to ``ohpipeline_tpu_torch.host.net.X``,
the device classes the cases build (``MediaPlayer``, ``PipelineManager``,
``AnimatorBatch``, ``AnimatorSongcastSender``) come on the CPU, and each
case is its own test (``Test_<file>__<class>`` / ``test_<file>__<function>``).
Every socket the cases open is ephemeral (port 0, unicast), so they may run
beside the JAX package's own runs of the same files.
"""

from test_torch_av import collect

#: The JAX test files of the net layer.
JAX_FILES = (
    "test_net.py", "test_mdns.py", "test_ntp.py", "test_raop.py",
    "test_shell.py", "test_songcast_services.py", "test_upnp.py",
    "test_upnp_openhome.py", "test_webapp.py", "test_provider_depth.py")

CASES = [case for f in JAX_FILES for case in collect(f, globals())]


def test_every_case_of_the_net_layer_is_collected():
    """74 case functions (one of them skips without the ALAC oracle, as
    it does in the JAX package)."""
    assert len(CASES) >= 74
