"""Network planes: Songcast multiroom (OHM/OHU), SCD point-to-point,
ODP JSON control (reference Av/Songcast, Av/Scd, Net/Odp)."""

from .odp import OdpClient, OdpDevice, OdpServer, OdpService
from .providers import make_device
from .scd import ScdFormat, ScdReceiver, ScdSender
from .songcast import OhmAudio, OhmReceiver, OhmSender

__all__ = ["OdpClient", "OdpDevice", "OdpServer", "OdpService",
           "make_device", "ScdFormat", "ScdReceiver", "ScdSender",
           "OhmAudio", "OhmReceiver", "OhmSender"]
