from .jiffies import Jiffies
from .streaminfo import PcmStreamInfo, SampleFormat
from . import events

__all__ = ["Jiffies", "PcmStreamInfo", "SampleFormat", "events"]
