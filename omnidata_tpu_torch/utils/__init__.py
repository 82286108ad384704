from .profiler import Profiler, DeviceTrace
from .video import make_video
