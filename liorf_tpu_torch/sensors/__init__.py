from . import synthetic, types
from .types import GpsFix, ImuSample, LidarScan
