from . import device, geodesy, pointcloud, se3, se3np, voxel
from .device import resolve_device
from .pointcloud import PAD_COORD, PointCloud, make_cloud
