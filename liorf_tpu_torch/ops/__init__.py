# A process's first call of a torch.library custom op (the ops' vmap rules
# and the calls that go through them) imports torch._dynamo, seconds on a GPU
# host: imported with the ops that register them, so no frame pays it.
import torch._dynamo  # noqa: F401

from . import deskew, icp, knn, knn_cuda, plane_fit, scan_match, scancontext, segment_sum, voxel_filter, voxel_reduce
