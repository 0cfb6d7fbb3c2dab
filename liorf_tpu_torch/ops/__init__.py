from . import deskew, icp, knn, knn_cuda, plane_fit, scan_match, scancontext, segment_sum, voxel_filter, voxel_reduce
