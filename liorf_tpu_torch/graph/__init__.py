from . import marginal, pose_graph
