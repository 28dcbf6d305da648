from .evaluation import (MeshRenderer, ate_rmse,  # noqa: F401
                         load_mesh, umeyama_alignment)
from .rgbd import (all_pairs_distance_matrix,  # noqa: F401
                   associate_frames, build_frame_graph,
                   compute_distance_matrix_flow, graph_to_edge_list,
                   interpolate_poses)
