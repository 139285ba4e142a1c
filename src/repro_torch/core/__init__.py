# Highways-on-Disk (HoD): a rank-ordered shortcut index whose SSD/SSSP
# queries are linear scans, run here as batched level sweeps on PyTorch
# (see DESIGN.md).
from .baselines import VCIndex, em_bfs, em_dijkstra  # noqa: F401
from .build import BuildConfig, BuildResult, BuildStats, build_hod  # noqa: F401
from .build_fast import build_hod_fast  # noqa: F401
from .closeness import (ClosenessResult, TopKCloseness,  # noqa: F401
                        estimate_closeness, topk_closeness)
from .graph import (Digraph, from_edges, gnm_random_digraph,  # noqa: F401
                    grid_road_graph, largest_weakly_connected_component,
                    power_law_digraph, symmetrize)
from .index import (HoDIndex, SweepPlan, build_core_plan,  # noqa: F401
                    build_sweep_plan, index_from_numpy, pack_index)
from .query import QueryEngine, dijkstra_reference  # noqa: F401
