"""Point-cloud ops: the reference CUDA extension's API as padded JAX ops.

How each op runs is chosen in one place, ``pointops.kernel_route()``:

| op | GPU | CPU (tests) |
|----|-----|-------------|
| FPS | Pallas kernel, Triton route (`fps_triton.py`): one program per cloud, all rounds in registers | XLA loop (`pointops._farthest_point_sampling_padded_xla`) |
| kNN | plain XLA (`pointops.knn_query_padded`) | the same |
| grouping, ball query, interpolation, token builder | plain XLA | the same |

Any other platform raises. Times on the card are in PERF.md.
"""

from pointcloudmatters_tpu.ops.pointops import (
    aggregation,
    aggregation_padded,
    attention_fusion_step,
    attention_relation_step,
    ball_query,
    ball_query_and_group,
    ball_query_padded,
    batch2offset,
    farthest_point_sampling,
    farthest_point_sampling_padded,
    grouping,
    grouping2,
    grouping_padded,
    interpolation,
    interpolation2,
    interpolation_padded,
    knn_query,
    knn_query_and_group,
    knn_query_and_group_padded,
    knn_query_padded,
    offset2batch,
    offset2bincount,
    random_ball_query,
    random_ball_query_padded,
    subtraction,
    subtraction_padded,
    query_and_group,
)
