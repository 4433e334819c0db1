from codemix_dense_retrieval_torch.parallel.mesh import (
    Mesh,
    gather_to,
    make_mesh,
    reduce_sum_to,
    shard_axis_size,
)
from codemix_dense_retrieval_torch.parallel.sharded_search import (
    shard_rows,
    sharded_topk_ip,
)

__all__ = [
    "Mesh", "gather_to", "make_mesh", "reduce_sum_to", "shard_axis_size", "shard_rows",
    "sharded_topk_ip",
]
