from knnsvc_torch.parallel.mesh import Mesh, make_mesh, data_sharding, replicated
from knnsvc_torch.parallel.sharded_knn import sharded_knn_topk, shard_pool

__all__ = ["Mesh", "make_mesh", "data_sharding", "replicated", "sharded_knn_topk", "shard_pool"]
