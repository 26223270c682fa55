from knnsvc_torch.parallel.mesh import Mesh, make_mesh
from knnsvc_torch.parallel.sharded_knn import shard_pool, sharded_knn_topk

__all__ = ["Mesh", "make_mesh", "shard_pool", "sharded_knn_topk"]
