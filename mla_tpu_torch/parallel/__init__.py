"""Training and serving over several processes: the process world and its
mesh (mesh.py), the rules that shard optimizer state and, over a
tensor-parallel group, the decoder (sharding.py), the reductions over the
global batch (collectives.py) and the tensor-parallel operations
(tensor.py)."""
