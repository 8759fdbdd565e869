"""Training over several processes: the process world and its mesh
(mesh.py), the rule that shards optimizer state (sharding.py) and the
reductions over the global batch (collectives.py)."""
