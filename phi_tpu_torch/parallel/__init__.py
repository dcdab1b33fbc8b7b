"""The mesh: the sharded DP and read sketch of one process over a list of
torch devices (sharded.py), and the multi-process read-shard planning and
spectrum merge (dist.py)."""
