"""Multi-object solves (``batched.py``) and the row-sharded depth CG
(``shard_cg.py``, ``shard_kernels.py``, ``sharded.py``)."""
